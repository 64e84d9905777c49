"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX oracles ``repro.kernels.ref`` over the sweep of
``tests/test_kernels.py``, and against the Pallas kernels in interpret
mode on a few cases.

Inputs are made with numpy and cast to bf16 by each framework, which both
round to nearest even, so the two sides see the same values.  Tolerances
are those of ``tests/test_kernels.py::_tol``: 2e-5 in fp32, 2e-2 in bf16.

The backward formulas (``ref.*_bwd_ref``, what the backward kernels
compute) are held in fp32 against autograd of the port's plain forward
and against ``jax.vjp`` of the JAX oracle, at 1e-4 of the largest
gradient; and the ``torch.autograd.Function``s that run the kernels on
the card are driven here with the kernel launches swapped for those
formulas, so their wiring is tested without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.ce_loss import ce_loss as jax_ce_pallas
from repro.kernels.ref import ce_loss_ref as jax_ce_ref
from repro.kernels.ref import flash_attention_ref as jax_fa_ref
from repro.kernels.ref import rms_norm_ref as jax_rms_ref
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    return float(np.max(np.abs(got.float().numpy() - want)))


def _qkv(shape, seed=0, sk=None):
    b, h, kv, s, d = shape
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return ((rng.randn(b, h, s, d) * 0.3).astype(np.float32),
            (rng.randn(b, kv, sk, d) * 0.3).astype(np.float32),
            (rng.randn(b, kv, sk, d) * 0.3).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [
    (1, 2, 1, 128, 64),    # MQA
    (2, 4, 2, 160, 32),    # GQA, ragged seq
    (1, 8, 8, 96, 128),    # MHA
])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 50.0), (False, 0, 0.0),
])
def test_flash_attention_matches_jax_ref(dtype, shape, causal, window, cap):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in _qkv(shape))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              logit_cap=cap)
    assert got.dtype == tq.dtype
    want = jax_fa_ref(jq, jk, jv, causal=causal, window=window, logit_cap=cap)
    assert _err(got, want) < _tol(dtype)


def test_flash_attention_ragged_sq_sk_matches_jax_ref():
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(a, "float32") for a in _qkv((1, 2, 1, 130, 32), seed=4, sk=190))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = jax_fa_ref(jq, jk, jv, causal=False)
    assert _err(got, want) < 2e-5


@pytest.mark.parametrize("dtype,shape,causal,window,cap", [
    ("float32", (1, 2, 1, 128, 64), True, 0, 0.0),
    ("float32", (2, 4, 2, 160, 32), True, 64, 0.0),
    ("bfloat16", (1, 8, 8, 96, 128), True, 0, 50.0),
])
def test_flash_attention_matches_pallas_interpret(dtype, shape, causal,
                                                  window, cap):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in _qkv(shape))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              logit_cap=cap)
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                   logit_cap=cap, block_q=64, block_k=64,
                                   interpret=True)
    assert _err(got, want) < _tol(dtype)


def _x_scale(shape, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(shape[-1]) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(3, 50, 96), (1, 7, 256), (2, 256, 128)])
def test_rms_norm_matches_jax_ref(dtype, shape):
    x, s = _x_scale(shape)
    jx, tx = _pair(x, dtype)
    got = ops.rms_norm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype
    assert _err(got, jax_rms_ref(jx, jnp.asarray(s))) < _tol(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_norm_matches_pallas_interpret(dtype):
    x, s = _x_scale((3, 50, 96))
    jx, tx = _pair(x, dtype)
    want = jax_ops.rms_norm(jx, jnp.asarray(s), block_rows=32, interpret=True)
    got = ops.rms_norm(tx, torch.from_numpy(s))
    assert _err(got, want) < _tol(dtype)


# ---------------------------------------------------------------------------
# ce_loss (forward)
# ---------------------------------------------------------------------------


def _ce_inputs(t=77, v=1000, d=64, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, d).astype(np.float32),
            (rng.randn(v, d) * 0.2).astype(np.float32),
            rng.randint(0, v, (t,)).astype(np.int32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ce_loss_matches_jax_ref(dtype):
    x, w, lbl = _ce_inputs()
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    got = ops.ce_loss(tx, tw, torch.from_numpy(lbl))
    assert got.dtype == torch.float32 and got.shape == (77,)
    assert _err(got, jax_ce_ref(jx, jw, jnp.asarray(lbl))) < _tol(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ce_loss_matches_pallas_interpret(dtype):
    """V = 1000 is not a multiple of block_v: the Pallas kernel pads the
    vocab with NEG_INF logits, the plain version has no padding."""
    x, w, lbl = _ce_inputs()
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    want = jax_ce_pallas(jx, jw, jnp.asarray(lbl), block_rows=32,
                         block_v=256, interpret=True)
    got = ops.ce_loss(tx, tw, torch.from_numpy(lbl).long())
    assert _err(got, want) < _tol(dtype)


def test_ce_loss_logz_is_the_rows_logsumexp():
    x, w, lbl = _ce_inputs(t=9, v=70, d=16)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    logits = tx @ tw.T
    want = torch.logsumexp(logits, -1)
    assert float((ref.ce_loss_logz_ref(tx, tw) - want).abs().max()) < 1e-5
    gold = logits[torch.arange(9), torch.from_numpy(lbl).long()]
    got = ref.ce_loss_ref(tx, tw, torch.from_numpy(lbl))
    assert float((got - (want - gold)).abs().max()) < 1e-5


def test_ce_loss_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="dtypes"):
        ops.ce_loss(x, torch.zeros(5, 8, dtype=torch.bfloat16),
                    torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="labels"):
        ops.ce_loss(x, torch.zeros(5, 8), torch.zeros(4))
    with pytest.raises(ValueError, match="table"):
        ops.ce_loss(x, torch.zeros(5, 7), torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ce_loss(torch.zeros(8, 4).T, torch.zeros(5, 8),
                    torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="no kernel"):
        ops.ce_loss(x.to("meta"), torch.zeros(5, 8, device="meta"),
                    torch.zeros(4, dtype=torch.long, device="meta"))


# ---------------------------------------------------------------------------
# Backward formulas vs autograd and jax.vjp (fp32)
# ---------------------------------------------------------------------------

GRAD_TOL = 1e-4


def _grad_close(got: torch.Tensor, want, tol=GRAD_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("shape", [(3, 50, 96), (1, 7, 256), (2, 256, 128)])
def test_rms_norm_bwd_matches_autograd_and_jax(shape):
    x, s = _x_scale(shape)
    dy = np.random.RandomState(9).randn(*shape).astype(np.float32)
    tx, ts, tdy = map(torch.from_numpy, (x, s, dy))
    dx, dscale = ref.rms_norm_bwd_ref(tx, ts, tdy)
    ax, as_ = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    ref.rms_norm_ref(ax, as_).backward(tdy)
    _grad_close(dx, ax.grad.numpy())
    _grad_close(dscale, as_.grad.numpy())
    _, vjp = jax.vjp(jax_rms_ref, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(dy))
    _grad_close(dx, jdx)
    _grad_close(dscale, jds)


FLASH_BWD_CASES = [
    # (B, H, KV, Sq, Sk, D), causal, window, cap
    ((1, 2, 1, 128, 128, 64), True, 0, 0.0),       # MQA
    ((2, 4, 2, 160, 160, 32), True, 64, 0.0),      # GQA, window, ragged S
    ((2, 4, 2, 96, 96, 32), True, 0, 50.0),        # GQA, softcap
    ((1, 8, 8, 96, 96, 128), False, 0, 0.0),       # MHA, not causal
    ((1, 2, 1, 130, 190, 32), False, 0, 0.0),      # Sq != Sk
]


@pytest.mark.parametrize("shape,causal,window,cap", FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_autograd_and_jax(shape, causal, window,
                                                      cap):
    b, h, kv, sq, sk, d = shape
    rng = np.random.RandomState(11)
    q, k, v = ((rng.randn(*s) * 0.3).astype(np.float32) for s in
               ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d)))
    do = rng.randn(b, h, sq, d).astype(np.float32)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref.flash_attention_ref(*leaves, **kw).backward(tdo)
    _, vjp = jax.vjp(lambda a, b_, c: jax_fa_ref(a, b_, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, leaf, jg in zip(got, leaves, vjp(jnp.asarray(do))):
        _grad_close(g, leaf.grad.numpy())
        _grad_close(g, jg)


def test_ce_loss_bwd_matches_autograd_and_jax():
    x, w, lbl = _ce_inputs()
    g = np.random.RandomState(12).randn(77).astype(np.float32)
    tx, tw, tl, tg = map(torch.from_numpy, (x, w, lbl, g))
    dx, dw = ref.ce_loss_bwd_ref(tx, tw, tl, ref.ce_loss_logz_ref(tx, tw), tg)
    ax, aw = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    ref.ce_loss_ref(ax, aw, tl).backward(tg)
    _grad_close(dx, ax.grad.numpy())
    _grad_close(dw, aw.grad.numpy())
    _, vjp = jax.vjp(lambda a, b_: jax_ce_ref(a, b_, jnp.asarray(lbl)),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    _grad_close(dx, jdx)
    _grad_close(dw, jdw)


# ---------------------------------------------------------------------------
# The bf16 kernels' decomposition: vocabulary splits (forward) and chunks
# with P rounded to bf16 (backward), in fp32 on the CPU
# ---------------------------------------------------------------------------

CE_SPLIT_CASES = [
    # (T, V, d, splits)
    (77, 1000, 64, 1),
    (77, 1000, 64, 3),       # ragged last tile, uneven splits
    (77, 1000, 64, 4),       # one 256-row tile a split
    (9, 70, 16, 1),          # V smaller than one tile
    (1, 513, 32, 3),         # T = 1; V = 2 tiles + 1
]


@pytest.mark.parametrize("t,v,d,splits", CE_SPLIT_CASES)
def test_ce_loss_partials_and_combine_match_jax_ref(t, v, d, splits):
    x, w, lbl = _ce_inputs(t=t, v=v, d=d)
    tx, tw, tl = map(torch.from_numpy, (x, w, lbl))
    part = ref.ce_loss_partials_ref(tx, tw, tl, splits)
    assert part.shape == (t, splits, 3) and part.dtype == torch.float32
    loss, logz = ref.ce_loss_combine_ref(part)
    want = jax_ce_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(lbl))
    assert _err(loss, want) < 1e-5
    assert float((logz - ref.ce_loss_logz_ref(tx, tw)).abs().max()) < 1e-5
    # the gold logit lies in exactly one split
    assert int(((part[..., 2] != 0).sum(-1) == 1).sum()) == t


def test_ce_loss_partials_match_pallas_interpret():
    x, w, lbl = _ce_inputs()
    tx, tw, tl = map(torch.from_numpy, (x, w, lbl))
    loss, _ = ref.ce_loss_combine_ref(ref.ce_loss_partials_ref(tx, tw, tl, 3))
    want = jax_ce_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(lbl),
                         block_rows=32, block_v=256, interpret=True)
    assert _err(loss, want) < 1e-5


CE_CHUNK_CASES = [
    # (T, V, d, chunk)
    (77, 1000, 64, 256),     # four chunks, the last ragged
    (9, 257, 16, 256),       # V = chunk + 1
    (9, 70, 16, 128),        # V smaller than one tile, one chunk
    (1, 300, 32, 128),       # T = 1
]


@pytest.mark.parametrize("t,v,d,chunk", CE_CHUNK_CASES)
def test_ce_loss_bwd_chunked_matches_jax_grad(t, v, d, chunk):
    """P rounded to bf16 (about 2**-9 of each entry) moves the gradients
    by far less than 2e-2 of the largest; unrounded, the chunked sums are
    the plain formulas' up to fp32 summation order."""
    x, w, lbl = _ce_inputs(t=t, v=v, d=d)
    g = np.random.RandomState(14).randn(t).astype(np.float32)
    tx, tw, tl, tg = map(torch.from_numpy, (x, w, lbl, g))
    logz = ref.ce_loss_logz_ref(tx, tw)
    dx, dw = ref.ce_loss_bwd_chunked_ref(tx, tw, tl, logz, tg, chunk)
    assert dx.dtype == torch.float32 and dw.shape == (v, d)
    _, vjp = jax.vjp(lambda a, b_: jax_ce_ref(a, b_, jnp.asarray(lbl)),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    _grad_close(dx, jdx, 2e-2)
    _grad_close(dw, jdw, 2e-2)
    pdx, pdw = ref.ce_loss_bwd_ref(tx, tw, tl, logz, tg)
    _grad_close(dx, pdx.numpy(), 2e-2)
    _grad_close(dw, pdw.numpy(), 2e-2)


def test_ce_loss_bwd_chunked_rounds_p_like_the_kernel():
    """One chunk or many give the same P, so the same dW bit for bit;
    bf16 inputs give outputs in bf16."""
    x, w, lbl = _ce_inputs(t=20, v=300, d=32)
    tx, tw, tl = map(torch.from_numpy, (x, w, lbl))
    g = torch.full((20,), 0.05)
    logz = ref.ce_loss_logz_ref(tx, tw)
    one = ref.ce_loss_bwd_chunked_ref(tx, tw, tl, logz, g, 384)
    many = ref.ce_loss_bwd_chunked_ref(tx, tw, tl, logz, g, 128)
    assert torch.equal(one[1], many[1])
    assert float((one[0] - many[0]).abs().max()) <= 1e-6
    bx, bw = tx.bfloat16(), tw.bfloat16()
    dx, dw = ref.ce_loss_bwd_chunked_ref(bx, bw, tl, logz, g, 128)
    assert dx.dtype == dw.dtype == torch.bfloat16


@pytest.mark.parametrize("t,v,sms,want", [
    (2040, 256000, 132, 33),     # gemma-2b training: 16 x 33 = 4 waves
    (2040, 50280, 132, 33),      # mamba2-2.7b training
    (77, 1000, 132, 4),          # at least one tile a split
    (100000, 256000, 132, 1),    # many token tiles: no split
])
def test_ce_splits_fill_the_card(t, v, sms, want):
    assert ops.ce_splits(t, v, sms) == want


def test_ce_chunk_bounds_the_p_scratch():
    assert ops.ce_chunk(256000) == ops.CE_CHUNK == 32768
    assert ops.ce_chunk(1000) == 1024 and ops.ce_chunk(128) == 128
    assert -(-256000 // ops.ce_chunk(256000)) == 8
    assert -(-50280 // ops.ce_chunk(50280)) == 2
    assert 2048 * ops.ce_chunk(256000) * 2 <= 128 * 2 ** 20   # bf16 P


def test_ce_loss_refuses_a_bf16_width_tma_cannot_stride():
    x = torch.zeros(4, 12, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.ce_loss(x, torch.zeros(5, 12, dtype=torch.bfloat16),
                    torch.zeros(4, dtype=torch.long))
    # fp32 keeps the CUDA-core kernels, which take any d up to 4096
    assert ops.ce_loss(x.float(), torch.zeros(5, 12),
                       torch.zeros(4, dtype=torch.long)).shape == (4,)


FLASH_ROUNDED_CASES = [
    # (B, H, KV, Sq, Sk, D), causal, window, cap
    ((2, 4, 1, 128, 128, 64), True, 0, 0.0),       # MQA
    ((1, 4, 2, 96, 96, 64), True, 0, 0.0),         # GQA
    ((1, 4, 2, 160, 160, 64), True, 48, 0.0),      # window, ragged S
    ((1, 2, 1, 96, 96, 128), True, 0, 30.0),       # softcap
    ((1, 2, 1, 70, 130, 64), False, 0, 0.0),       # ragged, Sq != Sk
]


def _bf16_values(*arrays):
    """fp32 arrays holding bf16 values, as the bf16 kernels read them."""
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]


@pytest.mark.parametrize("shape,causal,window,cap", FLASH_ROUNDED_CASES)
def test_flash_attention_bwd_rounded_matches_jax_grad(shape, causal, window,
                                                      cap):
    """P and dS rounded to bf16 before their products (the tensor-core
    backward) move the gradients by far less than 2e-2 of the largest;
    jax.vjp of the JAX oracle on the same bf16 values is the reference."""
    b, h, kv, sq, sk, d = shape
    rng = np.random.RandomState(15)
    q, k, v, do = _bf16_values(*(
        (rng.randn(*s) * sc).astype(np.float32) for s, sc in
        (((b, h, sq, d), 0.3), ((b, kv, sk, d), 0.3), ((b, kv, sk, d), 0.3),
         ((b, h, sq, d), 1.0))))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = ref.flash_attention_bwd_rounded_ref(tq, tk, tv, out, lse, tdo,
                                              **kw)
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    _, vjp = jax.vjp(lambda a, b_, c: jax_fa_ref(a, b_, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, pg, jg in zip(got, plain, vjp(jnp.asarray(do))):
        assert g.dtype == torch.float32
        _grad_close(g, jg, 2e-2)
        _grad_close(g, pg.numpy(), 2e-2)
    # bf16 inputs give bf16 gradients
    bq, bk, bv, bo, bdo = (t.bfloat16() for t in (tq, tk, tv, out, tdo))
    assert all(g.dtype == torch.bfloat16 for g in
               ref.flash_attention_bwd_rounded_ref(bq, bk, bv, bo, lse, bdo,
                                                   **kw))


@pytest.mark.parametrize("shape,splits", [
    ((2, 8, 1, 96, 96, 32), 8),      # MQA, one head a split
    ((2, 8, 1, 96, 96, 32), 3),      # uneven splits: heads 2, 3, 3
    ((1, 8, 2, 70, 70, 16), 4),      # GQA, ragged S
    ((1, 4, 4, 64, 64, 16), 1),      # MHA: one split, no partials
])
def test_flash_dkdv_split_partials_sum_to_the_unsplit_formula(shape, splits):
    """The dK/dV kernel's head splits: partials summed in split order are
    the unsplit dK and dV (fp32, 1e-6 of the largest)."""
    b, h, kv, s, _, d = shape
    rng = np.random.RandomState(16)
    tq, tk, tv, tdo = (torch.from_numpy((rng.randn(*x) * 0.3).astype(
        np.float32)) for x in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d),
                               (b, h, s, d)))
    kw = dict(causal=True, window=0, logit_cap=20.0)
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    part = ref.flash_dkdv_partials_ref(tq, tk, tv, out, lse, tdo, splits,
                                       **kw)
    assert part.shape == (2, splits, b, kv, s, d)
    dk, dv = ref.flash_dkdv_combine_ref(part)
    _, want_dk, want_dv = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse,
                                                      tdo, **kw)
    _grad_close(dk, want_dk.numpy(), 1e-6)
    _grad_close(dv, want_dv.numpy(), 1e-6)


def test_flash_route_is_chosen_by_dtype_and_head_dim():
    for d in ops.FLASH_TC_HEAD_DIMS:
        assert ops.flash_route(torch.bfloat16, d) == "tensor_core"
        assert ops.flash_route(torch.float32, d) == "cuda_core"
    for d in (16, 32, 70, 96, 192):
        assert ops.flash_route(torch.bfloat16, d) == "cuda_core"


@pytest.mark.parametrize("b,kv,sk,group,sms,want", [
    (8, 1, 256, 8, 132, 8),      # gemma-2b training: 32 x 8 blocks
    (8, 1, 1024, 8, 132, 2),     # S 1024: 128 x 2
    (1, 2, 160, 2, 132, 2),      # small: one split a head
    (1, 8, 96, 1, 132, 1),       # MHA: nothing to split
    (64, 1, 4096, 8, 132, 1),    # many key tiles: no split
])
def test_flash_dkdv_splits_fill_the_card(b, kv, sk, group, sms, want):
    assert ops.flash_dkdv_splits(b, kv, sk, group, sms) == want


# ---------------------------------------------------------------------------
# The autograd Functions, with the launches swapped for the plain formulas
# ---------------------------------------------------------------------------


@pytest.fixture
def plain_launches(monkeypatch):
    """Route ops' kernel launches to the plain versions (counting them as
    the kernels do), so the card's autograd path runs on CPU tensors."""
    def count(name, value):
        ops.LAUNCHES[name] += 1
        return value

    monkeypatch.setattr(ops, "_rms_norm_fwd", lambda x, s, eps: count(
        "rms_norm", ref.rms_norm_ref(x, s, eps)))
    monkeypatch.setattr(ops, "_rms_norm_bwd", lambda x, s, dy, eps: count(
        "rms_norm_bwd", ref.rms_norm_bwd_ref(x, s, dy, eps)))
    monkeypatch.setattr(
        ops, "_flash_fwd",
        lambda q, k, v, causal, window, cap, scale, want_lse: count(
            "flash_attention", ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, logit_cap=cap,
                scale=scale, return_lse=True)))
    monkeypatch.setattr(
        ops, "_flash_bwd",
        lambda q, k, v, o, lse, do, causal, window, cap, scale: count(
            "flash_attention_bwd", ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window,
                logit_cap=cap, scale=scale)))
    monkeypatch.setattr(ops, "_ce_fwd", lambda x, w, lbl: count(
        "ce_loss", (ref.ce_loss_ref(x, w, lbl), ref.ce_loss_logz_ref(x, w))))
    monkeypatch.setattr(
        ops, "_ce_bwd",
        lambda x, w, lbl, logz, g: count(
            "ce_loss_bwd", ref.ce_loss_bwd_ref(x, w, lbl, logz, g)))
    monkeypatch.setattr(
        ops, "_ssd_fwd",
        lambda x, dt, a, bm, cm, chunk, want_states: count(
            "ssd_scan", (*ref.ssd_chunked(x, dt, a, bm, cm, chunk=chunk),
                         None)))
    monkeypatch.setattr(
        ops, "_ssd_bwd",
        lambda x, dt, a, bm, cm, dy, dfinal, states, chunk: count(
            "ssd_scan_bwd", ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dfinal,
                                                 chunk=chunk)))
    ops.reset_launches()
    yield
    ops.reset_launches()


def test_autograd_functions_wire_the_backward_kernels(plain_launches):
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(2, 5, 32).astype(np.float32))
    s = torch.from_numpy((rng.randn(32) * 0.1).astype(np.float32))
    for fn, args, kw in [
        (ops._RmsNorm.apply, (x, s, 1e-6), {}),
    ]:
        leaves = [a.clone().requires_grad_() for a in args[:2]]
        fn(*leaves, *args[2:]).sum().backward()
        plain = [a.clone().requires_grad_() for a in args[:2]]
        ref.rms_norm_ref(*plain).sum().backward()
        for a, b in zip(leaves, plain):
            _grad_close(a.grad, b.grad.numpy())

    q = torch.from_numpy((rng.randn(1, 4, 40, 16) * 0.3).astype(np.float32))
    k = torch.from_numpy((rng.randn(1, 2, 40, 16) * 0.3).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, k)]
    ops._FlashAttention.apply(*leaves, True, 0, 30.0, 0.25).sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, k)]
    ref.flash_attention_ref(*plain, logit_cap=30.0,
                            scale=0.25).sum().backward()
    for a, b in zip(leaves, plain):
        _grad_close(a.grad, b.grad.numpy())

    xw, w, lbl = _ce_inputs(t=11, v=40, d=16)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xw, w)]
    ops._CeLoss.apply(*leaves, torch.from_numpy(lbl)).mean().backward()
    plain = [torch.from_numpy(a).requires_grad_() for a in (xw, w)]
    ref.ce_loss_ref(*plain, torch.from_numpy(lbl)).mean().backward()
    for a, b in zip(leaves, plain):
        _grad_close(a.grad, b.grad.numpy())
    assert ops.LAUNCHES == {"rms_norm": 1, "rms_norm_bwd": 1,
                            "flash_attention": 1, "flash_attention_bwd": 1,
                            "ce_loss": 1, "ce_loss_bwd": 1,
                            "ssd_scan": 0, "ssd_scan_bwd": 0}
