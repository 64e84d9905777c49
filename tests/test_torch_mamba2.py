"""The port's mamba2 path against the JAX package, on the CPU: the SSD
scan's plain versions and its autograd Function, the Mamba-2 block, and
the mamba2-2.7b-smoke model's loss, gradients, prefill, decode, greedy
serving and trainer steps, on bridged weights.

Tolerances: the scan at 1e-4 in fp32 and 0.08 in bf16, those of
``tests/test_kernels.py::test_ssd_scan_matches_ref``; gradients at 1e-4
of the largest |gradient|; the fp32 smoke model at 1e-4 of each output's
or leaf's largest magnitude (the two packages differ only in the order
sums are taken), as ``tests/test_torch_models.py`` and
``tests/test_torch_train.py`` hold gemma-2b-smoke.

The one deliberate divergence: the JAX ``ssd_chunked`` exponentiates
``cum[l] - cum[s]`` over the whole chunk and masks afterwards, so at a
chunk of 256 its gradient is NaN; the port masks first.  The overflow
test records both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_arch as jax_get_arch
from repro.elastic import ElasticTrainer as JaxElasticTrainer
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_pallas
from repro.models import build_model
from repro.models import mamba2 as jax_mamba2
from repro.optim import AdamW as JaxAdamW
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_flat, torch_name
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.elastic import ElasticTrainer
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import Model, n_params
from repro_torch.models import mamba2 as pt_mamba2
from repro_torch.optim import AdamW
from repro_torch.serving import ServeEngine
from test_torch_kernels import plain_launches  # noqa: F401  (fixture)

ARCH = "mamba2-2.7b-smoke"
TOL = 1e-4
SSD_TOL = {"float32": 1e-4, "bfloat16": 0.08}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, tol=TOL, floor=1e-30):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), floor)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


def _abs_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float().detach(), np.float32) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# The SSD scan's plain versions
# ---------------------------------------------------------------------------


def _ssd_host(shape, seed=1, dt_range=(0.01, 0.51), a=None):
    """x, dt, a, B, C as fp32 numpy, the inputs of tests/test_kernels.py."""
    b, s, h, p, n = shape
    rng = np.random.RandomState(seed)
    lo, hi = dt_range
    x = (rng.randn(b, s, h, p) * 0.5).astype(np.float32)
    dt = (rng.rand(b, s, h) * (hi - lo) + lo).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3) if a is None
         else np.full(h, a)).astype(np.float32)
    bm = (rng.randn(b, s, h, n) * 0.4).astype(np.float32)
    cm = (rng.randn(b, s, h, n) * 0.4).astype(np.float32)
    return x, dt, a, bm, cm


def _both(host, dtype):
    """(jax inputs, torch inputs); x, B, C in ``dtype``, dt and a fp32."""
    jd, td = DTYPES[dtype]
    x, dt, a, bm, cm = host
    jx = [jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a),
          jnp.asarray(bm, jd), jnp.asarray(cm, jd)]
    tx = [torch.from_numpy(x).to(td), torch.from_numpy(dt),
          torch.from_numpy(a), torch.from_numpy(bm).to(td),
          torch.from_numpy(cm).to(td)]
    return jx, tx


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 8), (2, 128, 3, 32, 16)])
@pytest.mark.parametrize("chunk", [32, 64])
def test_plain_ssd_matches_jax_chunked_naive_and_pallas(dtype, shape, chunk):
    jx, tx = _both(_ssd_host(shape), dtype)
    y, final = ops.ssd_scan(*tx, chunk=chunk)
    assert y.dtype == tx[0].dtype and final.dtype == torch.float32
    tol = SSD_TOL[dtype]
    want_y, want_f = jax_mamba2.ssd_chunked(*jx, chunk=chunk)
    assert _abs_err(y, want_y) < tol and _abs_err(final, want_f) < tol
    want_y, want_f = jax_ssd_ref(*jx)
    assert _abs_err(y, want_y) < tol and _abs_err(final, want_f) < tol
    want_y = jax_ssd_pallas(*jx, chunk=chunk, interpret=True)
    assert _abs_err(y, want_y) < tol


def test_plain_ssd_takes_a_ragged_s():
    host = _ssd_host((2, 100, 3, 8, 4), seed=2)
    tx = [torch.from_numpy(t) for t in host]
    for chunk in (16, 32, 100):
        y, final = ops.ssd_scan(*tx, chunk=chunk)
        want_y, want_f = jax_mamba2.ssd_chunked(*map(jnp.asarray, host),
                                                chunk=chunk)
        assert _abs_err(y, want_y) < 1e-4 and _abs_err(final, want_f) < 1e-4


def test_ssd_scan_refuses_what_the_kernel_does_not_take():
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in
                        _ssd_host((1, 8, 2, 4, 4)))
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=512)
    with pytest.raises(ValueError, match="fp32"):
        ops.ssd_scan(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(ValueError, match="dtypes"):
        ops.ssd_scan(x, dt, a, bm.bfloat16(), cm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a,
                     bm, cm)
    big = torch.zeros(1, 8, 2, 65)
    with pytest.raises(ValueError, match="P <= 64"):
        ops.ssd_scan(big, dt, a, bm, cm)
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(*(t.to("meta") for t in (x, dt, a, bm, cm)))


# ---------------------------------------------------------------------------
# The autograd Function (the card's path), with the launches swapped for
# the plain formulas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,chunk", [
    ((1, 64, 2, 16, 8), 32),
    ((2, 128, 3, 32, 16), 64),
    ((2, 100, 3, 8, 4), 32),          # ragged S
])
def test_ssd_function_matches_jax_vjp(plain_launches, shape, chunk):
    host = _ssd_host(shape, seed=4)
    rng = np.random.RandomState(5)
    b, s, h, p, n = shape
    dy = rng.randn(b, s, h, p).astype(np.float32)
    dfinal = rng.randn(b, h, p, n).astype(np.float32)
    leaves = [torch.from_numpy(t).requires_grad_() for t in host]
    y, final = ops._SsdScan.apply(*leaves, chunk)
    torch.autograd.backward([y, final],
                            [torch.from_numpy(dy), torch.from_numpy(dfinal)])
    assert ops.LAUNCHES["ssd_scan"] == ops.LAUNCHES["ssd_scan_bwd"] == 1
    _, vjp = jax.vjp(lambda *t: jax_mamba2.ssd_chunked(*t, chunk=chunk),
                     *map(jnp.asarray, host))
    for leaf, want in zip(leaves, vjp((jnp.asarray(dy), jnp.asarray(dfinal)))):
        _close(leaf.grad.numpy(), want)


def test_ssd_function_takes_a_cotangent_for_either_output(plain_launches):
    host = _ssd_host((1, 64, 2, 8, 4), seed=6)
    for pick in (0, 1):
        leaves = [torch.from_numpy(t).requires_grad_() for t in host]
        ops._SsdScan.apply(*leaves, 32)[pick].sum().backward()
        again = [torch.from_numpy(t).requires_grad_() for t in host]
        ref.ssd_scan_ref(*again)[pick].sum().backward()
        for got, want in zip(leaves, again):
            # the final state does not depend on C: no gradient there
            w = torch.zeros_like(want) if want.grad is None else want.grad
            _close(got.grad.numpy(), w.numpy())


def test_overflow_jax_gradient_is_nan_and_the_port_matches_the_naive_scan(
        plain_launches):
    """S 256, chunk 256, dt in [0.6, 1.1], a = -1: cum falls by ~220
    across the chunk, so exp(cum[l] - cum[s]) above the diagonal passes
    fp32's range.  JAX's masked-after-exp gradient is not finite (the
    divergence, ROADMAP.md Queue 3); the port's, through both the plain
    path and the Function, equals the naive recurrence's."""
    host = _ssd_host((1, 256, 2, 4, 4), seed=7, dt_range=(0.6, 1.1), a=-1.0)
    jin = list(map(jnp.asarray, host))
    jax_grads = jax.grad(
        lambda *t: jax_mamba2.ssd_chunked(*t, chunk=256)[0].sum(),
        argnums=(0, 1, 2, 3, 4))(*jin)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax_grads)
    want = jax.grad(lambda *t: jax_ssd_ref(*t)[0].sum(),
                    argnums=(0, 1, 2, 3, 4))(*jin)
    for route in ("plain", "function"):
        leaves = [torch.from_numpy(t).requires_grad_() for t in host]
        if route == "plain":
            y, _ = ops.ssd_scan(*leaves, chunk=256)
        else:
            y, _ = ops._SsdScan.apply(*leaves, 256)
        y.sum().backward()
        for leaf, w in zip(leaves, want):
            assert torch.isfinite(leaf.grad).all()
            _close(leaf.grad.numpy(), w)


# ---------------------------------------------------------------------------
# The Mamba-2 block
# ---------------------------------------------------------------------------


def test_conv_and_step_primitives_match_jax():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 9, 24).astype(np.float32)
    k = (rng.randn(4, 24) * 0.1).astype(np.float32)
    _close(pt_mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(k)),
           jax_mamba2._causal_conv(jnp.asarray(x), jnp.asarray(k)))
    win = rng.randn(2, 3, 24).astype(np.float32)
    w_got, y_got = pt_mamba2._conv_step(torch.from_numpy(win),
                                        torch.from_numpy(x[:, 0]),
                                        torch.from_numpy(k))
    w_want, y_want = jax_mamba2._conv_step(jnp.asarray(win),
                                           jnp.asarray(x[:, 0]),
                                           jnp.asarray(k))
    _close(w_got, w_want)
    _close(y_got, y_want)
    state = rng.randn(2, 3, 8, 4).astype(np.float32)
    xs, dt = rng.randn(2, 3, 8).astype(np.float32), rng.rand(2, 3)
    a = -np.exp(rng.randn(3)).astype(np.float32)
    bm, cm = rng.randn(2, 3, 4), rng.randn(2, 3, 4)
    args = [state, xs, dt.astype(np.float32), a, bm.astype(np.float32),
            cm.astype(np.float32)]
    got = pt_mamba2.ssd_step(*map(torch.from_numpy, args))
    want = jax_mamba2.ssd_step(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) on the same weights."""
    jm = build_model(jax_get_arch(ARCH), remat=False)
    params = jm.init(jax.random.key(0))
    tm = Model(get_arch(ARCH), device="cpu", remat=False)
    tm.load_state_dict(params_from_flat(_flat(params)))
    return jm, params, tm


def _tokens(b, s, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def test_config_copy_and_n_params_match_jax():
    for name in ("mamba2-2.7b", ARCH):
        assert (dataclasses.asdict(get_arch(name))
                == dataclasses.asdict(jax_get_arch(name)))
    cfg = get_arch(ARCH)
    assert (cfg.d_model, cfg.n_layers, cfg.vocab_size) == (128, 2, 512)
    assert (cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.chunk_size) == (16, 16, 32)
    assert pt_mamba2.mamba_dims(cfg) == (256, 16, 16)
    want = build_model(jax_get_arch("mamba2-2.7b")).n_params()
    assert n_params(get_arch("mamba2-2.7b")) == want == 2_702_235_136


def test_state_dict_names_shapes_and_types_are_the_jax_tree(pair):
    _, params, tm = pair
    flat = _flat(params)
    assert {torch_name(k) for k in flat} == set(tm.state_dict())
    bf16 = Model(get_arch(ARCH), device="cpu", dtype=torch.bfloat16)
    fp32_leaves = {"dt_bias", "a_log", "d_skip", "norm"}
    for name, t in bf16.state_dict().items():
        assert tuple(t.shape) == flat[
            "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                    for p in name.split("."))].shape
        leaf = name.split(".")[-1]
        want = (torch.float32 if leaf in fp32_leaves or name.endswith("_norm")
                else torch.bfloat16)
        assert t.dtype == want, name
    assert bool((bf16.blocks[0].mixer.d_skip == 1).all())


def test_forward_logits_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 40)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks)})
    _close(got.detach(), want, floor=1.0)


def test_loss_and_every_gradient_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 48, seed=1)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    want_loss, want_grads = jax.value_and_grad(jm.loss)(params, batch)
    want_grads = {torch_name(k): v for k, v in _flat(want_grads).items()}
    tm.zero_grad(set_to_none=True)
    t = torch.from_numpy(toks).long()
    ops.reset_launches()
    loss = tm.loss({"tokens": t, "labels": t})
    loss.backward()
    assert not any(ops.LAUNCHES.values())      # the CPU path: plain versions
    _close(loss.detach().numpy(), float(want_loss))
    named = dict(tm.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        _close(p.grad.numpy(), want_grads[name])
    tm.zero_grad(set_to_none=True)


def test_loss_through_the_card_autograd_path_matches(pair, plain_launches,
                                                     monkeypatch):
    """The model's card path (every wrapper an autograd Function) on CPU
    tensors, with the launches swapped for the plain formulas: the same
    loss and gradients, and the launches of one step."""
    _, _, tm = pair
    t = torch.from_numpy(_tokens(2, 40, seed=2)).long()
    batch = {"tokens": t, "labels": t}
    want = tm.loss(batch)
    want.backward()
    want_grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    monkeypatch.setattr(ops, "_on_cuda", lambda x, what: True)
    ops.reset_launches()
    got = tm.loss(batch)
    got.backward()
    n = tm.cfg.n_layers
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0) | {
        "rms_norm": 2 * n + 1, "rms_norm_bwd": 2 * n + 1,
        "ssd_scan": n, "ssd_scan_bwd": n, "ce_loss": 1, "ce_loss_bwd": 1}
    _close(got.detach().numpy(), float(want.detach()))
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy())
    tm.zero_grad(set_to_none=True)


def _jax_prefill(jm, params, toks, cache_len):
    return jax.jit(lambda p, b: jm.prefill(p, b, cache_len=cache_len))(
        params, {"tokens": jnp.asarray(toks)})


def test_prefill_and_decode_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 48, seed=3)
    s0, cache_len = 40, 56
    want_logits, jc = _jax_prefill(jm, params, toks[:, :s0], cache_len)
    with torch.inference_mode():
        got_logits, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :s0])},
                                    cache_len=cache_len)
    _close(got_logits, want_logits, floor=1.0)
    for name in ("conv_x", "conv_b", "conv_c", "state"):
        want = np.asarray(jc[0]["mamba"][name].astype(jnp.float32))
        got = tc[0]["mamba"][name]
        assert got.dtype == (torch.float32 if name == "state"
                             else torch.bfloat16)
        # conv windows: the same fp32 values rounded to bf16 (one ulp)
        _close(got.float(), want, TOL if name == "state" else 2 ** -7)
    jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    tc = tuple({"mamba": {n: t.float() for n, t in c["mamba"].items()}}
               for c in tc)
    jdec = jax.jit(jm.decode_step)
    for pos in range(s0, s0 + 8):            # teacher-forced
        tok = toks[:, pos:pos + 1]
        want, jc = jdec(params, jc, jnp.asarray(tok), jnp.int32(pos))
        with torch.inference_mode():
            got, tc = tm.decode_step(tc, torch.from_numpy(tok), pos)
        _close(got, want, floor=1.0)
    _close(tc[0]["mamba"]["state"], np.asarray(jc[0]["mamba"]["state"]))


def test_serve_engine_greedy_tokens_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 16, seed=5)
    want = JaxServeEngine(jm, params, max_len=32).generate(
        {"tokens": jnp.asarray(toks)}, 8)
    ops.reset_launches()
    got = ServeEngine(tm, max_len=32, device="cpu").generate(
        {"tokens": toks}, 8)
    assert got.tokens.shape == (2, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_bf16_model_serves_with_an_fp32_cache():
    """The JAX engine serves fp32 models only (a bf16 model's decode
    promotes the residual to fp32 against the fp32 cache); the port casts
    the conv output back to the model's type and serves bf16."""
    tm = Model(get_arch(ARCH), device="cpu", dtype=torch.bfloat16,
               trainable=False)
    res = ServeEngine(tm, max_len=32, device="cpu").generate(
        {"tokens": _tokens(2, 12, seed=6)}, 6)
    assert res.tokens.shape == (2, 6)
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_three_trainer_steps_match_the_jax_trainer(tmp_path):
    model = build_model(jax_get_arch(ARCH), remat=False)
    jtr = JaxElasticTrainer(model, per_node_batch=2, seed=4,
                            optimizer=JaxAdamW(lr=3e-3), warmup_steps=2)
    jtr.pipeline.cfg.seq_len = 48
    jtr.rescale(1)
    jtr.train_step()                      # non-zero moments to carry over
    jtr.save_checkpoint(JaxCheckpointManager(str(tmp_path)))

    tm = Model(get_arch(ARCH), device="cpu", remat=False,
               generator=torch.Generator().manual_seed(4))
    tr = ElasticTrainer(tm, per_node_batch=2, seed=4,
                        optimizer=AdamW(lr=3e-3), warmup_steps=2,
                        device="cpu")
    tr.seq_len(48)
    assert tr.restore_checkpoint(CheckpointManager(str(tmp_path))) == 1
    tr.pipeline.restore(jtr.pipeline.state())
    tr.rescale(1)
    for _ in range(3):
        want, got = jtr.train_step(), tr.train_step()
        assert got.step == want.step and got.samples == want.samples
        assert abs(got.loss - want.loss) <= 1e-4 * abs(want.loss)
    flat = {torch_name(k): v for k, v in _flat(jtr.params).items()}
    assert set(flat) == set(tr.params)
    for name, p in tr.params.items():
        _close(p.detach().numpy(), flat[name])


def test_train_cli_runs_mamba2_elastic_on_cpu(capsys):
    ops.reset_launches()
    tr = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                     "--per-node-batch", "2", "--seq", "40", "--elastic"])
    assert tr.step_count == 2
    assert not any(ops.LAUNCHES.values())
    out = capsys.readouterr().out
    assert "arch=mamba2-2.7b-smoke" in out and "elastic run: 2 steps" in out
