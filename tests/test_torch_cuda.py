"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small sizes; and the smoke model on the card against its CPU
copy.  Marked ``cuda``; run on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (the check is in the ``card`` fixture,
never at import).  Tolerances: 2e-5 fp32, 2e-2 bf16 for the kernels, as
in ``tests/test_kernels.py`` (the SSD scan: 1e-4 fp32, 0.08 bf16, as
there); the bf16 flash forward also 5e-3 of max(|want|, 1) against the
plain version in fp32 arithmetic, and its LSE 1e-5 (fp32) / 1e-4 (bf16);
gradients 1e-4 (fp32) / 2e-2 (bf16) of the largest |gradient|; 1e-4 of
the largest logit, loss or parameter for the fp32 smoke model (TF32 off), whose card and CPU runs differ only in
summation order.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    ce_loss_bwd_chunked_ref,
    ce_loss_bwd_ref,
    ce_loss_logz_ref,
    ce_loss_ref,
    flash_attention_bwd_ref,
    flash_attention_bwd_rounded_ref,
    flash_attention_ref,
    rms_norm_bwd_ref,
    rms_norm_ref,
    ssd_chunked,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
from repro_torch.models import Model
from repro_torch.serving import ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# gradients: relative to the largest |gradient| (summation order in fp32;
# one bf16 rounding of the output in bf16)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the bf16 flash forward against the plain version in fp32 arithmetic on
# the same inputs, relative to max(|want|, 1) elementwise: half a bf16 ulp
# of the output and P's rounding to bf16 (2.7e-3 at most on an H100); and
# the forward's fp32 LSE against that version's
FLASH_FWD_TOL_FP32_MATH = 5e-3
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(dtype).cuda()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 50, 96), (1, 7, 256), (2, 256, 128),
                                   (5, 2048), (4, 13)])
def test_rms_norm_kernel_matches_plain(card, dtype, shape):
    gen = torch.Generator().manual_seed(3)
    x = _randn(gen, *shape, dtype=dtype)
    s = _randn(gen, shape[-1], scale=0.1)
    before = ops.LAUNCHES["rms_norm"]
    got = ops.rms_norm(x, s)
    assert ops.LAUNCHES["rms_norm"] == before + 1
    want = rms_norm_ref(x, s)
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (1, 2, 1, 128, 128, 64),    # MQA
    (2, 4, 2, 160, 160, 32),    # GQA, ragged seq
    (1, 8, 8, 96, 96, 128),     # MHA
    (1, 8, 1, 70, 70, 256),     # gemma-2b head_dim, ragged
    (1, 2, 1, 130, 190, 32),    # Sq != Sk
    (1, 4, 2, 130, 130, 128),   # GQA, ragged: two q tiles, the last short
    (2, 8, 1, 190, 190, 256),   # MQA at gemma-2b's head_dim, ragged
    (1, 2, 1, 130, 190, 64),    # Sq != Sk on the tensor cores
])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 50.0), (False, 0, 0.0),
])
def test_flash_attention_kernel_matches_plain(card, dtype, shape, causal,
                                              window, cap):
    b, h, kv, sq, sk, d = shape
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, b, h, sq, d, dtype=dtype, scale=0.3)
    k = _randn(gen, b, kv, sk, d, dtype=dtype, scale=0.3)
    v = _randn(gen, b, kv, sk, d, dtype=dtype, scale=0.3)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
    if dtype == torch.bfloat16:     # the plain version rounds its scores
        want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        err = (got.float() - want).abs() / want.abs().clamp(min=1.0)
        assert float(err.max()) <= FLASH_FWD_TOL_FP32_MATH


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.randn(4, 64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rms_norm(x.t(), torch.zeros(4, device=card))
    with pytest.raises(ValueError, match="scale"):
        ops.rms_norm(x, torch.zeros(64, device=card, dtype=torch.bfloat16))
    q = torch.randn(1, 2, 8, 512, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())


def test_smoke_model_on_card_matches_cpu_and_serves_through_kernels(card):
    cfg = get_arch("gemma-2b-smoke")
    gpu = Model(cfg, device=card, trainable=False,
                generator=torch.Generator(device=card).manual_seed(0))
    cpu = copy.deepcopy(gpu).to("cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 24)))
    want, _ = cpu({"tokens": toks})
    got, _ = gpu({"tokens": toks.cuda()})
    scale = max(float(want.abs().max()), 1.0)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale

    ops.reset_launches()
    res = ServeEngine(gpu, max_len=40).generate({"tokens": toks[:, :16]}, 8)
    ref = ServeEngine(cpu, max_len=40, device="cpu").generate(
        {"tokens": toks[:, :16]}, 8)
    n = cfg.n_layers
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0) | {
        "rms_norm": (2 * n + 1) * 9, "flash_attention": n}
    np.testing.assert_array_equal(res.tokens, ref.tokens)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 50, 96), (2, 256, 128), (5, 2048),
                                   (40, 13), (2048, 2048)])
def test_rms_norm_bwd_kernel_matches_plain(card, dtype, shape):
    gen = torch.Generator().manual_seed(5)
    x = _randn(gen, *shape, dtype=dtype).requires_grad_()
    s = _randn(gen, shape[-1], scale=0.1).requires_grad_()
    dy = _randn(gen, *shape, dtype=dtype)
    before = dict(ops.LAUNCHES)
    ops.rms_norm(x, s).backward(dy)
    assert ops.LAUNCHES["rms_norm"] == before["rms_norm"] + 1
    assert ops.LAUNCHES["rms_norm_bwd"] == before["rms_norm_bwd"] + 1
    dx, ds = rms_norm_bwd_ref(x.detach(), s.detach(), dy)
    assert _rel(x.grad, dx) <= GRAD_TOL[dtype]
    assert _rel(s.grad, ds) <= GRAD_TOL[dtype]
    if dtype == torch.float32:          # and autograd of the plain forward
        x2, s2 = x.detach().clone().requires_grad_(), \
            s.detach().clone().requires_grad_()
        rms_norm_ref(x2, s2).backward(dy)
        assert _rel(x.grad, x2.grad) <= 1e-4
        assert _rel(s.grad, s2.grad) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (1, 2, 1, 128, 128, 64),    # MQA
    (2, 4, 2, 160, 160, 32),    # GQA, ragged seq
    (1, 8, 1, 70, 70, 256),     # gemma-2b head_dim, ragged
    (1, 2, 1, 130, 190, 32),    # Sq != Sk
    (1, 4, 2, 130, 130, 128),   # GQA, ragged
    (2, 8, 1, 190, 190, 256),   # MQA at gemma-2b's head_dim: head splits
    (1, 8, 8, 96, 96, 128),     # MHA: one split
    (1, 2, 1, 130, 190, 64),    # Sq != Sk on the tensor cores
])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 50.0), (False, 0, 0.0),
])
def test_flash_attention_bwd_kernel_matches_plain(card, dtype, shape, causal,
                                                  window, cap):
    b, h, kv, sq, sk, d = shape
    gen = torch.Generator().manual_seed(6)
    q = _randn(gen, b, h, sq, d, dtype=dtype, scale=0.3).requires_grad_()
    k = _randn(gen, b, kv, sk, d, dtype=dtype, scale=0.3).requires_grad_()
    v = _randn(gen, b, kv, sk, d, dtype=dtype, scale=0.3).requires_grad_()
    do = _randn(gen, b, h, sq, d, dtype=dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, **kw)
    out.backward(do)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert (ops.LAUNCHES["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    _, lse = ops._flash_fwd(q.detach(), k.detach(), v.detach(), causal,
                            window, cap, d ** -0.5, True)
    # the plain forward in fp32 arithmetic (the bf16 one rounds its
    # scores): the LSE the kernel saved for its backward is held to it,
    # and the plain backward starts from its o and LSE, not the kernel's
    plain_o, plain_lse = flash_attention_ref(
        *(t.detach().float() for t in (q, k, v)), return_lse=True, **kw)
    assert float((lse - plain_lse).abs().max()) <= LSE_TOL[dtype]
    plain = (plain_o.to(dtype), plain_lse)
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   *plain, do, **kw)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert _rel(got, w) <= GRAD_TOL[dtype]
    if ops.flash_route(dtype, d) == "tensor_core":   # P, dS rounded to bf16
        want = flash_attention_bwd_rounded_ref(
            q.detach(), k.detach(), v.detach(), *plain, do, **kw)
        for got, w in zip((q.grad, k.grad, v.grad), want):
            assert _rel(got, w) <= GRAD_TOL[dtype]
    if dtype == torch.float32:          # and autograd of the plain forward
        q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
        flash_attention_ref(q2, k2, v2, **kw).backward(do)
        for got, t in zip((q.grad, k.grad, v.grad), (q2, k2, v2)):
            assert _rel(got, t.grad) <= 1e-4


@pytest.mark.parametrize("shape", [
    (2, 8, 1, 256, 256, 256),   # MQA: head splits and their combine
    (1, 4, 4, 130, 130, 64),    # MHA: one split, bf16 written directly
])
def test_flash_attention_bf16_backward_is_deterministic(card, shape):
    """No atomics: two tensor-core backward runs are bitwise equal."""
    b, h, kv, sq, sk, d = shape
    gen = torch.Generator().manual_seed(9)
    q = _randn(gen, b, h, sq, d, dtype=torch.bfloat16, scale=0.3)
    k = _randn(gen, b, kv, sk, d, dtype=torch.bfloat16, scale=0.3)
    v = _randn(gen, b, kv, sk, d, dtype=torch.bfloat16, scale=0.3)
    do = _randn(gen, b, h, sq, d, dtype=torch.bfloat16)
    args = (True, 0, 0.0, d ** -0.5)
    o, lse = ops._flash_fwd(q, k, v, *args, True)
    first, second = (ops._flash_bwd(q, k, v, o, lse, do, *args)
                     for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


FLASH_KERNELS = {   # by route, as a profile names them
    "tensor_core": ("flash_tc_fwd", "flash_tc_dkdv", "flash_tc_dq"),
    "cuda_core": ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"),
}


def test_gemma_shaped_bf16_attention_runs_the_tensor_core_kernels(card):
    """gemma-2b's attention (MQA, head_dim 256) in bf16 goes through the
    tensor-core kernels, forward and backward; the same call in fp32, and
    bf16 at head_dim 32, through the CUDA-core kernels (the profiler's
    kernel names)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(10)
    for dtype, d, route in ((torch.bfloat16, 256, "tensor_core"),
                            (torch.float32, 256, "cuda_core"),
                            (torch.bfloat16, 32, "cuda_core")):
        assert ops.flash_route(dtype, d) == route
        q = _randn(gen, 2, 8, 256, d, dtype=dtype, scale=0.3)
        k, v = (_randn(gen, 2, 1, 256, d, dtype=dtype,
                       scale=0.3).requires_grad_() for _ in range(2))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.flash_attention(q.requires_grad_(), k, v).sum().backward()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        ran = {n: any(n + "<" in key or n + "(" in key for key in names)
               for kernels in FLASH_KERNELS.values() for n in kernels}
        assert ran == {n: r == route for r, kernels in FLASH_KERNELS.items()
                       for n in kernels}, names


def test_flash_attention_refuses_a_base_tma_cannot_read(card):
    """The tensor-core route needs 16-byte-aligned bases: refused, never
    rerouted to the CUDA-core kernels."""
    buf = torch.zeros(1 * 2 * 64 * 64 + 1, dtype=torch.bfloat16, device=card)
    q = buf[1:].view(1, 2, 64, 64)
    k = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16, device=card)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, k, k)
    # fp32 (the CUDA-core kernels) takes the same offset
    q32 = torch.zeros(1 * 2 * 64 * 64 + 1, device=card)[1:].view(1, 2, 64, 64)
    assert ops.flash_attention(q32, k.float(), k.float()).shape == q32.shape


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,v,d", [(77, 1000, 64), (300, 4099, 520),
                                   (16, 128, 2048)])
def test_ce_loss_kernels_match_plain(card, dtype, t, v, d):
    gen = torch.Generator().manual_seed(7)
    x = _randn(gen, t, d, dtype=dtype).requires_grad_()
    w = _randn(gen, v, d, dtype=dtype, scale=0.05).requires_grad_()
    labels = torch.randint(0, v, (t,), generator=gen).cuda()
    g = _randn(gen, t, scale=0.1)
    before = dict(ops.LAUNCHES)
    loss = ops.ce_loss(x, w, labels)
    loss.backward(g)
    assert ops.LAUNCHES["ce_loss"] == before["ce_loss"] + 1
    assert ops.LAUNCHES["ce_loss_bwd"] == before["ce_loss_bwd"] + 1
    want = ce_loss_ref(x.detach(), w.detach(), labels)
    assert loss.dtype == torch.float32 and loss.shape == (t,)
    assert float((loss.detach() - want).abs().max()) <= TOL[dtype]
    _, logz = ops._ce_fwd(x.detach(), w.detach(), labels.to(torch.int32))
    assert float((logz - ce_loss_logz_ref(x.detach(), w.detach())
                  ).abs().max()) <= TOL[dtype]
    dx, dw = ce_loss_bwd_ref(x.detach(), w.detach(), labels, logz, g)
    assert _rel(x.grad, dx) <= GRAD_TOL[dtype]
    assert _rel(w.grad, dw) <= GRAD_TOL[dtype]
    if dtype == torch.float32:          # and autograd of the plain forward
        x2, w2 = (a.detach().clone().requires_grad_() for a in (x, w))
        ce_loss_ref(x2, w2, labels).backward(g)
        assert _rel(x.grad, x2.grad) <= 1e-4
        assert _rel(w.grad, w2.grad) <= 1e-4


@pytest.mark.parametrize("layout", ["NT", "TN", "NN"])
@pytest.mark.parametrize("m,n,k", [(128, 128, 64), (200, 264, 136),
                                   (8, 16, 520)])
def test_ce_tile_engine_matches_an_fp32_product(card, layout, m, n, k):
    """The bf16 ce_loss kernels' tensor-core engine alone: a bf16 x bf16
    product is exact in fp32, so it differs from the fp32 product of the
    same operands (TF32 off) only in summation order."""
    gen = torch.Generator().manual_seed(11)
    a = _randn(gen, *((k, m) if layout == "TN" else (m, k)),
               dtype=torch.bfloat16)
    b = _randn(gen, *((n, k) if layout == "NT" else (k, n)),
               dtype=torch.bfloat16)
    got = ops.ce_tile_product(a, b, layout)
    af, bf = a.float(), b.float()
    want = {"NT": lambda: af @ bf.T, "TN": lambda: af.T @ bf,
            "NN": lambda: af @ bf}[layout]()
    assert got.shape == (m, n)
    assert _rel(got, want) <= 1e-5


CE_BF16_EDGES = [
    # (T, V, d, chunk): None keeps ops.CE_CHUNK
    (64, 32768 + 1, 64, None),     # V = chunk + 1: a last chunk of one row
    (40, 3000, 2560, None),        # mamba2-2.7b's d
    (5, 1000, 128, None),          # T < 64: one warpgroup's rows all past T
    (130, 1000, 136, 256),         # four chunks, the last ragged; d % 64 != 0
]


@pytest.mark.parametrize("t,v,d,chunk", CE_BF16_EDGES)
def test_ce_loss_bf16_kernels_at_the_edges(card, monkeypatch, t, v, d, chunk):
    if chunk is not None:
        monkeypatch.setattr(ops, "CE_CHUNK", chunk)
    gen = torch.Generator().manual_seed(12)
    x = _randn(gen, t, d, dtype=torch.bfloat16).requires_grad_()
    w = _randn(gen, v, d, dtype=torch.bfloat16, scale=0.05).requires_grad_()
    labels = torch.randint(0, v, (t,), generator=gen)
    labels[0] = v - 1                   # a gold logit in the last row
    labels = labels.cuda()
    g = _randn(gen, t, scale=0.1)
    loss = ops.ce_loss(x, w, labels)
    loss.backward(g)
    want = ce_loss_ref(x.detach(), w.detach(), labels)
    assert float((loss.detach() - want).abs().max()) <= TOL[torch.bfloat16]
    _, logz = ops._ce_fwd(x.detach(), w.detach(), labels.to(torch.int32))
    for dx, dw in (ce_loss_bwd_ref(x.detach(), w.detach(), labels, logz, g),
                   ce_loss_bwd_chunked_ref(x.detach(), w.detach(), labels,
                                           logz, g, ops.ce_chunk(v))):
        assert _rel(x.grad, dx) <= GRAD_TOL[torch.bfloat16]
        assert _rel(w.grad, dw) <= GRAD_TOL[torch.bfloat16]


def test_ce_loss_bf16_kernels_are_deterministic(card, monkeypatch):
    """No atomics: two calls give bitwise equal loss, dx and dW (three
    chunks here, so the fp32 dx sum runs too)."""
    monkeypatch.setattr(ops, "CE_CHUNK", 512)
    gen = torch.Generator().manual_seed(13)
    x = _randn(gen, 300, 256, dtype=torch.bfloat16)
    w = _randn(gen, 1500, 256, dtype=torch.bfloat16, scale=0.05)
    labels = torch.randint(0, 1500, (300,), generator=gen).cuda().int()
    g = _randn(gen, 300, scale=0.1)
    (l1, z1), (l2, z2) = (ops._ce_fwd(x, w, labels) for _ in range(2))
    assert torch.equal(l1, l2) and torch.equal(z1, z2)
    (dx1, dw1), (dx2, dw2) = (ops._ce_bwd(x, w, labels, z1, g)
                              for _ in range(2))
    assert torch.equal(dx1, dx2) and torch.equal(dw1, dw2)


def test_no_grad_forward_saves_nothing_and_matches(card):
    gen = torch.Generator().manual_seed(8)
    q = _randn(gen, 1, 2, 64, 64, scale=0.3).requires_grad_()
    with torch.inference_mode():
        a = ops.flash_attention(q.detach(), q[:, :1].detach().contiguous(),
                                q[:, :1].detach().contiguous())
    b = ops.flash_attention(q, q[:, :1].detach().contiguous(),
                            q[:, :1].detach().contiguous())
    assert a.grad_fn is None and b.grad_fn is not None
    assert torch.equal(a, b.detach())


def test_smoke_model_train_step_on_card_matches_cpu(card):
    """One ElasticTrainer step of the fp32 smoke model: the card (every
    kernel, forward and backward) against a CPU copy (plain versions)."""
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.optim import AdamW

    cfg = get_arch("gemma-2b-smoke")
    gpu = Model(cfg, device=card, remat=False,
                generator=torch.Generator(device=card).manual_seed(1))
    cpu = copy.deepcopy(gpu).to("cpu")
    trainers = [ElasticTrainer(m, per_node_batch=2, seed=3, device=dev,
                               optimizer=AdamW(lr=1e-3), warmup_steps=1)
                for m, dev in ((gpu, card), (cpu, "cpu"))]
    for tr in trainers:
        tr.seq_len(48)
        tr.rescale(1)
    ops.reset_launches()
    got = [trainers[0].train_step() for _ in range(2)]
    n = cfg.n_layers
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0) | {
        "rms_norm": 2 * (2 * n + 1), "rms_norm_bwd": 2 * (2 * n + 1),
        "flash_attention": 2 * n, "flash_attention_bwd": 2 * n,
        "ce_loss": 2, "ce_loss_bwd": 2}
    want = [trainers[1].train_step() for _ in range(2)]
    for g, w in zip(got, want):
        assert abs(g.loss - w.loss) <= 1e-4 * abs(w.loss)
    for name, p in trainers[1].params.items():
        q = trainers[0].params[name].detach().cpu()
        scale = max(float(p.detach().abs().max()), 1e-30)
        assert float((q - p.detach()).abs().max()) <= 1e-4 * scale, name


SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.08}
SSD_CASES = [
    # (B, S, H, P, N), chunk
    ((1, 64, 2, 16, 8), 32),
    ((2, 128, 3, 32, 16), 64),
    ((2, 100, 3, 16, 16), 32),        # ragged S
    ((1, 1000, 2, 64, 128), 256),     # ragged S, mamba2-2.7b head
    ((2, 256, 4, 64, 128), 256),      # mamba2-2.7b training chunk
]


def _ssd_inputs(shape, dtype, seed, dt_range=(0.01, 0.51), a=None):
    b, s, h, p, n = shape
    rng = np.random.RandomState(seed)
    lo, hi = dt_range
    a = -np.exp(rng.randn(h) * 0.3) if a is None else np.full(h, a)
    host = [rng.randn(b, s, h, p) * 0.5, rng.rand(b, s, h) * (hi - lo) + lo,
            a, rng.randn(b, s, h, n) * 0.4, rng.randn(b, s, h, n) * 0.4]
    return [torch.from_numpy(v).float().to(dt).cuda() for v, dt in zip(
        host, (dtype, torch.float32, torch.float32, dtype, dtype))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(card, dtype, shape, chunk):
    x, dt, a, bm, cm = _ssd_inputs(shape, dtype, 1)
    before = ops.LAUNCHES["ssd_scan"]
    y, final = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert final.dtype == torch.float32 and final.shape == (
        shape[0], shape[2], shape[3], shape[4])
    for want_y, want_f in (ssd_chunked(x, dt, a, bm, cm, chunk=chunk),
                           ssd_scan_ref(x, dt, a, bm, cm)):
        assert float((y.float() - want_y.float()).abs().max()) < SSD_TOL[dtype]
        assert float((final - want_f).abs().max()) < SSD_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,chunk", SSD_CASES)
def test_ssd_scan_bwd_kernel_matches_plain(card, dtype, shape, chunk):
    leaves = [t.requires_grad_() for t in _ssd_inputs(shape, dtype, 2)]
    gen = torch.Generator().manual_seed(3)
    b, s, h, p, n = shape
    dy = _randn(gen, b, s, h, p, dtype=dtype)
    dfinal = _randn(gen, b, h, p, n)
    before = dict(ops.LAUNCHES)
    y, final = ops.ssd_scan(*leaves, chunk=chunk)
    torch.autograd.backward([y, final], [dy, dfinal])
    assert ops.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert ops.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    plain = [t.detach() for t in leaves]
    want = ssd_scan_bwd_ref(*plain, dy, dfinal, chunk=chunk)
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= GRAD_TOL[dtype]
    if dtype == torch.float32 and s <= 256:    # and autograd of the naive scan
        again = [t.clone().requires_grad_() for t in plain]
        torch.autograd.backward(list(ssd_scan_ref(*again)), [dy, dfinal])
        for leaf, t in zip(leaves, again):
            assert _rel(leaf.grad, t.grad) <= 1e-4


def test_ssd_scan_kernel_is_finite_where_the_decay_overflows(card):
    """dt |a| L ~ 220 > 88 at a chunk of 256: exp above the diagonal would
    overflow; the kernel takes it only where s <= l."""
    leaves = [t.requires_grad_() for t in _ssd_inputs(
        (1, 256, 2, 4, 4), torch.float32, 4, dt_range=(0.6, 1.1), a=-1.0)]
    y, final = ops.ssd_scan(*leaves, chunk=256)
    (y.sum() + final.sum()).backward()
    again = [t.detach().clone().requires_grad_() for t in leaves]
    y2, f2 = ssd_scan_ref(*again)
    (y2.sum() + f2.sum()).backward()
    assert float((y.detach() - y2.detach()).abs().max()) < 1e-4
    for leaf, t in zip(leaves, again):
        assert torch.isfinite(leaf.grad).all()
        assert _rel(leaf.grad, t.grad) <= 1e-4


def test_ssd_scan_refuses_what_the_kernel_does_not_take(card):
    x, dt, a, bm, cm = _ssd_inputs((1, 8, 2, 4, 4), torch.float32, 5)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=512)
    with pytest.raises(ValueError, match="fp32"):
        ops.ssd_scan(x, dt.bfloat16(), a, bm, cm)


def test_mamba2_smoke_model_on_card_matches_cpu_and_serves_through_kernels(
        card):
    cfg = get_arch("mamba2-2.7b-smoke")
    gpu = Model(cfg, device=card, trainable=False,
                generator=torch.Generator(device=card).manual_seed(0))
    cpu = copy.deepcopy(gpu).to("cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 40)))
    want, _ = cpu({"tokens": toks})
    got, _ = gpu({"tokens": toks.cuda()})
    scale = max(float(want.abs().max()), 1.0)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale

    ops.reset_launches()
    res = ServeEngine(gpu, max_len=56).generate({"tokens": toks[:, :36]}, 8)
    ref = ServeEngine(cpu, max_len=56, device="cpu").generate(
        {"tokens": toks[:, :36]}, 8)
    n = cfg.n_layers
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0) | {
        "rms_norm": (2 * n + 1) * 9, "ssd_scan": n}
    np.testing.assert_array_equal(res.tokens, ref.tokens)


def test_mamba2_smoke_train_step_on_card_matches_cpu(card):
    """The fp32 mamba2 smoke model on the card (RMSNorm, SSD scan and
    ce_loss kernels, forward and backward) against a CPU copy (plain
    versions): the loss and every gradient on the same params, then two
    ElasticTrainer steps' launches and losses.  Params after an AdamW
    step are not compared: its first step is about lr * sign(g), so an
    element whose gradient is at the level of the summation noise moves
    by a sign the order of the sums decides."""
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.optim import AdamW

    cfg = get_arch("mamba2-2.7b-smoke")
    gpu = Model(cfg, device=card, remat=False,
                generator=torch.Generator(device=card).manual_seed(1))
    cpu = copy.deepcopy(gpu).to("cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 72)))
    losses = []
    for model, t in ((gpu, toks.cuda()), (cpu, toks)):   # 72 = 2 x 32 + 8
        loss = model.loss({"tokens": t, "labels": t})
        loss.backward()
        losses.append(float(loss.detach()))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for (name, g), (_, c) in zip(gpu.named_parameters(),
                                 cpu.named_parameters()):
        assert _rel(g.grad.cpu(), c.grad) <= 1e-4, name
        g.grad, c.grad = None, None

    trainers = [ElasticTrainer(m, per_node_batch=2, seed=3, device=dev,
                               optimizer=AdamW(lr=1e-3), warmup_steps=1)
                for m, dev in ((gpu, card), (cpu, "cpu"))]
    for tr in trainers:
        tr.seq_len(72)
        tr.rescale(1)
    ops.reset_launches()
    got = [trainers[0].train_step() for _ in range(2)]
    n = cfg.n_layers
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0) | {
        "rms_norm": 2 * (2 * n + 1), "rms_norm_bwd": 2 * (2 * n + 1),
        "ssd_scan": 2 * n, "ssd_scan_bwd": 2 * n,
        "ce_loss": 2, "ce_loss_bwd": 2}
    want = [trainers[1].train_step() for _ in range(2)]
    for g, w in zip(got, want):
        assert abs(g.loss - w.loss) <= 1e-4 * abs(w.loss)
