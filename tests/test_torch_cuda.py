"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small sizes; and the smoke model on the card against its CPU
copy.  Marked ``cuda``; run on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (the check is in the ``card`` fixture,
never at import).  Tolerances: 2e-5 fp32, 2e-2 bf16 for the kernels, as
in ``tests/test_kernels.py``; gradients 1e-4 (fp32) / 2e-2 (bf16) of the
largest |gradient|; 1e-4 of the largest logit, loss or parameter for the
fp32 smoke model (TF32 off), whose card and CPU runs differ only in
summation order.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    ce_loss_bwd_ref,
    ce_loss_logz_ref,
    ce_loss_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    rms_norm_bwd_ref,
    rms_norm_ref,
)
from repro_torch.models import Model
from repro_torch.serving import ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# gradients: relative to the largest |gradient| (summation order in fp32;
# one bf16 rounding of the output in bf16)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
    if dtype == torch.float32:   # the bf16 plain version rounds its scores
        _, want_lse = flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                          return_lse=True, **kw)
        assert float((lse - want_lse).abs().max()) <= 1e-5
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   out.detach(), lse, do, **kw)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert _rel(got, w) <= GRAD_TOL[dtype]
    if dtype == torch.float32:          # and autograd of the plain forward
        q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
        flash_attention_ref(q2, k2, v2, **kw).backward(do)
        for got, t in zip((q.grad, k.grad, v.grad), (q2, k2, v2)):
            assert _rel(got, t.grad) <= 1e-4


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
    assert ops.LAUNCHES == {"rms_norm": 2 * (2 * n + 1),
                            "rms_norm_bwd": 2 * (2 * n + 1),
                            "flash_attention": 2 * n,
                            "flash_attention_bwd": 2 * n,
                            "ce_loss": 2, "ce_loss_bwd": 2}
    want = [trainers[1].train_step() for _ in range(2)]
    for g, w in zip(got, want):
        assert abs(g.loss - w.loss) <= 1e-4 * abs(w.loss)
    for name, p in trainers[1].params.items():
        q = trainers[0].params[name].detach().cpu()
        scale = max(float(p.detach().abs().max()), 1e-30)
        assert float((q - p.detach()).abs().max()) <= 1e-4 * scale, name
