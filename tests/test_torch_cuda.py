"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small sizes; and the smoke model on the card against its CPU
copy.  Marked ``cuda``; run on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (the check is in the ``card`` fixture,
never at import).  Tolerances: 2e-5 fp32, 2e-2 bf16 for the kernels, as
in ``tests/test_kernels.py``; 1e-4 of the largest logit for the fp32 model
(TF32 off), whose card and CPU runs differ only in summation order.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, rms_norm_ref
from repro_torch.models import Model
from repro_torch.serving import ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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
    gpu = Model(cfg, device=card,
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
    assert ops.LAUNCHES == {"rms_norm": (2 * n + 1) * 9, "flash_attention": n}
    np.testing.assert_array_equal(res.tokens, ref.tokens)
