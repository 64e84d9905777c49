"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX oracles ``repro.kernels.ref`` over the sweep of
``tests/test_kernels.py``, and against the Pallas kernels in interpret
mode on a few cases.

Inputs are made with numpy and cast to bf16 by each framework, which both
round to nearest even, so the two sides see the same values.  Tolerances
are those of ``tests/test_kernels.py::_tol``: 2e-5 in fp32, 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.ref import flash_attention_ref as jax_fa_ref
from repro.kernels.ref import rms_norm_ref as jax_rms_ref
from repro_torch.kernels import ops

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
