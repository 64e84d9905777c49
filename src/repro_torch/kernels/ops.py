"""Dispatching wrappers for the hand-written kernels.

Counterparts of ``repro.kernels.ops``.  A tensor on the CPU goes to the
plain PyTorch version in ``ref``; a CUDA tensor goes to the CUDA kernel,
or the call raises: there is no fallback.  Both paths check the inputs
against what the kernel takes (dtype, shape, contiguity), so the CPU
tests catch a layout the kernel would refuse.  ``LAUNCHES`` counts the
kernel launches (never the plain-version calls), so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref, rms_norm_ref

LAUNCHES: dict[str, int] = {"rms_norm": 0, "flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return True


def _check(what: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _stream() -> int:
    """PyTorch's current CUDA stream, as the handle the launchers take."""
    return torch.cuda.current_stream().cuda_stream


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) fp32 or bf16; scale: (d,) fp32. Returns x's dtype/shape."""
    what = "rms_norm"
    on_cuda = _on_cuda(x, what)
    d = x.shape[-1]
    _check(what, x.dtype in _DTYPES, f"dtype {x.dtype} not supported")
    _check(what, scale.dtype == torch.float32 and scale.shape == (d,),
           f"scale must be fp32 of shape ({d},), got {scale.dtype} "
           f"{tuple(scale.shape)}")
    _check(what, scale.device == x.device, "x and scale on different devices")
    _check(what, x.is_contiguous() and scale.is_contiguous(),
           "inputs must be contiguous")
    if not on_cuda:
        return rms_norm_ref(x, scale, eps)
    out = torch.empty_like(x)
    lib = build.library()
    build.check(lib.rms_norm_launch(
        out.data_ptr(), x.data_ptr(), scale.data_ptr(), x.numel() // max(d, 1),
        d, eps, _DTYPES[x.dtype], _stream()), what)
    LAUNCHES[what] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KV,Sk,D); H % KV == 0. Returns (B,H,Sq,D).

    The JAX wrapper's ``block_q``/``block_k``/``interpret`` have no
    counterpart: the CUDA kernel's tiles are fixed (see its source).
    """
    what = "flash_attention"
    on_cuda = _on_cuda(q, what)
    _check(what, q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q, k, v must be 4-d")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    _check(what, k.shape == v.shape == (b, kv, sk, d),
           f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
           f"{tuple(q.shape)}")
    _check(what, kv > 0 and h % kv == 0, f"H={h} not a multiple of KV={kv}")
    _check(what, 0 < d <= MAX_HEAD_DIM, f"head_dim {d} > {MAX_HEAD_DIM}")
    _check(what, q.dtype in _DTYPES and k.dtype == q.dtype == v.dtype,
           f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported")
    _check(what, k.device == q.device == v.device, "tensors on different devices")
    _check(what, q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
           "inputs must be contiguous")
    _check(what, h <= 65535 and b <= 65535, "grid too large")
    if not on_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, scale=scale)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lib = build.library()
    build.check(lib.flash_attention_launch(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        b, h, kv, sq, sk, d, scale, int(causal), int(window),
        float(logit_cap), _DTYPES[q.dtype], _stream()), what)
    LAUNCHES[what] += 1
    return out
