"""Dispatching wrappers for the hand-written kernels.

Counterparts of ``repro.kernels.ops``.  A tensor on the CPU goes to the
plain PyTorch version in ``ref``, differentiated by autograd; a CUDA
tensor goes to the CUDA kernel, or the call raises: there is no
fallback.  On the card each wrapper is a ``torch.autograd.Function``
whose forward and backward are both kernels; when no gradient is wanted
(serving, ``inference_mode``) the forward kernel runs alone and saves
nothing.  Both paths check the inputs against what the kernel takes
(dtype, shape, contiguity), so the CPU tests catch a layout the kernel
would refuse.  ``LAUNCHES`` counts the kernel calls (never the
plain-version calls), one per forward and one per backward, so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ce_loss_ref, flash_attention_ref, \
    rms_norm_ref

LAUNCHES: dict[str, int] = {
    "rms_norm": 0, "rms_norm_bwd": 0,
    "flash_attention": 0, "flash_attention_bwd": 0,
    "ce_loss": 0, "ce_loss_bwd": 0,
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
CE_MAX_DIM = 4096       # ce_loss.cu: d <= 8 x 512 threads


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


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only; each counts one launch)
# ---------------------------------------------------------------------------


def _rms_norm_fwd(x, scale, eps):
    out = torch.empty_like(x)
    d = x.shape[-1]
    build.check(build.library().rms_norm_launch(
        out.data_ptr(), x.data_ptr(), scale.data_ptr(), x.numel() // max(d, 1),
        d, eps, _DTYPES[x.dtype], _stream()), "rms_norm")
    LAUNCHES["rms_norm"] += 1
    return out


def _rms_norm_bwd(x, scale, dy, eps):
    lib = build.library()
    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    per = lib.rms_norm_bwd_rows_per_block()
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    part = torch.empty(max(1, -(-rows // per)), d, dtype=torch.float32,
                       device=x.device)
    build.check(lib.rms_norm_bwd_launch(
        dx.data_ptr(), dscale.data_ptr(), part.data_ptr(), x.data_ptr(),
        scale.data_ptr(), dy.data_ptr(), rows, d, eps, _DTYPES[x.dtype],
        _stream()), "rms_norm_bwd")
    LAUNCHES["rms_norm_bwd"] += 1
    return dx, dscale


def _flash_fwd(q, k, v, causal, window, logit_cap, scale, want_lse):
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    build.check(build.library().flash_attention_launch(
        out.data_ptr(), _ptr(lse), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        b, h, kv, sq, sk, d, scale, int(causal), int(window),
        float(logit_cap), _DTYPES[q.dtype], _stream()), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def _flash_bwd(q, k, v, o, lse, do, causal, window, logit_cap, scale):
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    build.check(build.library().flash_attention_bwd_launch(
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), b, h, kv, sq, sk, d, scale,
        int(causal), int(window), float(logit_cap), _DTYPES[q.dtype],
        _stream()), "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def _ce_fwd(x, table, labels):
    t, d = x.shape
    loss = torch.empty(t, dtype=torch.float32, device=x.device)
    logz = torch.empty(t, dtype=torch.float32, device=x.device)
    build.check(build.library().ce_loss_fwd_launch(
        loss.data_ptr(), logz.data_ptr(), x.data_ptr(), table.data_ptr(),
        labels.data_ptr(), t, table.shape[0], d, _DTYPES[x.dtype],
        _stream()), "ce_loss")
    LAUNCHES["ce_loss"] += 1
    return loss, logz


def _ce_bwd(x, table, labels, logz, g):
    t, d = x.shape
    dx, dw = torch.empty_like(x), torch.empty_like(table)
    build.check(build.library().ce_loss_bwd_launch(
        dx.data_ptr(), dw.data_ptr(), x.data_ptr(), table.data_ptr(),
        labels.data_ptr(), logz.data_ptr(), g.data_ptr(), t, table.shape[0],
        d, _DTYPES[x.dtype], _stream()), "ce_loss_bwd")
    LAUNCHES["ce_loss_bwd"] += 1
    return dx, dw


# ---------------------------------------------------------------------------
# Autograd: kernel forward, kernel backward
# ---------------------------------------------------------------------------


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _rms_norm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, scale):
        out, lse = _flash_fwd(q, k, v, causal, window, logit_cap, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, logit_cap, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


class _CeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, labels):
        loss, logz = _ce_fwd(x, table, labels)
        ctx.save_for_backward(x, table, labels, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, table, labels, logz = ctx.saved_tensors
        dx, dw = _ce_bwd(x, table, labels, logz, g.float().contiguous())
        return dx, dw, None


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


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
    if _wants_grad(x, scale):
        return _RmsNorm.apply(x, scale, eps)
    return _rms_norm_fwd(x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KV,Sk,D); H % KV == 0. Returns (B,H,Sq,D).

    The JAX wrapper's ``block_q``/``block_k``/``interpret`` have no
    counterpart: the CUDA kernels' tiles are fixed (see their source).
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
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, logit_cap,
                                     scale)
    return _flash_fwd(q, k, v, causal, window, logit_cap, scale, False)[0]


def ce_loss(x: torch.Tensor, table: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy of the logits ``x @ table.T``, without
    materialising them. x: (T, d); table: (V, d), both fp32 or both bf16;
    labels: (T,) integer in [0, V). Returns (T,) fp32 ``logZ - gold``
    (mean-reduce outside). The JAX wrapper's ``block_rows``/``block_v``/
    ``interpret`` have no counterpart: the CUDA kernels' tiles are fixed.
    """
    what = "ce_loss"
    on_cuda = _on_cuda(x, what)
    _check(what, x.dim() == 2 and table.dim() == 2
           and table.shape[1] == x.shape[1],
           f"x {tuple(x.shape)} and table {tuple(table.shape)} must be "
           "(T, d) and (V, d)")
    t, d = x.shape
    _check(what, labels.shape == (t,) and not labels.is_floating_point()
           and not labels.is_complex(),
           f"labels must be integer of shape ({t},), got {labels.dtype} "
           f"{tuple(labels.shape)}")
    _check(what, x.dtype in _DTYPES and table.dtype == x.dtype,
           f"dtypes {x.dtype}/{table.dtype} not supported")
    _check(what, table.device == x.device == labels.device,
           "tensors on different devices")
    _check(what, x.is_contiguous() and table.is_contiguous(),
           "inputs must be contiguous")
    _check(what, 0 < d <= CE_MAX_DIM, f"d_model {d} > {CE_MAX_DIM}")
    _check(what, t < 2 ** 31 and table.shape[0] < 2 ** 31, "too many rows")
    if not on_cuda:
        return ce_loss_ref(x, table, labels)
    labels = labels.to(torch.int32).contiguous()
    if _wants_grad(x, table):
        return _CeLoss.apply(x, table, labels)
    return _ce_fwd(x, table, labels)[0]
