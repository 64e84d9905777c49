"""Plain PyTorch versions of the hand-written kernels.

They compute what ``repro.kernels.ref`` computes, step for step and with
the same roundings, so that they are both the CPU path of
``repro_torch.kernels.ops`` and the yardstick each CUDA kernel is held
against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,D); k,v: (B,KV,Sk,D) with H % KV == 0. Returns (B,H,S,D).

    The causal mask is aligned top-left (``k_pos <= q_pos``, both from 0).
    """
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    qh = q.reshape(b, kv, g, s, d)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qh, k).float() * scale
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs, v)
    return out.reshape(b, h, s, d)


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,). fp32 statistics, (1 + scale) gain."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)
