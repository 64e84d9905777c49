"""Plain PyTorch versions of the hand-written kernels.

The forwards compute what ``repro.kernels.ref`` computes, step for step
and with the same roundings, so that they are both the CPU path of
``repro_torch.kernels.ops`` and the yardstick each CUDA kernel is held
against on the card.  The backwards (``*_bwd_ref``) are the explicit
formulas the backward kernels compute, in fp32, from the forward's inputs
and the statistics the forward kernels save (``lse``, ``logz``); they let
the algorithm be tested on the CPU against autograd and ``jax.grad``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def _visible(sq: int, sk: int, causal: bool, window: int,
             device) -> torch.Tensor:
    """(Sq, Sk) bool: key k is visible to query q (top-left alignment)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """q: (B,H,S,D); k,v: (B,KV,Sk,D) with H % KV == 0. Returns (B,H,S,D),
    and with ``return_lse`` also the rows' fp32 log-sum-exp (B,H,S).

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
    ok = _visible(s, sk, causal, window, q.device)
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs, v).reshape(b, h, s, d)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            logit_cap: float = 0.0,
                            scale: Optional[float] = None):
    """(dq, dk, dv) in the inputs' types, from the forward's output ``o``
    and row log-sum-exp ``lse`` (B,H,Sq) fp32.

    p = exp(s - lse) on visible entries and exactly 0 elsewhere;
    dS = p (dO V^T - rowsum(dO O)) times ds/d(q.k), which is the scale
    times 1 - (s/cap)^2 with a softcap; dQ = dS K, dK = dS^T Q and
    dV = p^T dO, the K/V gradients summed over the heads of a group.
    """
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    qh = q.float().reshape(b, kv, g, sq, d)
    doh = do.float().reshape(b, kv, g, sq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qh, kf) * scale
    fac = torch.full_like(s, scale)
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
        fac = scale * (1.0 - (s / logit_cap) ** 2)
    ok = _visible(sq, sk, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse.reshape(b, kv, g, sq, 1)), 0.0)
    dp = torch.einsum("bkgqd,bktd->bkgqt", doh, vf)
    delta = (do.float() * o.float()).sum(-1).reshape(b, kv, g, sq, 1)
    ds = p * (dp - delta) * fac
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf).reshape(b, h, sq, d)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qh)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,). fp32 statistics, (1 + scale) gain."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rms_norm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """(dx in x's type, dscale fp32 (d,)).  With r = rsqrt(mean(x^2)+eps)
    and g = dy (1 + scale): dx = r g - x r^3 mean(g x), and dscale sums
    dy x r over the rows."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gf = dyf * (1.0 + scale.float())
    dx = r * gf - xf * r ** 3 * (gf * xf).mean(dim=-1, keepdim=True)
    dscale = (dyf * xf * r).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale


def ce_loss_ref(x: torch.Tensor, table: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy (T,) fp32. x: (T,d); table: (V,d);
    labels: (T,) integer.  fp32 logits, as ``repro.kernels.ref``."""
    logits = x.float() @ table.float().T
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return logz - gold


def ce_loss_logz_ref(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows' fp32 log-sum-exp (T,), which the forward kernel saves."""
    return torch.logsumexp(x.float() @ table.float().T, dim=-1)


def ce_loss_bwd_ref(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor, logz: torch.Tensor,
                    g: torch.Tensor):
    """(dx in x's type, dW in the table's type) for upstream gradient ``g``
    (T,) fp32: P = g (exp(logits - logZ) - onehot(labels)), dx = P W and
    dW = P^T x."""
    logits = x.float() @ table.float().T
    p = torch.exp(logits - logz[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    p[rows, labels.long()] -= 1.0
    p = p * g.float()[:, None]
    dx = p @ table.float()
    dw = p.T @ x.float()
    return dx.to(x.dtype), dw.to(table.dtype)
