"""Grouped-query attention (GQA/MQA) with RoPE, sliding windows, logit
soft-capping and decode with a KV cache (counterpart of
``repro.models.attention``).

Full-sequence self-attention runs the hand-written flash-attention kernel
on the card (``ops.flash_attention``) and ``attend_direct``, which
materialises the score matrix, on the CPU.  The JAX package's
``attend_blockwise`` (online softmax in XLA, for sequences over
``BLOCKWISE_THRESHOLD``) is not ported yet, so the CPU path refuses such
lengths.  Decode attention over the cache is plain PyTorch, as the JAX
package computes it outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_def, softcap

NEG_INF = -2.0 ** 30  # large-but-finite; keeps bf16/fp32 softmax NaN-free

BLOCKWISE_THRESHOLD = 8192


def attn_defs(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_def(d, h * hd),
        "wk": dense_def(d, kv * hd),
        "wv": dense_def(d, kv * hd),
        "wo": dense_def(h * hd, d, scale=(h * hd) ** -0.5),
    }


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Sk) additive bias from causal + sliding-window constraints."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def attend_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                  window: int, logit_cap: float, scale: float) -> torch.Tensor:
    """q: (B,Sq,KV,G,D)  k,v: (B,Sk,KV,D)  ->  (B,Sq,KV,G,D)."""
    scores = torch.einsum("bqkgd,btkd->bkgqt", q, k).float() * scale
    scores = softcap(scores, logit_cap)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", probs, v)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, d)


def attn_apply(p: dict, x: torch.Tensor, *, cfg: ArchConfig, causal: bool,
               window: int,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over a full sequence. x: (B, S, d_model)."""
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV

    q = _split_heads(x @ p["wq"], H, D)
    k = _split_heads(x @ p["wk"], KV, D)
    v = _split_heads(x @ p["wv"], KV, D)

    q_pos = positions if positions is not None else torch.arange(
        S, device=x.device)
    k_pos = torch.arange(S, device=x.device)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, k_pos, cfg.rope_theta)

    scale = cfg.query_scale or D ** -0.5
    if x.is_cuda:
        out = ops.flash_attention(q.transpose(1, 2).contiguous(),  # (B,H,S,D)
                                  k.transpose(1, 2).contiguous(),  # (B,KV,S,D)
                                  v.transpose(1, 2).contiguous(),
                                  causal=causal, window=window,
                                  logit_cap=cfg.attn_logit_softcap,
                                  scale=scale)
        return out.transpose(1, 2).reshape(B, S, H * D) @ p["wo"]

    if S > BLOCKWISE_THRESHOLD:
        raise NotImplementedError(
            f"S={S} > {BLOCKWISE_THRESHOLD} needs attend_blockwise, which the "
            "PyTorch port has not ported yet (ROADMAP.md, Queue 1)")
    out = attend_direct(q.reshape(B, S, KV, G, D), k, v, q_pos=q_pos,
                        k_pos=k_pos, causal=causal, window=window,
                        logit_cap=cfg.attn_logit_softcap, scale=scale)
    return out.reshape(B, S, H * D) @ p["wo"]


# ---------------------------------------------------------------------------
# Decode step with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu") -> dict:
    shape = (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int, *,
                cfg: ArchConfig, window: int) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d_model); cache k/v: (B, W, KV, D).

    The cache is a ring buffer when ``window`` is non-zero (slot =
    pos % W); otherwise slot = pos.  Keys are stored rotated at their
    absolute position.  Unlike the JAX version, the new key and value are
    written into ``cache`` in place (no copy of the whole cache per
    step); the same dict is returned.
    """
    B = x.shape[0]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    W = cache["k"].shape[1]

    q = _split_heads(x @ p["wq"], H, D)
    k_new = _split_heads(x @ p["wk"], KV, D)
    v_new = _split_heads(x @ p["wv"], KV, D)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)

    slot = pos % max(W, 1) if window else pos
    k, v = cache["k"], cache["v"]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    # Valid slots: the ring is fully valid once pos+1 >= W; before that
    # only slots <= pos hold data.
    valid = (torch.arange(W, device=x.device) <= pos) | (pos >= W)

    # JAX promotes q against the cache dtype; torch's einsum wants one dtype
    ct = torch.promote_types(q.dtype, k.dtype)
    qh = q.reshape(B, 1, KV, G, D).to(ct)
    scale = cfg.query_scale or D ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", qh, k.to(ct)).float() * scale
    s = softcap(s, cfg.attn_logit_softcap)
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v).to(x.dtype)
    out = out.reshape(B, 1, H * D) @ p["wo"]
    return out, cache
