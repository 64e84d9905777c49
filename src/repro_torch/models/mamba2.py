"""Mamba-2 block (SSD, state-space duality): counterpart of
``repro.models.mamba2``.

The full-sequence path (training, prefill) runs the SSD scan through
``ops.ssd_scan``: the hand-written CUDA kernel on the card, the plain
chunked version ``kernels.ref.ssd_chunked`` on the CPU.  Decode is the
O(1) recurrent update ``ssd_step`` and the K = 4 depthwise causal conv,
both plain PyTorch, as in the JAX package (neither is a Pallas kernel
there).

Shapes follow the paper [arXiv:2405.21060]:
    x  (B,S,H,P)   per-head inputs,  H = d_inner / head_dim
    dt (B,S,H)     positive step sizes (softplus), fp32
    A  (H,)        negative decay rates, fp32
    B,C (B,S,G,N)  input/output projections per group (broadcast to heads)

Decode writes the conv windows and the state into the cache in place and
returns the same dict (JAX returns a new cache).  With a bf16 model and
the engine's fp32 cache, the conv window's output is cast back to the
model's type, where JAX would promote the residual stream to fp32 (which
its decode scan rejects): the JAX engine serves fp32 models only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, dense_def, rms_norm


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor):
    """O(1) recurrent decode step.

    state (B,H,P,N) fp32; x (B,H,P); dt (B,H); bmat/cmat (B,H,N).
    Returns (new_state fp32, y (B,H,P) in x's type)."""
    dt = dt.float()
    da = torch.exp(dt * a.float())                           # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, bmat.float(), x.float())
    new_state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, cmat.float())
    return new_state, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block (projections + depthwise causal conv + SSD + gating)
# ---------------------------------------------------------------------------


def mamba_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    ssm = cfg.ssm
    assert ssm is not None
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.n_groups * ssm.d_state


def mamba_defs(cfg: ArchConfig) -> dict:
    """The JAX ``mamba_defs``; ``dt_bias``, ``a_log``, ``d_skip`` and
    ``norm`` stay fp32 in a bf16 model, as the JAX package types them."""
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, d_bc = mamba_dims(cfg)
    return {
        "wz": dense_def(d, d_inner),
        "wx": dense_def(d, d_inner),
        "wb": dense_def(d, d_bc),
        "wc": dense_def(d, d_bc),
        "wdt": dense_def(d, n_heads),
        "conv_x": ParamDef((ssm.d_conv, d_inner), scale=0.1),
        "conv_b": ParamDef((ssm.d_conv, d_bc), scale=0.1),
        "conv_c": ParamDef((ssm.d_conv, d_bc), scale=0.1),
        "dt_bias": ParamDef((n_heads,), init="zeros", fp32=True),
        "a_log": ParamDef((n_heads,), init="zeros", fp32=True),
        "d_skip": ParamDef((n_heads,), init="ones", fp32=True),
        "norm": ParamDef((d_inner,), init="zeros", fp32=True),
        "wo": dense_def(d_inner, d),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B,S,C) with kernel (K,C)."""
    k = kernel.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * kernel[i]
    return out


def _conv_step(window: torch.Tensor, x_new: torch.Tensor,
               kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """window (B,K-1,C) holds previous inputs in the cache's type; returns
    (new_window in that type, y (B,C) in x_new's type)."""
    full = torch.cat([window, x_new[:, None, :].to(window.dtype)], dim=1)
    y = torch.einsum("bkc,kc->bc", full, kernel.to(full.dtype))
    return full[:, 1:], y.to(x_new.dtype)


def _broadcast_groups(t: torch.Tensor, cfg: ArchConfig,
                      n_heads: int) -> torch.Tensor:
    """(..., G*N) -> (..., H, N) by repeating each group over its heads;
    a contiguous copy, whose gradient sums over a group's heads."""
    ssm = cfg.ssm
    g, n = ssm.n_groups, ssm.d_state
    t = t.reshape(*t.shape[:-1], g, n)
    return torch.repeat_interleave(t, n_heads // g, dim=-2)


def _mixer_inputs(p: dict, hidden: torch.Tensor, cfg: ArchConfig):
    """The projections, convs and activations before the scan: returns
    (z, xh, dt, a, bh, ch, (x_pre, b_pre, c_pre))."""
    ssm = cfg.ssm
    _, n_heads, _ = mamba_dims(cfg)
    b, s, _ = hidden.shape
    z = hidden @ p["wz"]
    pre = (hidden @ p["wx"], hidden @ p["wb"], hidden @ p["wc"])
    x, bmat, cmat = (F.silu(_causal_conv(t, p[name])) for t, name in
                     zip(pre, ("conv_x", "conv_b", "conv_c")))
    dt = F.softplus((hidden @ p["wdt"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = x.reshape(b, s, n_heads, ssm.head_dim)
    bh = _broadcast_groups(bmat, cfg, n_heads)
    ch = _broadcast_groups(cmat, cfg, n_heads)
    return z, xh, dt, a, bh, ch, pre


def _mixer_output(p: dict, y: torch.Tensor, xh: torch.Tensor,
                  z: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """D skip, gated RMSNorm and the output projection."""
    y = y + xh * p["d_skip"][:, None].to(y.dtype)
    y = y.reshape(*z.shape)
    return rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps) @ p["wo"]


def mamba_scan(p: dict, hidden: torch.Tensor, cfg: ArchConfig):
    """Full-sequence block through the SSD scan. Returns (out (B,S,d),
    final_state (B,H,P,N) fp32, the conv inputs (x, B, C) before the
    conv)."""
    z, xh, dt, a, bh, ch, pre = _mixer_inputs(p, hidden, cfg)
    y, final = ops.ssd_scan(xh, dt, a, bh, ch, chunk=cfg.ssm.chunk_size)
    return _mixer_output(p, y, xh, z, cfg), final, pre


def mamba_apply(p: dict, hidden: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence mamba2 block. hidden: (B,S,d_model)."""
    return mamba_scan(p, hidden, cfg)[0]


# ---------------------------------------------------------------------------
# Decode with recurrent state
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cpu") -> dict:
    ssm = cfg.ssm
    d_inner, n_heads, d_bc = mamba_dims(cfg)
    k = ssm.d_conv - 1
    return {
        "conv_x": torch.zeros((batch, k, d_inner), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, k, d_bc), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, k, d_bc), dtype=dtype, device=device),
        "state": torch.zeros((batch, n_heads, ssm.head_dim, ssm.d_state),
                             dtype=torch.float32, device=device),
    }


def mamba_decode(p: dict, hidden: torch.Tensor, cache: dict,
                 cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode. hidden: (B,1,d_model).  Updates ``cache`` in
    place and returns it."""
    ssm = cfg.ssm
    d_inner, n_heads, _ = mamba_dims(cfg)
    h1 = hidden[:, 0, :]

    z = h1 @ p["wz"]
    outs = []
    for name, w in (("conv_x", "wx"), ("conv_b", "wb"), ("conv_c", "wc")):
        window, y = _conv_step(cache[name], h1 @ p[w], p[name])
        cache[name].copy_(window)
        outs.append(F.silu(y))
    x, bmat, cmat = outs
    dt = F.softplus((h1 @ p["wdt"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    xh = x.reshape(-1, n_heads, ssm.head_dim)
    bh = _broadcast_groups(bmat, cfg, n_heads)
    ch = _broadcast_groups(cmat, cfg, n_heads)
    new_state, y = ssd_step(cache["state"], xh, dt, a, bh, ch)
    cache["state"].copy_(new_state)
    out = _mixer_output(p, y, xh, z, cfg)
    return out[:, None, :], cache
