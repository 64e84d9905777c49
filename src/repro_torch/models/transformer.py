"""Per-layer definitions and apply functions (counterpart of
``repro.models.transformer``), for dense-attention + dense-MLP layers.

Every other feature of the config schema raises ``NotImplementedError``
in ``check_supported``: MoE, MLA, Mamba, encoder-decoder, modality
frontends, gemma2's post-norms and sliding windows (ring caches).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, mlp_defs, norm_def, rms_norm


def check_supported(cfg: ArchConfig) -> None:
    unsupported = {
        "moe": cfg.moe is not None,
        "mla": cfg.mla is not None,
        "mamba/ssm": cfg.ssm is not None,
        "encoder-decoder": cfg.encoder is not None,
        f"frontend={cfg.frontend}": cfg.frontend != "none",
        "post_norms": cfg.post_norms,
        "sliding_window (ring caches)": bool(cfg.sliding_window),
    }
    for spec in cfg.layer_pattern:
        unsupported[f"mixer={spec.mixer}"] = spec.mixer != "attn"
        unsupported[f"mlp={spec.mlp}"] = spec.mlp != "dense"
    missing = sorted(k for k, v in unsupported.items() if v)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not run {missing} yet "
            "(ROADMAP.md, Queue 1)")


def block_defs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    return {
        "mixer_norm": norm_def(cfg.d_model),
        "mixer": attn.attn_defs(cfg),
        "mlp_norm": norm_def(cfg.d_model),
        "mlp": mlp_defs(cfg.d_model, cfg.dense_d_ff or cfg.d_ff),
    }


def apply_block(cfg: ArchConfig, spec: LayerSpec, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    x = x + attn.attn_apply(p["mixer"], h, cfg=cfg, causal=True, window=0)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_activation)


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     cache_len: int, dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cpu") -> dict:
    return {"kv": attn.init_kv_cache(batch, cache_len, cfg.n_kv_heads,
                                     cfg.head_dim, dtype, device)}


def apply_block_decode(cfg: ArchConfig, spec: LayerSpec, p: dict,
                       x: torch.Tensor, cache: dict,
                       pos: int) -> tuple[torch.Tensor, dict]:
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    out, kv = attn.attn_decode(p["mixer"], h, cache["kv"], pos, cfg=cfg,
                               window=0)
    x = x + out
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h, cfg.mlp_activation)
    return x, {"kv": kv}
