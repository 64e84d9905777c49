"""Per-layer definitions and apply functions (counterpart of
``repro.models.transformer``), for layers of dense attention or a Mamba-2
mixer, each followed by a dense MLP or none.

Every other feature of the config schema raises ``NotImplementedError``
in ``check_supported``: MoE, MLA, encoder-decoder, modality frontends,
gemma2's post-norms and sliding windows (ring caches).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import mlp_apply, mlp_defs, norm_def, rms_norm


def check_supported(cfg: ArchConfig) -> None:
    unsupported = {
        "moe": cfg.moe is not None,
        "mla": cfg.mla is not None,
        "encoder-decoder": cfg.encoder is not None,
        f"frontend={cfg.frontend}": cfg.frontend != "none",
        "post_norms": cfg.post_norms,
        "sliding_window (ring caches)": bool(cfg.sliding_window),
    }
    for spec in cfg.layer_pattern:
        unsupported[f"mixer={spec.mixer}"] = spec.mixer not in ("attn",
                                                                "mamba")
        unsupported[f"mlp={spec.mlp}"] = spec.mlp not in ("dense", "none")
        unsupported["mixer=mamba without cfg.ssm"] = (spec.mixer == "mamba"
                                                      and cfg.ssm is None)
    missing = sorted(k for k, v in unsupported.items() if v)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not run {missing} yet "
            "(ROADMAP.md, Queue 1)")


def block_defs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    d: dict = {"mixer_norm": norm_def(cfg.d_model)}
    if spec.mixer == "mamba":
        d["mixer"] = mamba2.mamba_defs(cfg)
    else:
        d["mixer"] = attn.attn_defs(cfg)
    if spec.mlp == "dense":
        d["mlp_norm"] = norm_def(cfg.d_model)
        d["mlp"] = mlp_defs(cfg.d_model, cfg.dense_d_ff or cfg.d_ff)
    return d


def apply_mlp(cfg: ArchConfig, spec: LayerSpec, p: dict,
              x: torch.Tensor) -> torch.Tensor:
    """The MLP half of a layer (nothing for ``mlp="none"``)."""
    if spec.mlp == "none":
        return x
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_activation)


def apply_block(cfg: ArchConfig, spec: LayerSpec, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    if spec.mixer == "mamba":
        out = mamba2.mamba_apply(p["mixer"], h, cfg)
    else:
        out = attn.attn_apply(p["mixer"], h, cfg=cfg, causal=True, window=0)
    return apply_mlp(cfg, spec, p, x + out)


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     cache_len: int, dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cpu") -> dict:
    if spec.mixer == "mamba":
        return {"mamba": mamba2.init_mamba_cache(cfg, batch, dtype, device)}
    return {"kv": attn.init_kv_cache(batch, cache_len, cfg.n_kv_heads,
                                     cfg.head_dim, dtype, device)}


def apply_block_decode(cfg: ArchConfig, spec: LayerSpec, p: dict,
                       x: torch.Tensor, cache: dict,
                       pos: int) -> tuple[torch.Tensor, dict]:
    """One-token decode; writes the layer's cache in place."""
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    if spec.mixer == "mamba":
        out, _ = mamba2.mamba_decode(p["mixer"], h, cache["mamba"], cfg)
    else:
        out, _ = attn.attn_decode(p["mixer"], h, cache["kv"], pos, cfg=cfg,
                                  window=0)
    return apply_mlp(cfg, spec, p, x + out), cache
