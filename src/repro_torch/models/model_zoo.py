"""``Model``: a dense decoder LM with prefill and decode (counterpart of
``repro.models.model_zoo.Model``).

Parameters mirror the JAX tree: ``embed`` (V, d), ``final_norm`` (d,)
and ``blocks``, one ``ParamTree`` per position of ``cfg.layer_pattern``
whose tensors carry a leading ``n_blocks`` axis.  The ``state_dict``
names are the JAX ``keystr`` paths with dots (``['blocks'][0]['mixer']
['wq']`` is ``blocks.0.mixer.wq``), which keeps ``repro_torch.bridge``
one-to-one.  Parameters are buffers of a serving model: they do not
require grad.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef, rms_norm, softcap


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module; ``tree["name"]`` reads like
    the JAX dict it mirrors."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, ParamTree(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def layer(self, j: int) -> dict:
        """Layer ``j`` of the stack: nested dict of views, no copies."""
        out: dict = {n: p[j] for n, p in self.named_parameters(recurse=False)}
        for n, m in self.named_children():
            out[n] = m.layer(j)
        return out


def model_defs(cfg: ArchConfig) -> dict:
    d = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model),
                          scale=cfg.d_model ** -0.5),
        "final_norm": L.norm_def(cfg.d_model),
        "blocks": tuple(L.stack_defs(T.block_defs(cfg, spec), cfg.n_blocks)
                        for spec in cfg.layer_pattern),
    }
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.vocab_size, cfg.d_model),
                                scale=cfg.d_model ** -0.5)
    return d


def n_params(cfg: ArchConfig) -> int:
    """Parameter count from the defs alone (allocates nothing)."""
    return L.n_params(model_defs(cfg))


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        T.check_supported(cfg)
        dev = L.resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = L.materialize(model_defs(cfg), generator, dtype, dev)
        blocks = params.pop("blocks")
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.blocks = nn.ModuleList(ParamTree(b) for b in blocks)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _layers(self):
        """(pattern index, block index, spec, layer params) in layer order."""
        for j in range(self.cfg.n_blocks):
            for i, spec in enumerate(self.cfg.layer_pattern):
                yield i, j, spec, self.blocks[i].layer(j)

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.scale_embeddings:
            x = (x.float() * self.cfg.d_model ** 0.5).to(x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, as with the JAX package's ``CE_UPCAST=True``."""
        table = self.embed if self.cfg.tie_embeddings else self.unembed
        logits = x @ table.T
        return softcap(logits.float(), self.cfg.final_logit_softcap)

    # ------------------------------------------------------------------
    # Forward (full sequence)
    # ------------------------------------------------------------------

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) fp32, aux_loss); dense layers have no
        auxiliary loss, so it is 0."""
        x = self._embed(batch["tokens"])
        for _, _, spec, p in self._layers():
            x = T.apply_block(self.cfg, spec, p, x)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), torch.zeros((), device=x.device)

    # ------------------------------------------------------------------
    # Serving: cache init, prefill, one-token decode
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> tuple:
        cfg = self.cfg

        def one(spec):
            c = T.init_block_cache(cfg, spec, batch, cache_len, dtype,
                                   self.device)
            return L.tree_map(lambda a: a.expand(cfg.n_blocks, *a.shape).clone(),
                              c, is_leaf=_is_tensor)

        return tuple(one(spec) for spec in cfg.layer_pattern)

    def decode_step(self, cache: tuple, tokens: torch.Tensor,
                    pos: int) -> tuple[torch.Tensor, tuple]:
        """tokens: (B,1) integer; pos: absolute position.  The cache is
        updated in place and returned."""
        x = self._embed(tokens)
        for i, j, spec, p in self._layers():
            layer_cache = L.tree_map(lambda a: a[j], cache[i],
                                     is_leaf=_is_tensor)
            x, _ = T.apply_block_decode(self.cfg, spec, p, x, layer_cache, pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), cache

    def prefill(self, batch: dict,
                cache_len: Optional[int] = None) -> tuple[torch.Tensor, tuple]:
        """Returns (last-position logits (B,1,V), cache filled through S-1,
        in bf16)."""
        cfg = self.cfg
        x = self._embed(batch["tokens"])
        b, s = x.shape[:2]
        cache_len = cache_len or s
        cache = self.init_cache(b, cache_len)
        for i, j, spec, p in self._layers():
            h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
            out, kv = _attn_prefill(cfg, p["mixer"], h, cache_len=cache_len)
            cache[i]["kv"]["k"][j] = kv["k"]
            cache[i]["kv"]["v"][j] = kv["v"]
            x = x + out
            h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            x = x + L.mlp_apply(p["mlp"], h, cfg.mlp_activation)
        x = rms_norm(x[:, -1:].contiguous(), self.final_norm, cfg.norm_eps)
        return self._logits(x), cache


def _attn_prefill(cfg: ArchConfig, p: dict, h: torch.Tensor, *,
                  cache_len: int) -> tuple[torch.Tensor, dict]:
    b, s, _ = h.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    out = attn.attn_apply(p, h, cfg=cfg, causal=True, window=0)
    k = (h @ p["wk"]).reshape(b, s, kv, hd)
    v = (h @ p["wv"]).reshape(b, s, kv, hd)
    k = L.apply_rope(k, torch.arange(s, device=h.device), cfg.rope_theta)
    pad = (0, 0, 0, 0, 0, cache_len - s)
    k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return out, {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
