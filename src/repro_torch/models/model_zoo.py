"""``Model``: a decoder LM of attention or Mamba-2 layers with a training
loss, prefill and decode (counterpart of
``repro.models.model_zoo.Model``).

Parameters mirror the JAX tree: ``embed`` (V, d), ``final_norm`` (d,)
and ``blocks``, one ``ParamTree`` per position of ``cfg.layer_pattern``
whose tensors carry a leading ``n_blocks`` axis.  The ``state_dict``
names are the JAX ``keystr`` paths with dots (``['blocks'][0]['mixer']
['wq']`` is ``blocks.0.mixer.wq``), which keeps ``repro_torch.bridge``
one-to-one.  Parameters require grad unless the model is built with
``trainable=False`` (a serving model); the serving entry points run
under ``torch.inference_mode`` either way.  Each layer reads its slice
of the stacked tensors through one ``unbind`` per forward, whose
backward writes every layer's gradient into the stacked gradient at
once.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef, rms_norm, softcap


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module; ``tree["name"]`` reads like
    the JAX dict it mirrors."""

    def __init__(self, tree: dict, requires_grad: bool = True):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=requires_grad))
            else:
                self.add_module(name, ParamTree(value, requires_grad))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def layers(self) -> list[dict]:
        """Every layer of the stack, each a nested dict of views (no
        copies), from one ``unbind`` per tensor: its backward stacks the
        layers' gradients into the stacked tensor's gradient in one
        step."""
        per: dict = {n: p.unbind(0)
                     for n, p in self.named_parameters(recurse=False)}
        kids = {n: m.layers() for n, m in self.named_children()}
        n = len(next(iter(per.values()))) if per else len(
            next(iter(kids.values())))
        out = []
        for j in range(n):
            d: dict = {name: t[j] for name, t in per.items()}
            for name, sub in kids.items():
                d[name] = sub[j]
            out.append(d)
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
    """``remat`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package's
    ``jax.checkpoint`` does; it changes memory, not values.  ``trainable``
    makes the parameters require grad."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None,
                 remat: bool = True, trainable: bool = True):
        super().__init__()
        T.check_supported(cfg)
        dev = L.resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = L.materialize(model_defs(cfg), generator, dtype, dev)
        blocks = params.pop("blocks")
        for name, t in params.items():
            self.register_parameter(
                name, nn.Parameter(t, requires_grad=trainable))
        self.blocks = nn.ModuleList(ParamTree(b, trainable) for b in blocks)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _layers(self):
        """(pattern index, block index, spec, layer params) in layer order."""
        per_pattern = [tree.layers() for tree in self.blocks]
        for j in range(self.cfg.n_blocks):
            for i, spec in enumerate(self.cfg.layer_pattern):
                yield i, j, spec, per_pattern[i][j]

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.scale_embeddings:
            x = (x.float() * self.cfg.d_model ** 0.5).to(x.dtype)
        return x

    def _table(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, as with the JAX package's ``CE_UPCAST=True``."""
        logits = x @ self._table().T
        return softcap(logits.float(), self.cfg.final_logit_softcap)

    # ------------------------------------------------------------------
    # Forward (full sequence) and loss
    # ------------------------------------------------------------------

    def _hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding, every block and the final norm: (B, S, d)."""
        cfg = self.cfg
        x = self._embed(tokens)
        per_pattern = [tree.layers() for tree in self.blocks]

        def block(x, ps):
            for spec, p in zip(cfg.layer_pattern, ps):
                x = layer(spec, p, x)
            return x

        def layer(spec, p, x):
            if self.remat and len(cfg.layer_pattern) > 4:
                return checkpoint(T.apply_block, cfg, spec, p, x,
                                  use_reentrant=False)
            return T.apply_block(cfg, spec, p, x)

        for j in range(cfg.n_blocks):
            ps = [layers[j] for layers in per_pattern]
            if self.remat and len(cfg.layer_pattern) <= 4:
                x = checkpoint(block, x, ps, use_reentrant=False)
            else:
                x = block(x, ps)
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) fp32, aux_loss); the layers the port
        runs have no auxiliary loss, so it is 0."""
        x = self._hidden(batch["tokens"])
        return self._logits(x), torch.zeros((), device=x.device)

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy (JAX ``Model.loss``): the final
        norm on every position, then the fused ``ce_loss`` kernel on
        positions 0..S-2 against labels 1..S-1, plus the (zero) auxiliary
        loss.

        The kernel computes fp32 logits from the model's dtype; in a bf16
        model the JAX ``_logits`` rounds them to bf16 first, so bf16
        losses differ from the JAX package's by that rounding."""
        cfg = self.cfg
        if cfg.final_logit_softcap:
            raise NotImplementedError(
                f"{cfg.name}: final_logit_softcap={cfg.final_logit_softcap} "
                "needs a softcap in the ce_loss kernel, which the PyTorch "
                "port does not have yet (ROADMAP.md, Queue 1)")
        x = self._hidden(batch["tokens"])
        d = x.shape[-1]
        xs = x[:, :-1].reshape(-1, d).contiguous()
        labels = batch["labels"][:, 1:].reshape(-1)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ops.ce_loss(xs, self._table(), labels).mean() + aux

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
        """Returns (last-position logits (B,1,V), cache filled through S-1:
        KV and conv windows in bf16, SSM states in fp32)."""
        cfg = self.cfg
        x = self._embed(batch["tokens"])
        b, s = x.shape[:2]
        cache_len = cache_len or s
        cache = self.init_cache(b, cache_len)
        for i, j, spec, p in self._layers():
            h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
            if spec.mixer == "mamba":
                out, c = _mamba_prefill(cfg, p["mixer"], h)
                for name, t in c.items():
                    cache[i]["mamba"][name][j] = t
            else:
                out, kv = _attn_prefill(cfg, p["mixer"], h,
                                        cache_len=cache_len)
                cache[i]["kv"]["k"][j] = kv["k"]
                cache[i]["kv"]["v"][j] = kv["v"]
            x = T.apply_mlp(cfg, spec, p, x + out)
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


def _mamba_prefill(cfg: ArchConfig, p: dict,
                   h: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The block's output and its decode cache: the last K-1 conv inputs
    in bf16 and the scan's final state, which the kernel returns."""
    out, final, pre = mamba2.mamba_scan(p, h, cfg)
    k = cfg.ssm.d_conv - 1
    names = ("conv_x", "conv_b", "conv_c")
    cache = {n: _last_k(t, k).to(torch.bfloat16) for n, t in zip(names, pre)}
    cache["state"] = final
    return out, cache


def _last_k(x: torch.Tensor, k: int) -> torch.Tensor:
    s = x.shape[1]
    if s >= k:
        return x[:, s - k:]
    return torch.nn.functional.pad(x, (0, 0, k - s, 0))
