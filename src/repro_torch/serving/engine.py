"""Batched serving engine: prefill + greedy decode (counterpart of
``repro.serving.engine``)."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import Model
from repro_torch.models.layers import resolve_device, tree_map


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_new)
    prefill_time_s: float
    decode_time_s: float
    tokens_per_s: float


class ServeEngine:
    """Runs on ``device`` (default the card), which must be the model's.

    The prefill writes its KV cache and conv windows in bf16, and the
    engine converts every bf16 leaf of the cache to ``cache_dtype`` (fp32
    by default) for decoding, as the JAX engine does.  Times end in ``torch.cuda.synchronize()`` on the card.
    """

    def __init__(self, model: Model, *, max_len: int = 512,
                 cache_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type or (
                self.device.index is not None
                and model.device.index != self.device.index):
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}: move the model first")
        self.model = model
        self.max_len = max_len
        self.cache_dtype = cache_dtype

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, batch: Dict, n_new: int, *, greedy: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        tokens = batch["tokens"]
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        tokens = tokens.to(self.device, torch.int64)
        bsz, prompt_len = tokens.shape
        if prompt_len + n_new > self.max_len:
            raise ValueError(f"prompt_len {prompt_len} + n_new {n_new} > "
                             f"max_len {self.max_len}")
        if not greedy and generator is None:
            raise ValueError("sampling needs a torch.Generator")

        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.model.prefill({"tokens": tokens},
                                           cache_len=self.max_len)
        cache = tree_map(
            lambda t: t.to(self.cache_dtype) if t.dtype == torch.bfloat16
            else t, cache, is_leaf=lambda t: isinstance(t, torch.Tensor))
        self._sync()
        t_prefill = time.perf_counter() - t0

        out = []
        t0 = time.perf_counter()
        pos = prompt_len
        for _ in range(n_new):
            if greedy:
                nxt = torch.argmax(logits[:, -1, :], dim=-1)
            else:
                probs = torch.softmax(logits[:, -1, :], dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            nxt = nxt[:, None]
            out.append(nxt)
            logits, cache = self.model.decode_step(cache, nxt, pos)
            pos += 1
        self._sync()
        t_decode = time.perf_counter() - t0
        toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(
            tokens=toks, prefill_time_s=t_prefill, decode_time_s=t_decode,
            tokens_per_s=bsz * n_new / max(t_decode, 1e-9))
