"""Weights and optimizer state between the JAX package and the port.

The JAX package writes a tree to npz keyed by ``jax.tree_util.keystr``
paths (``repro.checkpoint.checkpoint._flatten``): dict keys as
``['name']``, tuple indices as ``[0]`` and NamedTuple fields (the
``mu``/``nu``/``step`` of ``AdamWState``) as ``.name``, e.g.
``['blocks'][0]['mixer']['wq']`` of shape (n_blocks, d, H*D) or
``['opt_state'].mu['embed']``.  The PyTorch model keeps the same tree and
layout, so each key maps to one dotted name (``blocks.0.mixer.wq``,
``opt_state.mu.embed``) and back, and a JAX-written checkpoint loads
with ``numpy.load`` alone::

    flat = dict(np.load("ckpt.npz"))
    model.load_state_dict(params_from_flat(flat))

``load_state_dict`` copies into the model's tensors and casts to their
dtypes, so norm scales stay fp32 in a bf16 model.

numpy has no bfloat16: the JAX package's npz stores a bf16 array as
2-byte void (``|V2``), the raw bits.  ``to_numpy``/``from_numpy`` write
and read that same form, so each side reads the other's files.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_]\w*)")


def torch_name(keystr: str) -> str:
    """``"['blocks'][0]['mixer']['wq']"`` -> ``"blocks.0.mixer.wq"``;
    ``"['opt_state'].mu['embed']"`` -> ``"opt_state.mu.embed"``."""
    parts = _KEY.findall(keystr)
    rebuilt = "".join(f"['{a}']" if a else (f"[{b}]" if b else f".{c}")
                      for a, b, c in parts)
    if not parts or rebuilt != keystr:
        raise ValueError(f"not a keystr path of dict keys / indices / "
                         f"attributes: {keystr!r}")
    return ".".join(a or b or c for a, b, c in parts)


def keystr_name(name: str) -> str:
    """A dotted name of dict keys and indices as a keystr path:
    ``"blocks.0.mixer.wq"`` -> ``"['blocks'][0]['mixer']['wq']"``."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy as numpy; bf16 as the raw ``|V2`` the JAX package
    writes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """Inverse of ``to_numpy`` (a CPU tensor owning its memory)."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_flat(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A keystr-keyed dict of arrays as a ``state_dict`` (CPU tensors)."""
    return {torch_name(k): from_numpy(v) for k, v in flat.items()}


def flat_from_params(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A ``state_dict`` as the JAX package's keystr-keyed arrays."""
    return {keystr_name(n): to_numpy(t) for n, t in state.items()}
