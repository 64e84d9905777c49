"""Weights from the JAX package into ``repro_torch.models.Model``.

The JAX package writes a parameter tree to npz keyed by
``jax.tree_util.keystr`` paths (``repro.checkpoint.checkpoint._flatten``),
e.g. ``['blocks'][0]['mixer']['wq']`` of shape (n_blocks, d, H*D),
``['embed']``, ``['final_norm']``.  The PyTorch model keeps the same tree
and layout, so each key maps to one ``state_dict`` name
(``blocks.0.mixer.wq``) and a JAX-written checkpoint loads with
``numpy.load`` alone::

    flat = dict(np.load("ckpt.npz"))
    model.load_state_dict(params_from_flat(flat))

``load_state_dict`` copies into the model's tensors and casts to their
dtypes, so norm scales stay fp32 in a bf16 model.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def torch_name(keystr: str) -> str:
    """``"['blocks'][0]['mixer']['wq']"`` -> ``"blocks.0.mixer.wq"``."""
    parts = _KEY.findall(keystr)
    if not parts or "".join(f"['{a}']" if a else f"[{b}]"
                            for a, b in parts) != keystr:
        raise ValueError(f"not a keystr path of dict keys / indices: {keystr!r}")
    return ".".join(a or b for a, b in parts)


def params_from_flat(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A keystr-keyed dict of arrays as a ``state_dict`` (CPU tensors)."""
    return {torch_name(k): torch.from_numpy(np.array(v, copy=True))
            for k, v in flat.items()}
