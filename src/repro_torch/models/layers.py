"""Parameter definitions and primitive layers (counterpart of
``repro.models.layers``).

Parameters keep the JAX layout: dense weights are ``(d_in, d_out)`` and
applied as ``x @ w``; per-layer parameters carry a leading ``n_blocks``
axis (``stack_defs``).  A defs tree of :class:`ParamDef` leaves gives the
shapes (``n_params`` without allocating) and the tensors
(``materialize``, from a ``torch.Generator``).  Torch's generator cannot
reproduce ``jax.random``'s bits, so parity with the JAX package always
runs on weights bridged from it (``repro_torch.bridge``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Tree = Any


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float = 0.02
    fp32: bool = False          # keep fp32 whatever the model dtype (norms)


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn, tree: Tree, is_leaf=_is_def) -> Tree:
    """Map over the leaves of nested dicts / tuples."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree: Tree, is_leaf=_is_def) -> list:
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


def stack_defs(defs: Tree, n: int) -> Tree:
    """Prepend a layer-stack dimension."""
    return tree_map(lambda d: dataclasses.replace(d, shape=(n, *d.shape)), defs)


def n_params(defs: Tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def materialize(defs: Tree, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Tree:
    """Normal x scale for weights, zeros or ones where the def says so;
    ``fp32`` leaves stay fp32."""

    def make(d: ParamDef) -> torch.Tensor:
        leaf_dtype = torch.float32 if d.fp32 else dtype
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(d.shape, dtype=leaf_dtype, device=device)
        w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(d.scale).to(leaf_dtype)

    return tree_map(make, defs)


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The JAX package's default ``NORM_MULT_FP32=True`` arithmetic: the
    CUDA kernel on the card, its plain version on the CPU."""
    return ops.rms_norm(x, scale, eps=eps)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.gelu(gate, approximate="tanh") * up


ACTIVATIONS = {"swiglu": swiglu, "geglu": geglu}


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split rotation, fp32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (..., S, D/2)
    ang = ang[..., None, :]                                # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------


def dense_def(d_in: int, d_out: int, scale: float | None = None) -> ParamDef:
    return ParamDef((d_in, d_out), scale=d_in ** -0.5 if scale is None else scale)


def norm_def(d_model: int) -> ParamDef:
    return ParamDef((d_model,), init="zeros", fp32=True)


def mlp_defs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": dense_def(d_model, d_ff),
        "w_up": dense_def(d_model, d_ff),
        "w_down": dense_def(d_ff, d_model),
    }


def mlp_apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = ACTIVATIONS[activation]
    h = act(x @ p["w_gate"], x @ p["w_up"])
    return h @ p["w_down"]
