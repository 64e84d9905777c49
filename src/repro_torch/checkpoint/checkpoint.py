"""Checkpointing: durable (npz on disk) and in-memory snapshots
(counterpart of ``repro.checkpoint.checkpoint``).

Elastic rescale in BFTrainer does NOT round-trip through durable storage
(paper: "without requiring a restart or resuming from checkpoints saved to
durable storage") — ``Snapshot`` keeps host copies of params/opt state that
the trainer moves back to the card from.  Durable checkpoints cover
Trainer preemption to zero nodes and job restarts.

Durable checkpoints are integrity-checked: ``save`` stamps the payload's
SHA-256 into the sidecar meta, ``load`` verifies it and raises
``CorruptCheckpointError`` on mismatch, and ``CheckpointManager`` keeps
the last ``keep`` checkpoints so a corrupt latest restore falls back to
the newest *good* one.

The files are the JAX package's: the same npz keyed by
``jax.tree_util.keystr`` paths and the same ``.meta.json`` sidecar, so
each package reads the other's checkpoints.  A tree is nested dicts,
tuples, lists and NamedTuples (``AdamWState``) with tensor leaves, named
as JAX names them: ``['key']`` for a dict key, ``[i]`` for an index,
``.field`` for a NamedTuple field.  A dict key holding dots is a dotted
``state_dict`` name and stands for its nested path
(``"blocks.0.mixer.wq"`` is ``['blocks'][0]['mixer']['wq']``), so the
port's flat parameter dicts write the JAX package's nested names.
bf16 tensors are stored as the raw ``|V2`` the JAX package writes
(``repro_torch.bridge.to_numpy``).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import from_numpy, keystr_name, to_numpy
from repro_torch.obs.telemetry import NULL_TELEMETRY

Tree = Any


class CorruptCheckpointError(RuntimeError):
    """The checkpoint payload does not match its recorded checksum (or is
    unreadable) — the restore must fall back to an older checkpoint."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(fn: Callable, tree: Tree, prefix: str = "") -> Tree:
    """``fn(keystr path, leaf)`` over the leaves, keeping dicts, tuples,
    lists and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (keystr_name(k) if "." in k
                                         else f"['{k}']"))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, getattr(tree, f), f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` over the leaves, keeping dicts, tuples, lists, NamedTuples."""
    return _map(lambda _, leaf: fn(leaf), tree)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    _map(lambda path, leaf: flat.__setitem__(
        path, to_numpy(torch.as_tensor(leaf))), tree)
    return flat


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_checkpoint(path: str, tree: Tree, meta: Optional[Dict] = None) -> None:
    """Write ``tree`` as ``<path>.npz``.  When ``meta`` is given, a
    ``<path>.meta.json`` sidecar is written alongside, with the npz
    payload's SHA-256 added under ``"sha256"`` so ``load_checkpoint``
    can verify integrity."""
    base = path[:-4] if path.endswith(".npz") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(base + ".npz", **flat)
    if meta is not None:
        meta = dict(meta, sha256=_sha256(base + ".npz"))
        with open(base + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_checkpoint(path: str, like: Tree, *,
                    verify: bool = True) -> Tuple[Tree, Optional[Dict]]:
    """Restore into the structure of ``like``, as CPU tensors in the
    stored dtypes.

    When the sidecar meta records a ``sha256`` and ``verify`` is on, the
    payload is checksummed first; a mismatch (bit rot, torn write) raises
    ``CorruptCheckpointError`` *before* any array is deserialized.  The
    digest is a transport detail and is stripped from the returned meta —
    callers get back exactly what they passed to ``save_checkpoint``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = None
    meta_path = path[: -len(".npz")] + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if meta is not None and "sha256" in meta:
        recorded = meta.pop("sha256")
        if verify:
            digest = _sha256(path)
            if digest != recorded:
                raise CorruptCheckpointError(
                    f"checkpoint {path} fails integrity check: "
                    f"sha256 {digest} != recorded {recorded}")
    try:
        with np.load(path) as data:
            tree = _map(lambda p, _: from_numpy(data[p]), like)
    except Exception as exc:
        raise CorruptCheckpointError(
            f"checkpoint {path} is unreadable: {exc}") from exc
    return tree, meta


class CheckpointManager:
    """Rolling directory of integrity-checked checkpoints.

    ``save`` writes ``ckpt_<step>.npz`` (+ checksummed meta) and prunes
    to the newest ``keep``; ``load_latest_good`` walks checkpoints
    newest-first and returns the first that passes verification.
    """

    def __init__(self, directory: str, *, keep: int = 2, telemetry=None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.keep = keep
        self.telemetry = telemetry or NULL_TELEMETRY
        os.makedirs(directory, exist_ok=True)

    def _base(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:012d}")

    def steps(self) -> List[int]:
        """Available checkpoint steps, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".npz"):
                try:
                    out.append(int(name[len("ckpt_"):-len(".npz")]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, tree: Tree, step: int,
             meta: Optional[Dict] = None) -> str:
        t0 = time.perf_counter()
        base = self._base(step)
        save_checkpoint(base, tree, meta=dict(meta or {}, step=step))
        for old in self.steps()[:-self.keep]:
            for suffix in (".npz", ".meta.json"):
                try:
                    os.remove(self._base(old) + suffix)
                except OSError:
                    pass
        tel = self.telemetry
        if tel:
            wall = time.perf_counter() - t0
            tel.observe("checkpoint.save_ms", wall * 1e3)
            tel.instant("checkpoint", "save", float(step), wall_s=wall,
                        bytes=os.path.getsize(base + ".npz"))
        return base + ".npz"

    def load_latest_good(self, like: Tree) -> Tuple[Tree, Dict, int]:
        """(tree, meta, step) of the newest checkpoint that verifies.

        Corrupt or unreadable checkpoints are skipped (newest-first);
        ``CorruptCheckpointError`` is raised only if *no* checkpoint
        survives."""
        steps = self.steps()
        last_exc: Optional[Exception] = None
        tel = self.telemetry
        for step in reversed(steps):
            try:
                t0 = time.perf_counter()
                tree, meta = load_checkpoint(self._base(step), like)
                if tel:
                    wall = time.perf_counter() - t0
                    tel.observe("checkpoint.load_ms", wall * 1e3)
                    tel.instant("checkpoint", "load", float(step),
                                wall_s=wall)
                return tree, (meta or {}), step
            except CorruptCheckpointError as exc:
                last_exc = exc
                if tel:
                    tel.count("checkpoint.corrupt_fallbacks")
                    tel.instant("checkpoint", "corrupt-fallback",
                                float(step))
        raise CorruptCheckpointError(
            f"no loadable checkpoint in {self.directory} "
            f"(tried steps {list(reversed(steps))})") from last_exc


@dataclass
class Snapshot:
    """In-memory host snapshot used across elastic rescales."""

    tree: Tree
    step: int = 0

    @classmethod
    def take(cls, tree: Tree, step: int = 0) -> "Snapshot":
        """Host (CPU) copies of every tensor leaf."""
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        return cls(tree=host, step=step)

    def restore(self, device: Optional[torch.device | str] = None) -> Tree:
        """The tensors on ``device`` (host copies when None)."""
        dev = torch.device("cpu" if device is None else device)
        return tree_map(lambda t: t.to(dev, copy=True), self.tree)
