"""Registry of the architectures the PyTorch package can run
(``--arch <id>``).

It holds only configurations whose every layer the PyTorch models
implement; the JAX package's registry has the full list.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2_2_7b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [_gemma_2b, _mamba2_2_7b]}


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_arch(name[: -len("-smoke")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]

