"""Architecture config registry.

Only gemma-2b is ported so far; the reference package's other nine
architectures are queued in ROADMAP.md (queue 1: "The other nine configs
and the moe family")."""

from typing import Dict, List

from .base import ArchConfig, ShapeConfig, SHAPES
from .gemma_2b import CONFIG as GEMMA_2B

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [GEMMA_2B]}

# short aliases for --arch flags
ALIASES = {"gemma-2b": "gemma-2b", "gemma": "gemma-2b"}


def get_config(name: str) -> ArchConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)} "
                       "(the others are queued in ROADMAP.md)")
    return ARCHS[key]


def list_archs() -> List[str]:
    return sorted(ARCHS)


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "list_archs"]
