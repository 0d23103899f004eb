"""Architecture config registry.

Ported so far: gemma-2b, zamba2-1.2b, yi-6b, chatglm3-6b and xlstm-350m;
the reference package's other five architectures are queued in ROADMAP.md
(queue 1: "The moe family and the other five configs")."""

from typing import Dict, List

from .base import ArchConfig, ShapeConfig, SHAPES
from .chatglm3_6b import CONFIG as CHATGLM3_6B
from .gemma_2b import CONFIG as GEMMA_2B
from .xlstm_350m import CONFIG as XLSTM_350M
from .yi_6b import CONFIG as YI_6B
from .zamba2_1p2b import CONFIG as ZAMBA2_1P2B

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [
    ZAMBA2_1P2B, YI_6B, GEMMA_2B, CHATGLM3_6B, XLSTM_350M]}

# short aliases for --arch flags
ALIASES = {"zamba2-1.2b": "zamba2-1.2b", "zamba2": "zamba2-1.2b",
           "yi-6b": "yi-6b", "yi": "yi-6b",
           "gemma-2b": "gemma-2b", "gemma": "gemma-2b",
           "chatglm3-6b": "chatglm3-6b", "chatglm3": "chatglm3-6b",
           "xlstm-350m": "xlstm-350m", "xlstm": "xlstm-350m"}


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
