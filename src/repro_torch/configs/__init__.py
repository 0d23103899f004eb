"""Architecture config registry: the reference package's 10 architectures,
under the same names and aliases."""

from typing import Dict, List

from .base import ArchConfig, ShapeConfig, SHAPES
from .chatglm3_6b import CONFIG as CHATGLM3_6B
from .dbrx_132b import CONFIG as DBRX_132B
from .gemma_2b import CONFIG as GEMMA_2B
from .moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from .musicgen_large import CONFIG as MUSICGEN_LARGE
from .nemotron4_340b import CONFIG as NEMOTRON4_340B
from .phi3_vision_4p2b import CONFIG as PHI3_VISION_4P2B
from .xlstm_350m import CONFIG as XLSTM_350M
from .yi_6b import CONFIG as YI_6B
from .zamba2_1p2b import CONFIG as ZAMBA2_1P2B

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [
    ZAMBA2_1P2B, PHI3_VISION_4P2B, NEMOTRON4_340B, YI_6B, GEMMA_2B,
    CHATGLM3_6B, MOONSHOT_V1_16B_A3B, DBRX_132B, MUSICGEN_LARGE,
    XLSTM_350M]}

# short aliases for --arch flags
ALIASES = {"zamba2-1.2b": "zamba2-1.2b", "zamba2": "zamba2-1.2b",
           "phi-3-vision-4.2b": "phi-3-vision-4.2b",
           "phi3v": "phi-3-vision-4.2b",
           "nemotron-4-340b": "nemotron-4-340b",
           "nemotron": "nemotron-4-340b",
           "yi-6b": "yi-6b", "yi": "yi-6b",
           "gemma-2b": "gemma-2b", "gemma": "gemma-2b",
           "chatglm3-6b": "chatglm3-6b", "chatglm3": "chatglm3-6b",
           "moonshot-v1-16b-a3b": "moonshot-v1-16b-a3b",
           "moonshot": "moonshot-v1-16b-a3b",
           "dbrx-132b": "dbrx-132b", "dbrx": "dbrx-132b",
           "musicgen-large": "musicgen-large", "musicgen": "musicgen-large",
           "xlstm-350m": "xlstm-350m", "xlstm": "xlstm-350m"}


def get_config(name: str) -> ArchConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


def list_archs() -> List[str]:
    return sorted(ARCHS)


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "list_archs"]
