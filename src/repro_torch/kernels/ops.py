"""The kernel entry points the model calls, and their launch counts.

Each entry point launches its hand-written CUDA kernel on a CUDA tensor
(or raises) and runs its plain PyTorch version on a CPU tensor; there is no
fallback from one to the other.  Unlike the reference package's ``ops``,
nothing is padded: the kernels mask their own edges.
"""

from __future__ import annotations

from typing import Dict

from . import decode_attention as _da
from . import tiered_matmul as _mm

decode_attention = _da.decode_attention
tiered_matmul = _mm.tiered_matmul

_MODULES = {"decode_attention": _da, "tiered_matmul": _mm}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
