"""The kernel entry points the model calls, and their launch counts.

Each entry point launches its hand-written CUDA kernel on a CUDA tensor
(or raises) and runs its plain PyTorch version on a CPU tensor; there is no
fallback from one to the other.  Unlike the reference package's ``ops``,
nothing is padded: the kernels mask their own edges.
"""

from __future__ import annotations

from typing import Dict

from . import decode_attention as _da
from . import flash_attention as _fa
from . import knapsack_dp as _kn
from . import ssd_scan as _ssd
from . import tiered_matmul as _mm

decode_attention = _da.decode_attention
tiered_matmul = _mm.tiered_matmul
tiered_matmul_experts = _mm.tiered_matmul_experts
flash_attention = _fa.flash_attention
ssd_scan = _ssd.ssd_scan
knapsack_dp = _kn.knapsack_dp

#: counter name -> (module, attribute holding its launches)
_COUNTERS = {"decode_attention": (_da, "launches"),
             "decode_attention_e4m3": (_da, "e4m3_launches"),
             "tiered_matmul": (_mm, "launches"),
             "tiered_matmul_experts": (_mm, "expert_launches"),
             "flash_attention": (_fa, "launches"),
             "flash_attention_bwd": (_fa, "bwd_launches"),
             "ssd_scan": (_ssd, "launches"),
             "ssd_scan_bwd": (_ssd, "bwd_launches"),
             "knapsack_dp": (_kn, "launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
