"""Hand-written CUDA kernels for sm_90a (``csrc/``) with their plain PyTorch
versions.  Ported so far: ``decode_attention`` and ``tiered_matmul``; the
reference package's ``flash_attention`` and ``ssd_scan`` are queued in
ROADMAP.md (queue 2).  Callers go through :mod:`.ops`."""

from . import ops, ref

__all__ = ["ops", "ref"]
