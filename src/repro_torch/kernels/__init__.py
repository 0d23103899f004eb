"""Hand-written CUDA kernels for sm_90a (``csrc/``) with their plain PyTorch
versions: ``decode_attention``, ``tiered_matmul``, ``flash_attention``
and ``ssd_scan`` (every Pallas kernel of the reference package), the last
two with their gradients.  Callers go through :mod:`.ops`."""

from . import ops, ref

__all__ = ["ops", "ref"]
