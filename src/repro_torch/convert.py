"""Carry the reference package's trees across, bit for bit.

``params_from_numpy(tree)`` takes any of the reference's trees as numpy
arrays (``jax.device_get(tree)``) -- parameters, or the optimizer state
with its int32 scalar ``step``, int8 ``{"q", "s"}`` moments and bfloat16
moments -- and returns the same structure of tensors.  bfloat16 arrays
arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects, so
they travel through a ``uint16`` view.  Checkpoints cross between the
packages on disk (:mod:`.checkpoint`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    a = np.array(a, copy=True, order="C")     # owned and writable
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts (and lists/tuples) of numpy arrays, scalars included
    -> the same structure of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)
