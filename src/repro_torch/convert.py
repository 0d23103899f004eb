"""Carry the reference package's parameters across, bit for bit.

``params_from_numpy(tree)`` takes the reference's parameter tree as numpy
arrays (``jax.device_get(params)``) and returns the port's dict of
tensors.  bfloat16 arrays arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so they travel through a ``uint16`` view.
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
    """Nested dicts (and lists/tuples) of numpy arrays -> the same structure
    of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)
