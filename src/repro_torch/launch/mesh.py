"""Meshes: the production mesh's shape, and a device mesh over the ranks
this job has.

Counterpart of the reference package's ``launch/mesh.py``.  The production
mesh (one v5e pod of 256 chips, or two) holds more ranks than a job here
has, so :func:`make_production_mesh` returns an :class:`AbstractMesh`:
axis names and sizes with no devices, which is all the sharding rules and
the dry run's per-device bytes read (ROADMAP P17).  :func:`make_host_mesh`
builds a ``torch.distributed`` ``DeviceMesh`` with the reference's axes,
starting the process group if none is running.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices (as JAX's
    ``AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 (one v5e pod, 256 chips) or 2x16x16 (two pods, 512 chips)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _start_process_group(device: str) -> None:
    """Start the default process group unless one is running: NCCL for
    ``"cuda"``, gloo for ``"cpu"``; under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) from its environment, else a world of one through a
    local store.  Without NCCL or a card, ``"cuda"`` raises."""
    if dist.is_initialized():
        return
    if device == "cuda":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("make_host_mesh(device='cuda') needs a CUDA "
                               "card and NCCL; give device='cpu' for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_host_mesh(*, data: int = 1, model: int = 1,
                   device: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the first data x model ranks of the job,
    ``data`` and ``model`` clamped to the ranks there are as the
    reference's are to its devices."""
    _start_process_group(device)
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device, ranks, mesh_dim_names=("data", "model"))
