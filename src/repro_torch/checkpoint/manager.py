"""Checkpointing: atomic and asynchronous, in the reference package's
on-disk format, so checkpoints move between the two packages.

* **format** -- ``step_N/arrays.npz`` holds every leaf as raw bytes under
  its ``/``-joined key path with ``/`` written ``__``; ``meta.json`` holds
  the step and each leaf's shape and numpy dtype name (``bfloat16`` for
  bfloat16, whose bytes travel as uint16 here, so no numpy extension type
  is needed).
* **atomic** -- writes go to ``step_N.tmp/`` and are renamed when
  complete; a crash mid-write never corrupts the latest checkpoint.
* **async** -- :meth:`CheckpointManager.save` copies the tensors to host
  memory and a background thread writes them; the training loop blocks
  only on the previous save.
* **elastic** -- leaves are saved as whole logical tensors;
  :meth:`CheckpointManager.restore` places each onto a device or, as a
  DTensor, onto any mesh's placements (different DP/TP extent), which is
  what lets a job resume after losing a slice of the fleet.  Each rank
  reads the whole file and keeps its own slice (ROADMAP P20).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "",
             is_leaf: Callable[[Any], bool] = lambda _: False
             ) -> Dict[str, Any]:
    out = {}
    if is_leaf(tree):
        out[prefix[:-1]] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/", is_leaf))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/", is_leaf))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(raw bytes as uint8, numpy dtype name) of a tensor."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().reshape(-1).view(np.uint8), \
            "bfloat16"
    a = t.numpy()
    return a.reshape(-1).view(np.uint8), str(a.dtype)


def _from_host(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape).copy())


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        """Snapshot ``state`` (nested dicts of tensors) at ``step``."""
        self.wait()                       # at most one save in flight
        flat = {k: v for k, v in _flatten(state).items()
                if isinstance(v, torch.Tensor)}
        host, meta = {}, {"step": step, "leaves": {}}
        for k, v in flat.items():
            host[k], dtype = _to_host(v)
            meta["leaves"][k] = {"shape": list(v.shape), "dtype": dtype}

        def work():
            try:
                tmp = os.path.join(self.directory, f"step_{step}.tmp")
                final = os.path.join(self.directory, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{k.replace("/", "__"): v for k, v in host.items()})
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.isdir(final):          # re-save of same step
                    shutil.rmtree(final)
                os.replace(tmp, final)            # atomic publish
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, shardings: Any = None,
                device="cuda") -> Tuple[int, Any]:
        """Load a checkpoint.  ``shardings`` (optional) mirrors the state;
        each of its leaves is a ``torch.device`` or a ``(DeviceMesh,
        placements)`` pair (``distributed.sharding.shardings``), which makes
        the leaf a DTensor holding this rank's slice: elastic restore onto
        another topology.  A leaf it does not name goes to ``device``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        data = np.load(os.path.join(path, "arrays.npz"))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        flat_sh = (_flatten(shardings, is_leaf=_is_sharding)
                   if shardings is not None else {})
        placed = {}
        for raw_key in data.files:
            k = raw_key.replace("__", "/")
            info = meta["leaves"][k]
            v = _from_host(data[raw_key], info["dtype"], info["shape"])
            placed[k] = _place(v, flat_sh.get(k, torch.device(device)))
        return step, _unflatten(placed)


def _is_sharding(x: Any) -> bool:
    return isinstance(x, torch.device) or (
        isinstance(x, tuple) and len(x) == 2
        and hasattr(x[0], "mesh_dim_names"))           # (DeviceMesh, ...)


def _place(v: torch.Tensor, sharding: Any) -> torch.Tensor:
    """``v`` on a device, or this rank's slice of it as a DTensor: cut on
    the host, then moved (every rank loaded the same tensor, so no rank
    sends any other a byte).  A tensor dim sharded over several mesh dims
    is split over them in the mesh's order, as DTensor splits it."""
    if isinstance(sharding, torch.device):
        return v.to(sharding)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, placements = sharding
    coord = mesh.get_coordinate()
    local = v
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(v.shape)} does not "
                                 f"split {n} ways")
            size = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[i] * size, size)
        elif not isinstance(p, Replicate):
            raise ValueError(f"restore places Shard or Replicate, not {p}")
    return DTensor.from_local(local.contiguous().to(mesh.device_type), mesh,
                              list(placements), run_check=False)
