"""The knapsack DP's table recurrence: the wrapper around
``csrc/knapsack_dp.cu`` and its plain PyTorch version.

The planner's 0/1 knapsack (``core/knapsack.py``, paper §3.1.3) runs over
a quantized capacity grid of ``qcap + 1`` cells.  For each item i in
order, with the table starting at 0.0:

  cand[c]   = table[c - s_i] + v_i      (c >= s_i)
  better[c] = cand[c] > table[c]        (strict: ties keep the old value)
  table[c]  = better ? cand : table[c]

and row i of the keep table is ``better``, packed as ``np.packbits`` packs
it (column c is bit 7 - (c & 7) of byte c >> 3).  An item with s_i > qcap
(or s_i < 0) leaves the table unchanged and its row 0.  The reference
package runs this as one jitted ``lax.scan`` in float64 (its
``core/knapsack.py`` ``_jax_dp``); here it is one kernel launch a solve on
a card, and on the CPU a per-item loop of torch ops in float64.  Both
give the same bits as the reference's numpy and jitted DPs.

On a CUDA tensor :func:`knapsack_dp` launches the kernel or raises; only
a CPU tensor takes :func:`knapsack_dp_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import record
from . import build

#: launches of the kernel since the last reset
launches = 0

#: the largest grid (qcap + 1 cells) whose table the kernel keeps in
#: shared memory (route 1); past it the table lives in global memory
#: (route 2).  As ``kRoute1Cells`` in the source.
ROUTE1_CELLS = 1024 * 17
_PACK = (128, 64, 32, 16, 8, 4, 2, 1)


def row_bytes(qcap: int) -> int:
    """Bytes of one packed keep row: ``qcap + 1`` bits, padded to bytes."""
    return (qcap + 8) // 8


def pick_route(qcap: int) -> int:
    """The kernel's route for a grid of ``qcap + 1`` cells: 1 (the table
    in shared memory) or 2 (in global memory)."""
    return 1 if qcap + 1 <= ROUTE1_CELLS else 2


def knapsack_dp_plain(values: torch.Tensor, qsizes: torch.Tensor,
                      qcap: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float64: the keep table
    (n, ``row_bytes(qcap)``) uint8 on the inputs' device, packed by a
    multiply-sum against [128, ..., 1]."""
    n = values.shape[0]
    dev = values.device
    table = torch.zeros(qcap + 1, dtype=torch.float64, device=dev)
    rows = torch.zeros((n, row_bytes(qcap) * 8), dtype=torch.bool,
                       device=dev)
    for i, s in enumerate(qsizes.tolist()):      # one copy to the host
        if s < 0 or s > qcap:
            continue
        old = table[s:]
        cand = table[:qcap + 1 - s] + values[i]
        better = cand > old
        rows[i, s:qcap + 1] = better
        table[s:] = torch.where(better, cand, old)
    weights = torch.tensor(_PACK, dtype=torch.uint8, device=dev)
    return (rows.view(n, -1, 8).to(torch.uint8) * weights).sum(
        -1, dtype=torch.uint8)


def _check(values: torch.Tensor, qsizes: torch.Tensor, qcap: int) -> None:
    if values.dtype != torch.float64 or qsizes.dtype != torch.int64:
        raise ValueError("knapsack_dp: values float64 and qsizes int64 (got "
                         f"{values.dtype}, {qsizes.dtype})")
    if values.dim() != 1 or qsizes.shape != values.shape:
        raise ValueError("knapsack_dp: values and qsizes of one shape (n,) "
                         f"(got {tuple(values.shape)}, {tuple(qsizes.shape)})")
    if values.device != qsizes.device:
        raise ValueError("knapsack_dp: values and qsizes on different "
                         "devices")
    if qcap < 0:
        raise ValueError(f"knapsack_dp: qcap {qcap} must be >= 0")


@record.kernel(lambda values, qsizes, qcap, route=None, *, out:
               ((values, qsizes), (out,)))
def knapsack_dp(values: torch.Tensor, qsizes: torch.Tensor, qcap: int,
                route: Optional[int] = None) -> torch.Tensor:
    """The packed keep table (n, ``row_bytes(qcap)``) uint8 of the DP over
    ``values`` (n,) float64 and ``qsizes`` (n,) int64, on their device.
    ``route`` (1 or 2) forces a route of the kernel; by default the grid
    picks it (:func:`pick_route`)."""
    global launches
    _check(values, qsizes, qcap)
    if values.device.type == "cpu":
        return knapsack_dp_plain(values, qsizes, qcap)
    if not values.is_cuda:
        raise ValueError(f"knapsack_dp: unsupported device {values.device}")
    lib = build.load("knapsack_dp")
    launch = _bind(lib)
    r = pick_route(qcap) if route is None else route
    values, qsizes = values.contiguous(), qsizes.contiguous()
    n = values.shape[0]
    keep = torch.empty((n, row_bytes(qcap)), dtype=torch.uint8,
                       device=values.device)
    words = lib.knapsack_dp_work(qcap, r)
    work = (torch.empty(words, dtype=torch.float64, device=values.device)
            if words else None)
    err = launch(values.data_ptr(), qsizes.data_ptr(), n, qcap,
                 keep.data_ptr(),
                 work.data_ptr() if work is not None else None, r,
                 torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knapsack_dp kernel launch failed (route {r}): "
                           f"CUDA error {err}")
    launches += 1
    return keep


def _bind(lib: ctypes.CDLL):
    fn = lib.knapsack_dp_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, P, P, I, P]
        fn.restype = ctypes.c_int
        lib.knapsack_dp_work.argtypes = [I, I]
        lib.knapsack_dp_work.restype = ctypes.c_longlong
    return fn
