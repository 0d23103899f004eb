"""0/1 knapsack for data placement (paper §3.1.3).

Items are data objects with value ``w`` (Eq. 5, seconds of predicted benefit)
and weight ``size_bytes``; capacity is the fast-tier budget.  Solved with
dynamic programming over a quantized capacity grid; falls back to
density-greedy when the DP table would be unreasonably large (the paper cites
an empirical O((log n)^2) specialization; DP is exact and fast at our n).

Items with non-positive value are never selected (moving them cannot help).

Three implementations share the algorithm:

* :func:`solve_arrays` — the production path: an array program over
  ``(values, sizes)`` ndarrays (no per-item ``Item`` boxing, which at
  10k-100k candidate chunks costs more than the solve itself).  The DP
  inner loop runs three fused numpy passes per item against a bit-packed
  keep table; with :data:`use_device` enabled and the problem at least
  :data:`_DEVICE_MIN_WORK` cells, the whole table recurrence runs on
  :data:`dp_device` instead (``kernels/knapsack_dp.py``: one kernel launch
  a solve on a card), and only the packed keep table comes back for the
  backtrack.  Selections are bit-identical to the reference.
* :func:`solve` — the :class:`Item`-sequence wrapper around
  :func:`solve_arrays` (the planner's historical entry point).
* :func:`solve_reference` — the pre-optimization implementation, kept as the
  oracle for value-equality property tests and the planner-latency
  benchmark's "before" measurement.

All are exact on the same quantized grid and return identical selections.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Item:
    name: str
    value: float        # w from Eq. (5); may be <= 0
    size_bytes: int


def _quantize(sizes: Sequence[int], capacity: int, max_cells: int) -> Tuple[np.ndarray, int]:
    """Pick a quantum so the DP has at most ``max_cells`` capacity cells.

    Sizes are rounded *up* (conservative: never overfills the fast tier)."""
    if capacity <= 0:
        return np.zeros(len(sizes), dtype=np.int64), 0
    quantum = max(1, int(np.ceil(capacity / max_cells)))
    qsizes = (np.asarray(sizes, dtype=np.int64) + quantum - 1) // quantum
    qcap = capacity // quantum
    return qsizes, qcap


# --------------------------------------------------------------------------
# The DP on a device (optional): the whole table recurrence as one call of
# ``ops.knapsack_dp`` (one kernel launch a solve on a card), the reference's
# jitted-scan switch ``use_jax`` under its own name (ROADMAP.md, queue 3,
# P14).  The per-item update is the same IEEE float64 add, compare and
# select, so the packed keep table, and the backtracked selection, are the
# numpy path's bits.
# --------------------------------------------------------------------------
_DEVICE_MIN_WORK = 8_000_000    # n * qcap below this: the numpy DP runs
#: opt-in switch for the DP on ``dp_device``.  Off by default, as the
#: reference's ``use_jax``: the simulator and the CPU tests run on machines
#: without a card.
use_device: bool = False
#: where the DP runs when :data:`use_device` is on; "cuda" needs a card
#: (no fallback to numpy without one), "cpu" runs the kernel's plain
#: version
dp_device: str = "cuda"


def _device_dp(values: np.ndarray, qsizes: np.ndarray, qcap: int
               ) -> np.ndarray:
    """Packed keep table from ``ops.knapsack_dp`` on :data:`dp_device`:
    the items to the device, one call, one copy of the table back."""
    import torch

    from ..kernels import ops
    dev = torch.device(dp_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "knapsack.use_device: dp_device is 'cuda' but no CUDA card is "
            "present (set use_device False, or dp_device 'cpu')")
    keep = ops.knapsack_dp(torch.from_numpy(values).to(dev),
                           torch.from_numpy(qsizes).to(dev), qcap)
    return keep.cpu().numpy()


def _numpy_dp(values: np.ndarray, qsizes: np.ndarray, qcap: int) -> np.ndarray:
    """Packed keep table from the in-process DP: three fused passes per
    item (add into a scratch buffer, compare into the keep row, masked
    copy back) and one vectorized pack at the end."""
    n = len(values)
    table = np.zeros(qcap + 1, dtype=np.float64)
    buf = np.empty(qcap + 1, dtype=np.float64)
    rows = np.zeros((n, qcap + 1), dtype=bool)
    for i in range(n):
        s, v = int(qsizes[i]), values[i]
        if s > qcap:
            continue
        m = qcap - s + 1
        cand = np.add(table[:m], v, out=buf[:m])
        better = np.greater(cand, table[s:], out=rows[i, s:])
        np.copyto(table[s:], cand, where=better)
    return np.packbits(rows, axis=1)


def solve_arrays(values: np.ndarray, sizes: np.ndarray, capacity_bytes: int,
                 *, max_cells: int = 1 << 14) -> np.ndarray:
    """Indices (into ``values``/``sizes``) of the selected items.

    The array-program core shared by :func:`solve`: selections are
    bit-identical to :func:`solve_reference` on the same inputs — the same
    quantized grid, the same item order through the DP (tie-breaks
    included), the same density-greedy fallback past the table-size cap."""
    values = np.asarray(values, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.int64)
    if capacity_bytes <= 0 or len(values) == 0:
        return np.empty(0, dtype=np.int64)
    pos_idx = np.flatnonzero((values > 0.0) & (sizes <= capacity_bytes))
    if len(pos_idx) == 0:
        return np.empty(0, dtype=np.int64)
    pvals, psizes = values[pos_idx], sizes[pos_idx]
    qsizes, qcap = _quantize(psizes, capacity_bytes, max_cells)
    if qcap <= 0:
        return np.empty(0, dtype=np.int64)
    n = len(pos_idx)
    if n * qcap > 50_000_000:   # DP too big -> density greedy
        return pos_idx[_greedy_arrays(pvals, psizes, capacity_bytes)]

    if use_device and n * qcap >= _DEVICE_MIN_WORK:
        keep = _device_dp(pvals, qsizes, qcap)
    else:
        keep = _numpy_dp(pvals, qsizes, qcap)
    # backtrack
    chosen: List[int] = []
    c = qcap
    for i in range(n - 1, -1, -1):
        if c >= 0 and (keep[i, c >> 3] >> (7 - (c & 7))) & 1:
            chosen.append(i)
            c -= int(qsizes[i])
    chosen.reverse()
    return pos_idx[np.asarray(chosen, dtype=np.int64)]


def _greedy_arrays(values: np.ndarray, sizes: np.ndarray,
                   capacity_bytes: int) -> np.ndarray:
    """Array-program :func:`_greedy`: a stable density argsort (ties keep
    input order, exactly like ``sorted(..., reverse=True)``), then a scan
    that stops early once nothing in the remaining suffix can fit."""
    density = values / np.maximum(sizes, 1)
    order = np.argsort(-density, kind="stable")
    ssizes = sizes[order]
    # smallest size at-or-after each position: once the remaining budget
    # drops below it, no later item fits and the scan can stop
    suffix_min = np.minimum.accumulate(ssizes[::-1])[::-1]
    out: List[int] = []
    used = 0
    budget = capacity_bytes
    for j in range(len(order)):
        if budget - used < suffix_min[j]:
            break
        s = int(ssizes[j])
        if used + s <= budget:
            out.append(int(order[j]))
            used += s
    return np.asarray(out, dtype=np.int64)


def solve(items: Sequence[Item], capacity_bytes: int,
          *, max_cells: int = 1 << 14) -> List[str]:
    """Return names of selected items maximizing total value under capacity.

    Identical selections to :func:`solve_reference`; thin wrapper over
    :func:`solve_arrays` (array callers should use that directly and skip
    the Item boxing)."""
    if not items:
        return []
    values = np.fromiter((it.value for it in items), dtype=np.float64,
                         count=len(items))
    sizes = np.fromiter((it.size_bytes for it in items), dtype=np.int64,
                        count=len(items))
    idx = solve_arrays(values, sizes, capacity_bytes, max_cells=max_cells)
    return [items[i].name for i in idx]


def solve_reference(items: Sequence[Item], capacity_bytes: int,
                    *, max_cells: int = 1 << 14) -> List[str]:
    """Pre-optimization solver (n x cells bool keep matrix) — the oracle the
    array-program :func:`solve_arrays` is property-tested against, and the
    baseline the planner-latency benchmark measures."""
    pos = [it for it in items if it.value > 0.0 and it.size_bytes <= capacity_bytes]
    if not pos or capacity_bytes <= 0:
        return []
    qsizes, qcap = _quantize([it.size_bytes for it in pos], capacity_bytes, max_cells)
    if qcap <= 0:
        return []
    n = len(pos)
    if n * qcap > 50_000_000:   # DP too big -> density greedy
        return _greedy(pos, capacity_bytes)

    values = np.array([it.value for it in pos], dtype=np.float64)
    table = np.zeros(qcap + 1, dtype=np.float64)
    keep = np.zeros((n, qcap + 1), dtype=bool)
    for i in range(n):
        s, v = int(qsizes[i]), values[i]
        if s > qcap:
            continue
        cand = table[: qcap - s + 1] + v
        better = cand > table[s:]
        table[s:] = np.where(better, cand, table[s:])
        keep[i, s:] = better
    chosen: List[str] = []
    c = qcap
    for i in range(n - 1, -1, -1):
        if c >= 0 and keep[i, c]:
            chosen.append(pos[i].name)
            c -= int(qsizes[i])
    chosen.reverse()
    return chosen


def _greedy(items: Sequence[Item], capacity_bytes: int) -> List[str]:
    """Value-density greedy (each object has distinct value per byte in
    practice, matching the paper's empirical-complexity remark)."""
    order = sorted(items, key=lambda it: it.value / max(it.size_bytes, 1),
                   reverse=True)
    out, used = [], 0
    for it in order:
        if used + it.size_bytes <= capacity_bytes:
            out.append(it.name)
            used += it.size_bytes
    return out


def total_value(items: Sequence[Item], chosen: Sequence[str]) -> float:
    by = {it.name: it for it in items}
    return sum(by[c].value for c in chosen)


def total_size(items: Sequence[Item], chosen: Sequence[str]) -> int:
    by = {it.name: it for it in items}
    return sum(by[c].size_bytes for c in chosen)
