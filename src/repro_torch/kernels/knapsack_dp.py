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

The kernel has two routes (:func:`pick_route`).  Route 1 spreads the table
over a cluster of up to 16 blocks, one an SM (:func:`cluster_plan`): each
rank holds its columns' values in registers and two ping-pong buffers of
them in shared memory, reads ``table[c - s]`` from its own block or, where
c - s lies below its first column, from a rank below through distributed
shared memory (:func:`source`), and the ranks meet at one cross-SM
handshake an item (two mbarriers a block).  Route 2 keeps the table in
global memory, one block, for grids past what the cluster's shared memory
holds.

On a CUDA tensor :func:`knapsack_dp` launches the kernel or raises; only
a CPU tensor takes :func:`knapsack_dp_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import record
from . import build

#: launches of the kernel since the last reset
launches = 0

#: route 1's cluster: blocks (ranks) at most, threads a block at most (its
#: last warp only synchronises), and the shared memory a block may take on
#: an H100.  As ``kMaxRanks``, ``kMaxRankThreads`` and ``kMaxSmem`` in the
#: source.
MAX_RANKS = 16
MAX_RANK_THREADS = 1024
MAX_SMEM = 232_448
#: shared memory of a block's two mbarriers (``kBarBytes``)
BAR_BYTES = 16
#: a rank's columns at most: its two buffers of doubles beside the
#: mbarriers in MAX_SMEM, a multiple of 32
MAX_WIDTH = (MAX_SMEM - BAR_BYTES) // 16 // 32 * 32
#: the largest grid (qcap + 1 cells) whose table the kernel keeps in the
#: cluster's shared memory (route 1); past it the table lives in global
#: memory (route 2)
ROUTE1_CELLS = MAX_RANKS * MAX_WIDTH
#: the cells a rank takes by default (:func:`pick_ranks`): an item's
#: cross-SM handshake costs about the same at any cluster size, so the most
#: ranks that each have a few warps of columns are fastest (``chip_smoke.py``
#: times the sizes, PERF.md §6)
RANK_CELLS = 256
_PACK = (128, 64, 32, 16, 8, 4, 2, 1)


class ClusterPlan(NamedTuple):
    """Route 1's layout: ``ranks`` blocks in one cluster; rank r owns the
    columns [r * width, (r + 1) * width) (the last rank's may be fewer, or
    none); a block has ``threads`` threads, thread t < threads - 32 owning
    the columns j * (threads - 32) + t of its rank for j < ``cols``, the
    last warp only synchronising; ``smem`` bytes of shared memory a block
    (two mbarriers and two buffers of ``width`` doubles)."""
    ranks: int
    width: int
    threads: int
    cols: int
    smem: int


def _round32(x: int) -> int:
    return (x + 31) // 32 * 32


def row_bytes(qcap: int) -> int:
    """Bytes of one packed keep row: ``qcap + 1`` bits, padded to bytes."""
    return (qcap + 8) // 8


def pick_route(qcap: int) -> int:
    """The kernel's route for a grid of ``qcap + 1`` cells: 1 (the table
    in the shared memory of a cluster) or 2 (in global memory)."""
    return 1 if qcap + 1 <= ROUTE1_CELLS else 2


def pick_ranks(qcap: int) -> int:
    """Route 1's blocks by default: one for every RANK_CELLS cells, at
    most MAX_RANKS."""
    return max(1, min(MAX_RANKS, -(-(qcap + 1) // RANK_CELLS)))


def cluster_plan(qcap: int, ranks: Optional[int] = None) -> ClusterPlan:
    """Route 1's layout of ``qcap + 1`` cells over ``ranks`` blocks (by
    default :func:`pick_ranks`), as the kernel's ``layout`` computes it:
    width the cells a rank rounded up to 32, cols the fewest columns a
    thread that keep a block (its last warp included) within
    MAX_RANK_THREADS.  Raises ValueError where ``ranks`` is out of 1..16
    or a rank's buffers pass MAX_SMEM."""
    r = pick_ranks(qcap) if ranks is None else ranks
    if qcap < 0 or not 1 <= r <= MAX_RANKS:
        raise ValueError(f"knapsack_dp: ranks {r} out of 1..{MAX_RANKS} "
                         f"(qcap {qcap})")
    width = _round32(-(-(qcap + 1) // r))
    if width > MAX_WIDTH:
        raise ValueError(f"knapsack_dp: qcap {qcap} over {r} ranks needs "
                         f"{width} columns a rank, past {MAX_WIDTH}")
    cols = -(-width // (MAX_RANK_THREADS - 32))
    return ClusterPlan(r, width, _round32(-(-width // cols)) + 32, cols,
                       BAR_BYTES + 2 * width * 8)


def source(rank: int, col: int, s: int, width: int) -> Tuple[int, int]:
    """Where column ``col`` of rank ``rank`` reads ``table[c - s]``: (the
    rank, the column in it), as the kernel's ``relax`` computes it from d =
    s // width and rem = s % width; a rank below 0 where c < s."""
    d, rem = divmod(s, width)
    src, off = rank - d, col - rem
    if off < 0:
        src, off = src - 1, off + width
    return src, off


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


@record.kernel(lambda values, qsizes, qcap, route=None, ranks=None, *,
               out: ((values, qsizes), (out,)))
def knapsack_dp(values: torch.Tensor, qsizes: torch.Tensor, qcap: int,
                route: Optional[int] = None,
                ranks: Optional[int] = None) -> torch.Tensor:
    """The packed keep table (n, ``row_bytes(qcap)``) uint8 of the DP over
    ``values`` (n,) float64 and ``qsizes`` (n,) int64, on their device.
    ``route`` (1 or 2) forces a route of the kernel and ``ranks`` (1..16)
    route 1's cluster size; by default the grid picks them
    (:func:`pick_route`, :func:`pick_ranks`)."""
    global launches
    _check(values, qsizes, qcap)
    if ranks is not None and not 1 <= ranks <= MAX_RANKS:
        raise ValueError(f"knapsack_dp: ranks {ranks} out of 1..{MAX_RANKS}")
    if values.device.type == "cpu":
        return knapsack_dp_plain(values, qsizes, qcap)
    if not values.is_cuda:
        raise ValueError(f"knapsack_dp: unsupported device {values.device}")
    lib = build.load("knapsack_dp")
    launch = _bind(lib)
    r = pick_route(qcap) if route is None else route
    R = pick_ranks(qcap) if ranks is None else ranks
    values, qsizes = values.contiguous(), qsizes.contiguous()
    n = values.shape[0]
    keep = torch.empty((n, row_bytes(qcap)), dtype=torch.uint8,
                       device=values.device)
    words = lib.knapsack_dp_work(qcap, r)
    work = (torch.empty(words, dtype=torch.float64, device=values.device)
            if words else None)
    err = launch(values.data_ptr(), qsizes.data_ptr(), n, qcap,
                 keep.data_ptr(),
                 work.data_ptr() if work is not None else None, r, R,
                 torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knapsack_dp kernel launch failed (route {r}, "
                           f"{R} ranks): CUDA error {err}")
    launches += 1
    return keep


def kernel_layout(qcap: int, ranks: int) -> ClusterPlan:
    """Route 1's layout as the built kernel computes it (its C entry
    ``knapsack_dp_layout``), to hold :func:`cluster_plan` against on a
    card."""
    lib = build.load("knapsack_dp")
    _bind(lib)
    out = (ctypes.c_int * 4)()
    err = lib.knapsack_dp_layout(qcap, ranks, out)
    if err != 0:
        raise ValueError(f"knapsack_dp_layout({qcap}, {ranks}): CUDA error "
                         f"{err}")
    width, threads, cols, smem = out
    return ClusterPlan(ranks, width, threads, cols, smem)


def chain_floor(n: int, qcap: int, ranks: Optional[int] = None,
                device: Optional[torch.device] = None,
                cluster_barrier: bool = False) -> None:
    """Launch route 1's item loop with no table work (n items' cross-SM
    handshakes, as the DP does them) over the cluster the DP takes for
    ``qcap`` at ``ranks``, on the current stream of ``device``: the least a
    solve of n items can cost in this design.  ``cluster_barrier``: n
    ``barrier.cluster`` in their place, the handshake's alternative.  A
    check's aid; no planner path calls it, and it counts no launch."""
    lib = build.load("knapsack_dp")
    _bind(lib)
    R = pick_ranks(qcap) if ranks is None else ranks
    dev = device or torch.device("cuda", torch.cuda.current_device())
    err = lib.knapsack_dp_chain_launch(
        n, qcap, R, int(cluster_barrier),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knapsack_dp chain floor launch failed: CUDA "
                           f"error {err}")


def _bind(lib: ctypes.CDLL):
    fn = lib.knapsack_dp_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, P, P, I, I, P]
        fn.restype = ctypes.c_int
        lib.knapsack_dp_work.argtypes = [I, I]
        lib.knapsack_dp_work.restype = ctypes.c_longlong
        lib.knapsack_dp_layout.argtypes = [I, I, ctypes.POINTER(I)]
        lib.knapsack_dp_layout.restype = ctypes.c_int
        lib.knapsack_dp_chain_launch.argtypes = [I, I, I, I, P]
        lib.knapsack_dp_chain_launch.restype = ctypes.c_int
    return fn
