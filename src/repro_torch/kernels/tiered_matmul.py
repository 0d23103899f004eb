"""``y = x @ w`` with an fp32 accumulator: the wrapper around
``csrc/tiered_matmul.cu`` and its plain PyTorch version.

Port of the reference package's Pallas kernel (``kernels/tiered_matmul.py``).
On a CUDA tensor the wrapper launches the kernel, once a call, or raises;
only a CPU tensor takes :func:`tiered_matmul_plain`.

Two routes, by :func:`route`:

- ``"mma"``: bf16 whose weight rows TMA can describe (N a multiple of 8,
  w 16-byte aligned) -- every serving shape.  Weight tiles stream through
  a TMA/mbarrier ring into tensor-core products; K is split across the
  blocks of one cluster, merged in the kernel.
- ``"ffma"``: fp32 (2e-5 rules out TF32), and bf16 that TMA cannot
  describe.  FFMA, with the same in-cluster K merge.

:func:`plan` sizes the grid to the card from its SM count.

:func:`tiered_matmul_experts` is the expert route of the same kernels
(MoE decode): row r of x times ``w[expert[r]]`` for a stack of E weights,
the rows grouped by expert on the device inside the one launch, so that
only the experts some row picks are read.  Its plain version is
:func:`tiered_matmul_experts_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

#: launches of the CUDA kernel since the last reset
launches = 0
#: launches of its expert route since the last reset
expert_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"ffma": 0, "mma": 1}
_MAX_SPLIT = 8              # blocks of a cluster (the portable size)
# the "mma" kernel: columns of a tile, rows of K a ring stage, stages, rows
# of x a block, the row stride of its window of x, and the shared memory
# an SM offers (232,448 bytes a block at most; 1 KB reserved a block)
_BN, _BK, _STAGES, _M_ROWS, _X_LD = 128, 64, 4, 8, 2048 + 8
_SMEM_PER_SM, _SMEM_RESERVED = 233_472, 1024
# a K split is doubled while each of its blocks keeps this many stages
_LONG_SPLIT = 16
# the "ffma" kernel's block tile
_FFMA_COLS, _FFMA_ROWS = 256, 4
# experts the expert route's kernels count in shared memory
_MAX_EXPERTS = 1024

#: plain version: both inputs cast to fp32, result in x's dtype
tiered_matmul_plain = ref.tiered_matmul_ref


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """``"mma"`` for bf16 when N is a multiple of 8 and w is 16-byte
    aligned (a TMA tensor map describes its rows), else ``"ffma"``."""
    if (x.dtype == torch.bfloat16 and w.shape[1] % 8 == 0
            and w.data_ptr() % 16 == 0):
        return "mma"
    return "ffma"


def mma_smem_bytes() -> int:
    """Dynamic shared memory of a block of the "mma" kernel: 1024 of
    alignment, the ring, the window of x, the 8 x 128 fp32 partial and the
    ring's mbarriers (``kTcSmem`` in the source)."""
    return (1024 + _STAGES * _BK * 2 * _BN + _M_ROWS * _X_LD * 2
            + _M_ROWS * _BN * 4 + 2 * _STAGES * 8)


def blocks_per_sm() -> int:
    """Blocks of the "mma" kernel one SM holds, by shared memory."""
    return _SMEM_PER_SM // (mma_smem_bytes() + _SMEM_RESERVED)


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, route_: str, sms: int):
    """(n_split, k_chunk) of one call on a card of ``sms`` SMs: n_split
    blocks of k_chunk rows cover K, none empty, n_split <= 8 (the blocks of
    one cluster).

    ``"mma"`` (128-column tiles, whole 64-row stages): the smallest split
    (1, 2, 4, 8) whose grid gives 95 % of the SMs a block, doubled while
    each block keeps at least 16 stages and the grid stays one wave of the
    blocks the SMs hold.  Measured on an H100 at the serving shapes, more
    blocks than that stream no faster (their stages are fewer and each
    block pays its ring's fill and the merge), and long splits gain from a
    second block on the SM.  ``"ffma"``: splits of K that bring the 256 x 4
    tiles to about two blocks an SM, at least 64 rows each."""
    if route_ == "mma":
        k_tiles = -(-K // _BK)
        tiles = -(-N // _BN) * -(-M // _M_ROWS)
        n_split = 1
        while n_split < min(_MAX_SPLIT, k_tiles) and tiles * n_split < 0.95 * sms:
            n_split *= 2
        while (2 * n_split <= min(_MAX_SPLIT, k_tiles)
               and k_tiles >= 2 * n_split * _LONG_SPLIT
               and tiles * 2 * n_split <= sms * blocks_per_sm()):
            n_split *= 2
        per = -(-k_tiles // min(n_split, k_tiles))
        return -(-k_tiles // per), per * _BK
    tiles = -(-N // _FFMA_COLS) * -(-M // _FFMA_ROWS)
    want = max(1, min(_MAX_SPLIT, -(-2 * sms // tiles), -(-K // 64)))
    k_chunk = -(-(-(-K // want)) // 8) * 8
    return -(-K // k_chunk), k_chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tiered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K); w: (K, N) -> (M, N) in x's dtype.  Any M, N, K: the
    kernel masks every edge, nothing is padded.  One launch a call."""
    global launches
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tiered_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not multiply")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError("tiered_matmul: x and w must share one dtype, "
                        f"float32 or bfloat16 (got {x.dtype}, {w.dtype})")
    if x.device != w.device:
        raise ValueError("tiered_matmul: x and w on different devices")
    if x.device.type == "cpu":
        return tiered_matmul_plain(x, w)
    if not x.is_cuda:
        raise ValueError(f"tiered_matmul: unsupported device {x.device}")
    if not w.is_contiguous():
        raise ValueError("tiered_matmul: w must be contiguous (K, N)")
    x = x.contiguous()
    M, K = x.shape
    N = w.shape[1]
    r = route(x, w)
    n_split, k_chunk = plan(M, N, K, r, _sm_count(x.device.index))
    if r == "mma":      # x rows read 16 bytes at a time
        vec = K % 8 == 0 and x.data_ptr() % 16 == 0
    else:               # w rows read 8 elements at a time
        vec = N % 8 == 0 and w.data_ptr() % 16 == 0
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _bind()(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K,
                  _ROUTES[r], n_split, k_chunk, int(vec),
                  _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiered_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y


def _bind():
    fn = build.load("tiered_matmul").tiered_matmul_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 3 + [I] * 8 + [P]
        fn.restype = ctypes.c_int
    return fn


def tiered_matmul_experts_plain(x: torch.Tensor, w: torch.Tensor,
                                expert: torch.Tensor) -> torch.Tensor:
    """Row r of x times ``w[expert[r]]``, both cast to fp32, in x's dtype:
    each routed expert's rows as one product (the same sums as row by
    row)."""
    e = expert.long()
    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    xf = x.float()
    for i in torch.unique(e).tolist():
        rows = (e == i).nonzero()[:, 0]
        out[rows] = xf[rows] @ w[i].float()
    return out.to(x.dtype)


def tiered_matmul_experts(x: torch.Tensor, w: torch.Tensor,
                          expert: torch.Tensor) -> torch.Tensor:
    """x: (R, K); w: (E, K, N); expert: (R,) int32, each in [0, E) ->
    (R, N) in x's dtype, row r = x[r] @ w[expert[r]] with an fp32
    accumulator.  One launch a call, no host synchronisation: the kernel
    groups the rows by expert itself and reads only the experts they pick
    (an index outside [0, E) makes the kernel trap).  E <= 1024."""
    global expert_launches
    if (x.dim() != 2 or w.dim() != 3 or expert.dim() != 1
            or x.shape[1] != w.shape[1] or expert.shape[0] != x.shape[0]):
        raise ValueError(f"tiered_matmul_experts: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and expert {tuple(expert.shape)}"
                         " do not fit (R, K), (E, K, N), (R,)")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError("tiered_matmul_experts: x and w must share one "
                        f"dtype, float32 or bfloat16 (got {x.dtype}, "
                        f"{w.dtype})")
    if expert.dtype != torch.int32:
        raise TypeError("tiered_matmul_experts: expert must be int32 (got "
                        f"{expert.dtype})")
    if not x.device == w.device == expert.device:
        raise ValueError("tiered_matmul_experts: x, w and expert on "
                         "different devices")
    if x.device.type == "cpu":
        return tiered_matmul_experts_plain(x, w, expert)
    if not x.is_cuda:
        raise ValueError(f"tiered_matmul_experts: unsupported device "
                         f"{x.device}")
    if not w.is_contiguous():
        raise ValueError("tiered_matmul_experts: w must be contiguous "
                         "(E, K, N)")
    E, K, N = w.shape
    if E > _MAX_EXPERTS:
        raise ValueError(f"tiered_matmul_experts: {E} experts, at most "
                         f"{_MAX_EXPERTS}")
    x, expert = x.contiguous(), expert.contiguous()
    R = x.shape[0]
    r = route(x, w[0])      # every expert's weight aligned as the first
    n_split, k_chunk = plan(_expert_rows(R, E, r), N, K, r,
                            _sm_count(x.device.index))
    if r == "mma":
        vec = K % 8 == 0 and x.data_ptr() % 16 == 0
    else:
        vec = N % 8 == 0 and w.data_ptr() % 16 == 0
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    err = _bind_experts()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                          expert.data_ptr(), R, N, K, E, _ROUTES[r],
                          n_split, k_chunk, int(vec), _DTYPES[x.dtype],
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiered_matmul_experts kernel launch failed: "
                           f"CUDA error {err}")
    expert_launches += 1
    return y


def _expert_rows(R: int, E: int, route_: str) -> int:
    """The rows :func:`plan` sizes the expert route's grid for: one tile
    of the route's rows for each expert the R rows can pick (the experts
    they do pick are known only on the device)."""
    return (_M_ROWS if route_ == "mma" else _FFMA_ROWS) * min(R, E)


def _bind_experts():
    fn = build.load("tiered_matmul").tiered_matmul_experts_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 4 + [I] * 9 + [P]
        fn.restype = ctypes.c_int
    return fn
