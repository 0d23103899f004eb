"""``y = x @ w`` with an fp32 accumulator: the wrapper around
``csrc/tiered_matmul.cu`` and its plain PyTorch version.

Port of the reference package's Pallas kernel (``kernels/tiered_matmul.py``).
On a CUDA tensor the wrapper launches the kernel or raises; only a CPU
tensor takes :func:`tiered_matmul_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: launches of the CUDA kernel since the last reset
launches = 0

_COLS, _ROWS = 256, 4       # block tile of the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: plain version: both inputs cast to fp32, result in x's dtype
tiered_matmul_plain = ref.tiered_matmul_ref


def _split(M: int, N: int, K: int):
    """(k_chunk, n_split): split K when the (M, N) tiles alone would give
    fewer than about two blocks per SM, in chunks of at least 64 rows."""
    tiles = -(-N // _COLS) * -(-M // _ROWS)
    want = max(1, min(-(-264 // tiles), -(-K // 64)))
    k_chunk = -(-K // want)
    k_chunk = -(-k_chunk // 8) * 8
    return k_chunk, -(-K // k_chunk)


def tiered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K); w: (K, N) -> (M, N) in x's dtype.  Any M, N, K: the
    kernel masks every edge, nothing is padded."""
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
    k_chunk, n_split = _split(M, N, K)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    work = torch.empty((n_split, M, N) if n_split > 1 else (1,),
                       dtype=torch.float32, device=x.device)
    vec = int(N % 8 == 0 and w.data_ptr() % 16 == 0)
    err = _bind()(x.data_ptr(), w.data_ptr(), y.data_ptr(), work.data_ptr(),
                  M, N, K, k_chunk, n_split, vec, _DTYPES[x.dtype],
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
        fn.argtypes = [P] * 4 + [I] * 7 + [P]
        fn.restype = ctypes.c_int
    return fn
