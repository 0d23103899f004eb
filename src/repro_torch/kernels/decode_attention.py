"""Single-token (decode) attention over a KV cache: the wrapper around
``csrc/decode_attention.cu`` and its plain PyTorch version.

Port of the reference package's Pallas kernel
(``kernels/decode_attention.py``).  On a CUDA tensor the wrapper launches
the kernel or raises; only a CPU tensor takes :func:`decode_attention_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

#: launches of the CUDA kernel since the last reset
launches = 0

_TILE = 32                  # rows per tile in the kernel
_MAX_G, _MAX_D = 16, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q dtype, cache dtype) pairs the kernel takes; an fp32 model reads a
#: bf16 cache, as the reference's serving path does
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rows at or past ``length``
    are never read, and ``length == 0`` gives zeros, as the TPU kernel
    does (the reference's naive oracle gives mean(v) there)."""
    if length == 0:
        return torch.zeros_like(q)
    return ref.decode_attention_ref(q, k[:, :, :length], v[:, :, :length],
                                    length)


def _check(q, k, v, length: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention: q (B,K,G,D), k and v (B,K,T,D)")
    B, K, G, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, K) or k.shape[3] != D:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not 0 <= length <= k.shape[2]:
        raise ValueError(f"decode_attention: length {length} outside "
                         f"[0, {k.shape[2]}]")
    if (k.dtype != v.dtype or (q.dtype, k.dtype) not in _PAIRS):
        raise TypeError("decode_attention: q, k, v must be float32 or "
                        "bfloat16, k and v alike, and q no narrower than k "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attention: q, k, v on different devices")


def _split_rows(batch_heads: int, length: int):
    """(n_split, rows_per_split): split the valid rows of each (b, k) into
    whole tiles, about two blocks per SM in all, at least one tile per
    split.  ``n_split * rows >= length``, and every split owns rows (one
    empty split when ``length == 0``)."""
    tiles = -(-length // _TILE)
    n_split = max(1, min(tiles, -(-264 // batch_heads)))
    rows = -(-max(tiles, 1) // n_split) * _TILE
    return max(1, -(-length // rows)), rows


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q: (B, K, G, D); k, v: (B, K, T, D), any strides with unit stride on
    D (the serving cache is passed as a strided view); ``length``: number
    of valid cache rows.  Returns (B, K, G, D) in q's dtype.  q may be
    float32 over a bfloat16 cache."""
    global launches
    length = int(length)
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, K, G, D = q.shape
    if G > _MAX_G or D > _MAX_D:
        raise ValueError(f"decode_attention: kernel takes G <= {_MAX_G} and "
                         f"D <= {_MAX_D} (got G={G}, D={D})")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: D must have unit stride")
    n_split, rows = _split_rows(B * K, length)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B * K, n_split, G, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * K, n_split, G, 2), dtype=torch.float32,
                          device=q.device)
    fn = _bind()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(),
             B, K, G, D, length, n_split, rows, 1.0 / math.sqrt(D),
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             _DTYPES[q.dtype], _DTYPES[k.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def _bind():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 6 + [I] * 7 + [ctypes.c_float] + [L] * 12
                       + [I, I, P])
        fn.restype = ctypes.c_int
    return fn
