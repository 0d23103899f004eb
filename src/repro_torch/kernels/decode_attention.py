"""Single-token (decode) attention over a KV cache: the wrapper around
``csrc/decode_attention.cu`` and its plain PyTorch version.

Port of the reference package's Pallas kernel
(``kernels/decode_attention.py``).  On a CUDA tensor the wrapper launches
the kernel or raises; only a CPU tensor takes :func:`decode_attention_plain`.
The cache may be float32, bfloat16 or fp8 e4m3 (``torch.float8_e4m3fn``,
the kernel's e4m3 route, counted in ``e4m3_launches``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import record
from . import build, ref

#: launches of the CUDA kernel over a float32 or bfloat16 cache since the
#: last reset
launches = 0
#: launches of its e4m3 route (an fp8 cache) since the last reset
e4m3_launches = 0

_HEADS = 8                  # query heads a block takes at most
_STAGES = 8                 # steps in each warp's cp.async ring
_E4M3_SPLIT = 64            # rows an e4m3 split takes at least
_WARPS = 4                  # warps of a block
_MAX_SPLIT = 8              # blocks of a cluster (the portable size)
_TARGET_BLOCKS = 264        # two blocks per SM of an H100 (132 SMs)
_MAX_G, _MAX_D = 16, 256
E4M3 = torch.float8_e4m3fn
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, E4M3: 2}
#: (q dtype, cache dtype) pairs the kernel takes; an fp32 model reads a
#: bf16 cache, as the reference's serving path does, and either reads an
#: e4m3 one (the reference's kv_dtype=float8_e4m3fn)
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16), (torch.float32, E4M3),
          (torch.bfloat16, E4M3)}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rows at or past ``length``
    are never read, and ``length == 0`` gives zeros, as the TPU kernel
    does (the reference's naive oracle gives mean(v) there).  An e4m3
    cache is dequantized with ``.float()``, its NaN encoding to NaN."""
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
        raise TypeError("decode_attention: q float32 or bfloat16; k and v "
                        "alike, float32, bfloat16 or float8_e4m3fn, and no "
                        f"wider than q (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attention: q, k, v on different devices")


def _rows_per_step(D: int, elsize: int) -> int:
    """Cache rows one warp covers at once: 32 lanes, as many to a row as
    the row has 16-byte chunks (at most 32)."""
    chunks, lanes = D * elsize // 16, 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    return 32 // lanes


def _heads_per_block(G: int, elsize: int) -> int:
    """Query heads one block takes: all G of a KV head, so that each K and
    V row a block loads serves every one of them.  Over a float32 or
    bfloat16 cache 1, 2, 4 or 8: at G = 16 two blocks take 8 heads each
    and read each row once apiece (the second read finds it in L2), since
    16 heads' q and acc would not fit a lane's registers.  Over an e4m3
    cache (``elsize`` 1) one block takes every head up to 16, in 8 or 16
    head slots of the tensor-core products."""
    if elsize == 1:
        return 8 if G <= 8 else 16
    heads = 1
    while heads < min(G, _HEADS):
        heads *= 2
    return heads


def _split_rows(groups: int, heads: int, D: int, elsize: int, length: int):
    """(n_split, rows_per_split): the valid rows of each of ``groups``
    (b, k, group of ``heads`` heads) split over the blocks of one cluster.
    Enough blocks to cover the SMs twice, and no split longer than its
    warps hold in flight at once (7 steps each); but at least 2 * heads
    rows a split (each block's partial, heads x D in fp32, is read again in
    the merge) and a step per warp, at most 8 splits.  Over an e4m3 cache
    one split a 64 rows, at most 8.
    Every split owns rows; one empty split when ``length == 0``."""
    if length == 0:
        return 1, 1
    if elsize == 1:
        n = min(_MAX_SPLIT, -(-length // _E4M3_SPLIT))
    else:
        step = _rows_per_step(D, elsize)
        in_flight = _WARPS * (_STAGES - 1) * step
        n = max(-(-_TARGET_BLOCKS // groups), -(-length // in_flight))
        n = min(n, _MAX_SPLIT, max(1, length // max(2 * heads, _WARPS * step)))
    rows = -(-length // n)
    return -(-length // rows), rows


def _check_cuda(q, k, v) -> None:
    """What the kernel takes: G <= 16, D <= 256, and K and V rows it can
    read in 16-byte pieces (an e4m3 row: D a multiple of 16)."""
    B, K, G, D = q.shape
    if G > _MAX_G or D > _MAX_D:
        raise ValueError(f"decode_attention: kernel takes G <= {_MAX_G} and "
                         f"D <= {_MAX_D} (got G={G}, D={D})")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: D must have unit stride")
    vec = 16 // k.element_size()
    if (D % vec or any(t.data_ptr() % 16 for t in (k, v))
            or any(t.stride(i) % vec for t in (k, v) for i in range(3))):
        raise ValueError("decode_attention: the kernel reads K and V rows in "
                         "16-byte pieces: D, the cache strides and its "
                         f"address must be multiples of {vec} elements")


def _operands(q, k, v, length, *, out):
    """What a call reads (q and the cache's first ``length`` rows) and
    writes, for an installed recorder."""
    length = int(length)
    return (q, k[:, :, :length], v[:, :, :length]), (out,)


@record.kernel(_operands)
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q: (B, K, G, D); k, v: (B, K, T, D), any strides with unit stride on
    D (the serving cache is passed as a strided view); ``length``: number
    of valid cache rows.  Returns (B, K, G, D) in q's dtype.  q may be
    float32 over a bfloat16 cache, and either over an e4m3 one.  One
    kernel launch a call."""
    global launches, e4m3_launches
    length = int(length)
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_cuda(q, k, v)
    B, K, G, D = q.shape
    heads = _heads_per_block(G, k.element_size())
    n_split, rows = _split_rows(B * K * -(-G // heads), heads, D,
                                k.element_size(), length)
    # q read by 16-byte loads where its rows allow it
    per = 16 // q.element_size()
    q_vec = int(q.data_ptr() % 16 == 0
                and all(q.stride(i) % per == 0 for i in range(3)))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, K, G, D, length, n_split, rows, heads, q_vec,
                  1.0 / math.sqrt(D),
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  out.stride(0), out.stride(1), out.stride(2),
                  _DTYPES[q.dtype], _DTYPES[k.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    if k.dtype == E4M3:
        e4m3_launches += 1
    else:
        launches += 1
    return out


def fill_shared_memory_nan(device: torch.device) -> None:
    """Fill the shared memory of every SM of ``device`` with NaN, on its
    current stream: a kernel launched next gives NaN wherever it reads
    shared memory it did not write first.  A check's aid; no serving or
    training path calls it, and it counts no launch."""
    fn = build.load("decode_attention").decode_attention_fill_shared_nan
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    err = fn(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fill_shared_memory_nan failed: CUDA error {err}")


def _bind():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 4 + [I] * 9 + [ctypes.c_float] + [L] * 12
                       + [I, I, P])
        fn.restype = ctypes.c_int
    return fn
