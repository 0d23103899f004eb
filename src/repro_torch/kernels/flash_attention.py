"""Causal or non-causal GQA flash attention with its gradient: the
wrappers around ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward), their plain PyTorch versions,
and the ``torch.autograd.Function`` that ties the two together.

Port of the reference package's Pallas kernel
(``kernels/flash_attention.py``, ``_flash_kernel``).  The reference has no
backward kernel (JAX differentiates its pure-JAX twin), so the backward's
plain version recomputes the probabilities from the forward's fp32
log-sum-exp, as FlashAttention-2 does.  On a CUDA tensor each wrapper
launches its kernel or raises; only a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .. import record
from . import build
from .ref import NEG_INF

#: launches of the forward kernel since the last reset
launches = 0
#: launches of the backward kernels (one per gradient) since the last reset
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: keys per block of the dk/dv kernel: fp32 FFMA, bf16 tensor cores
_KEY_TILE_BWD = {torch.float32: 32, torch.bfloat16: 64}
_ROW_TILE = 64               # stacked query rows per step of that kernel


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 scores (B, K, G, S, T) of q * scale against k, masked entries
    at NEG_INF.  Only the T keys given are scored, so keys past the end
    never enter the softmax (reference defect R1)."""
    S, D, T = q.shape[3], q.shape[-1], k.shape[2]
    s = torch.einsum("bkgsd,bktd->bkgst", q.float() * (1.0 / math.sqrt(D)),
                     k.float())
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                > torch.arange(S, device=q.device)[:, None])
        s = s.masked_fill(mask, NEG_INF)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: (out in q's dtype,
    log-sum-exp (B, K, G, S) in fp32)."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float()).to(q.dtype)
    return out, lse


def flash_attention_plain_rows(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, r0: int, r1: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain`'s arithmetic on the causal query rows
    ``r0..r1`` alone, against the keys they see (``0..r1``): (out rows in
    q's dtype, their log-sum-exp in fp32).  Holds a long sequence's rows
    to the plain version without the scores of every row."""
    D = q.shape[-1]
    s = torch.einsum("bkgsd,bktd->bkgst",
                     q[..., r0:r1, :].float() * (1.0 / math.sqrt(D)),
                     k[:, :, :r1].float())
    mask = (torch.arange(r1, device=q.device)[None, :]
            > torch.arange(r0, r1, device=q.device)[:, None])
    s = s.masked_fill(mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgst,bktd->bkgsd", p, v[:, :, :r1].float())
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, dout, lse, causal: bool = True
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function in plain PyTorch: (dq, dk, dv) in
    their inputs' dtypes, recomputed from the forward's log-sum-exp; dk and
    dv sum over the G heads that share a KV head."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    do = dout.float()
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
    dp = torch.einsum("bkgsd,bktd->bkgst", do, v.float())
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, q.float() * scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q (B,K,G,S,D), k and v (B,K,T,D)")
    B, K, G, S, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, K) or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError("flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")


def _check_cuda(*tensors) -> None:
    q = tensors[0]
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    D = q.shape[-1]
    if D % 8 or not 8 <= D <= 256:
        raise ValueError("flash_attention: the kernel takes D a multiple of "
                         f"8 in [8, 256] (got {D})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: the kernel takes contiguous "
                         "tensors")


@record.kernel(lambda q, k, v, causal=True, *, out: ((q, k, v), out))
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, K, G, S, D); k, v: (B, K, T, D), any S and T.  Returns (out
    like q, fp32 log-sum-exp (B, K, G, S))."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check_cuda(q, k, v)
    B, K, G, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, K, G, S), dtype=torch.float32, device=q.device)
    err = _bind_fwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), B, K, G, S,
                      k.shape[2], D, int(causal), 1.0 / math.sqrt(D),
                      _DTYPES[q.dtype],
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out, lse


def _dkdv_split(B: int, K: int, G: int, S: int, T: int,
                key_tile: int) -> int:
    """Blocks per key tile of ``key_tile`` keys in the dk/dv kernel: enough
    for about two blocks per SM in all, no more than the row tiles there
    are, at most 8.  Each extra split writes and reads one fp32 partial of
    dk and dv (2 * B*K*T*D * 4 bytes)."""
    blocks = B * K * -(-T // key_tile)
    row_tiles = -(-S * G // _ROW_TILE)
    return max(1, min(8, row_tiles, -(-264 // blocks)))


@record.kernel(lambda q, k, v, o, dout, lse, causal=True, *, out:
               ((q, k, v, o, dout, lse), out))
def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True
                        ) -> Tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd` at ``dout``,
    from its inputs, output and log-sum-exp."""
    global bwd_launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal)
    _check_cuda(q, k, v, out, dout, lse)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out and dout must match q")
    B, K, G, S, D = q.shape
    T = k.shape[2]
    n_split = _dkdv_split(B, K, G, S, T, _KEY_TILE_BWD[q.dtype])
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, K, G, S), dtype=torch.float32, device=q.device)
    part = torch.empty((n_split, 2, B * K, T, D) if n_split > 1 else (1,),
                       dtype=torch.float32, device=q.device)
    err = _bind_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), part.data_ptr(), B, K, G, S, T, D,
                      int(causal), 1.0 / math.sqrt(D), n_split,
                      _DTYPES[q.dtype],
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient.  Saves q,
    k, v, the output and the fp32 log-sum-exp (B, K, G, S)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, K, G, S, D); k, v: (B, K, T, D) -> (B, K, G, S, D) in q's
    dtype, differentiable.  Any S and T: nothing is padded."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)


def _bind_fwd():
    fn = build.load("flash_attention").flash_attention_fwd_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 7 + [ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
    return fn


def _bind_bwd():
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 11 + [I] * 7 + [ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return fn
