"""Plain PyTorch oracles for the ported kernels (the allclose ground truth).

Counterparts of the reference package's ``kernels/ref.py``: deliberately
naive, full score matrices, fp32 everywhere, the reference's layouts.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: int) -> torch.Tensor:
    """q: (B, K, G, D); k, v: (B, K, T, D) -> (B, K, G, D).

    Positions ``>= length`` are masked with a large negative score, so at
    ``length == 0`` every position is masked alike and the result is the
    mean of v, exactly as the reference oracle gives."""
    D, T = q.shape[-1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bkgd,bktd->bkgt", q.float() * scale, k.float())
    masked = torch.arange(T, device=q.device) >= length
    s = s.masked_fill(masked, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bktd->bkgd", p, v.float()).to(q.dtype)


def decode_attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: int) -> torch.Tensor:
    """The same attention over the first ``length`` rows in float64, zeros
    at ``length == 0``: the yardstick for the rounding of the kernel and of
    the fp32 plain version.  Returns float64."""
    if length == 0:
        return torch.zeros(q.shape, dtype=torch.float64, device=q.device)
    s = torch.einsum("bkgd,bktd->bkgt", q.double() / math.sqrt(q.shape[-1]),
                     k[:, :, :length].double())
    return torch.einsum("bkgt,bktd->bkgd", torch.softmax(s, -1),
                        v[:, :, :length].double())


def tiered_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B, K, G, S, D); k, v: (B, K, T, D) -> (B, K, G, S, D).  Causal
    masking is top-left aligned (key t is hidden from query s when
    t > s)."""
    S, D, T = q.shape[3], q.shape[-1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bkgsd,bktd->bkgst", q.float() * scale, k.float())
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                > torch.arange(S, device=q.device)[:, None])
        s = s.masked_fill(mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,bktd->bkgsd", p, v.float()).to(q.dtype)


def ssd_scan_ref(a: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q: torch.Tensor) -> torch.Tensor:
    """Step-by-step SSD recurrence in fp32.  a: (B, H, S); k, q:
    (B, H, S, N); v: (B, H, S, P) -> y (B, H, S, P) in v's dtype."""
    B, H, S = a.shape
    state = torch.zeros((B, H, k.shape[-1], v.shape[-1]),
                        dtype=torch.float32, device=a.device)
    ys = []
    for t in range(S):
        state = state * a[:, :, t, None, None].float() + torch.einsum(
            "bhn,bhp->bhnp", k[:, :, t].float(), v[:, :, t].float())
        ys.append(torch.einsum("bhnp,bhn->bhp", state, q[:, :, t].float()))
    return torch.stack(ys, dim=2).to(v.dtype)
