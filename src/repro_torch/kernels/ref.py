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


def tiered_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)
