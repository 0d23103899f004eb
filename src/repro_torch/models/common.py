"""Shared model primitives: norms, activations, rotary embeddings, init.

Counterparts of the reference package's ``models/common.py``.  Shard hints
are dropped (one card), and the embedding lookup is a plain index.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------- activations
ACTIVATIONS: dict = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "relu": F.relu,
    "squared_relu": lambda x: F.relu(x).square(),
}


# ---------------------------------------------------------------- rotary
def rope_at(pos: int, rotary_dim: int, theta: float, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of one position, (rotary_dim // 2,) float32 — the row
    ``pos`` of the reference's ``rope_frequencies`` tables, computed alone
    (the full table at gemma-2b's max_position would be 285 MB)."""
    inv = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                        device=device) / rotary_dim))
    ang = inv * float(pos)          # a host scalar: no copy to the device
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotate pairs (interleaved-half convention) of ``x`` (..., D) at one
    position; the rotation runs in fp32 and the result is in x's dtype."""
    D = x.shape[-1]
    rd = rotary_dim or D
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2].float(), xr[..., rd // 2:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)


# ------------------------------------------------------------------ init
def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.bfloat16, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal init with std 1/sqrt(fan_in); a leading layer axis, if any,
    does not count towards fan_in."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std).to(dtype)


def embed_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.bfloat16, std: float = 0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std).to(dtype)
