"""Shared model primitives: norms, activations, rotary embeddings, init,
the KV cache's element conversion.

Counterparts of the reference package's ``models/common.py``.  Shard hints
are dropped (one card), and the embedding lookup is a plain index.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _tree


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """In fp32 (biased variance, as ``jnp.var``), result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)


# ---------------------------------------------------------- activations
ACTIVATIONS: dict = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "relu": F.relu,
    "squared_relu": lambda x: F.relu(x).square(),
}


# ---------------------------------------------------------------- rotary
def _inv_freq(rotary_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                         device=device) / rotary_dim))


def rope_frequencies(head_dim: int, n_pos: int, theta: float = 10000.0,
                     rotary_dim: Optional[int] = None, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (n_pos, rotary_dim // 2), float32, for
    positions ``0..n_pos-1``: the reference's ``rope_frequencies``, sized
    to the positions a sequence uses rather than ``max_position``."""
    rd = rotary_dim or head_dim
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)
    ang = torch.outer(pos, _inv_freq(rd, theta, device))
    return torch.cos(ang), torch.sin(ang)


def rope_at(pos: int, rotary_dim: int, theta: float, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of one position, (rotary_dim // 2,) float32 — the row
    ``pos`` of the reference's ``rope_frequencies`` tables, computed alone
    (the full table at gemma-2b's max_position would be 285 MB)."""
    ang = _inv_freq(rotary_dim, theta, device) * float(pos)   # host scalar
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotate pairs (interleaved-half convention); the rotation runs in
    fp32 and the result is in x's dtype.  Without ``positions``: ``x``
    (..., D) at the one position of ``cos``/``sin`` (:func:`rope_at`).
    With ``positions`` (S,): ``x`` (..., S, H, D) and tables from
    :func:`rope_frequencies`, as the reference's ``apply_rope``."""
    D = x.shape[-1]
    rd = rotary_dim or D
    if positions is not None:
        cos = cos[positions][..., None, :]          # (S, 1, rd/2)
        sin = sin[positions][..., None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2].float(), xr[..., rd // 2:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)


# ------------------------------------------------------------- KV cache
#: the fp8 KV cache's element type (the reference's kv_dtype=float8_e4m3fn)
E4M3 = torch.float8_e4m3fn
#: its largest finite value
E4M3_MAX = 448.0


def kv_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` as the KV cache's ``dtype`` stores it.  Into e4m3 one explicit
    conversion, the same on the CPU and the card: through fp32 (exact from
    bf16), saturated to +-448 (NaN stays NaN), rounded to nearest even.  In
    range that gives the reference's bits; past +-464 and at +-inf the
    reference gives NaN (ROADMAP P12).  (Without the clamp the devices
    differ there: torch's cast saturates on the CPU and gives NaN on an
    H100.)  Any other dtype: ``x.to(dtype)``."""
    if dtype != E4M3:
        return x.to(dtype)
    return x.float().clamp(-E4M3_MAX, E4M3_MAX).to(E4M3)


# ------------------------------------------------------------------ init
#: leaves of more elements than this are drawn slab by slab (below it, in
#: one fp32 draw: every leaf of the hybrid and xlstm configs and of the
#: dense ones but nemotron-4-340b, the largest chatglm3-6b's stacked
#: w_gate of 1.57e9 elements)
ONE_DRAW_MAX = 1 << 31
#: elements of one slab's fp32 draw (1 GiB)
SLAB_MAX = 1 << 28


def _normal(generator: torch.Generator, shape: Tuple[int, ...], dtype,
            std: float) -> torch.Tensor:
    """N(0, std^2) in ``dtype``.  Up to ONE_DRAW_MAX elements: one fp32
    draw, scaled and cast.  Above it the result is allocated in ``dtype``
    and filled one slab of the leading axis at a time (recursively, until
    a slab holds at most SLAB_MAX elements), each slab its own fp32 draw
    from the same generator, so no more than ~1 GiB of fp32 is live: a
    whole draw of moonshot's stacked expert w_gate (8.86e9 elements) would
    be a 35 GB fp32 transient beside its 17.7 GB result.  A matrix whose
    slabs are rows (nemotron-4-340b's embedding and head, 256000 x 18432
    and its transpose, and each layer of its stacked MLP) is drawn in runs
    of as many rows as SLAB_MAX holds: 18 draws for the embedding."""
    if math.prod(shape) <= ONE_DRAW_MAX:
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    _fill_slabs(out, generator, std)
    return out


def _fill_slabs(out: torch.Tensor, generator: torch.Generator,
                std: float) -> None:
    if out.numel() <= SLAB_MAX:
        out.copy_(torch.randn(out.shape, generator=generator,
                              dtype=torch.float32,
                              device=generator.device).mul_(std))
        return
    if out.dim() == 2 and out.shape[1] <= SLAB_MAX:
        for rows in out.split(SLAB_MAX // out.shape[1]):
            _fill_slabs(rows, generator, std)
        return
    for slab in out:
        _fill_slabs(slab, generator, std)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.bfloat16, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal init with std 1/sqrt(fan_in); a leading layer axis, if any,
    does not count towards fan_in."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _normal(generator, shape, dtype, std)


def embed_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.bfloat16, std: float = 0.02) -> torch.Tensor:
    return _normal(generator, shape, dtype, std)


def count_params(tree) -> int:
    """Elements of every tensor in a nested dict / list / tuple."""
    return sum(t.numel() for t in _tree.leaves(tree))


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))
