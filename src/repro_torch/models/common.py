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

# ---------------------------------------------------------------------------
# Mesh hint: the launch layer registers the active mesh so model code can
# constrain activation shardings (batch over DP axes, hidden over "model")
# without importing the launch layer.  ``None`` (tests, single device) makes
# constraints no-ops.
_MESH_HINT = None


def set_mesh_hint(mesh) -> None:
    global _MESH_HINT
    _MESH_HINT = mesh


def get_mesh_hint():
    return _MESH_HINT


def shard_hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """Apply a sharding constraint if a mesh hint is active.

    ``axes``: per-dim axis roles; "dp" expands to ("pod", "data").  A
    DTensor is redistributed to the spec :func:`fit` gives; a plain tensor
    is returned as it is where every mesh axis the spec keeps has size 1,
    and raises ``ValueError`` naming the axis otherwise."""
    mesh = _MESH_HINT
    if mesh is None:
        return x
    from ..distributed import sharding as shd       # local: avoid cycle
    from torch.distributed.tensor import DTensor
    resolved = tuple(shd.dp_axes(mesh) if a == "dp" else a for a in axes)
    spec = shd.fit(mesh, tuple(x.shape), *resolved)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, shd.placements(mesh, spec))
    shd.require_whole(mesh, spec, "shard_hint")
    return x


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


# ----------------------------------------------------------- embedding
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 tied: bool = False) -> torch.Tensor:
    """``table[tokens]``; under a mesh hint, the reference's two sharded
    routes over the table's local shard (:class:`_EmbedLookup`):

    * untied: table d-sharded over "model" -- gather and scatter fully
      local per d-slice, grads all-reduced over the DP axes.
    * tied: table vocab-sharded over "model" (the head needs vocab-parallel
      logits) -- masked local gather + all-reduce over "model".

    ``table`` and ``tokens`` are DTensors placed by the route's specs (the
    result is then a DTensor), or plain tensors where the hint leaves them
    whole (:func:`..distributed.sharding.local`)."""
    mesh = _MESH_HINT
    if mesh is None:
        return table[tokens]
    from ..distributed import sharding as shd
    from torch.distributed.tensor import DTensor

    dp = shd.dp_axes(mesh)
    V, d = table.shape
    tshape = tuple(tokens.shape)
    x_axes = (dp,) + (None,) * (len(tshape) - 1)
    tok_spec = shd.fit(mesh, tshape, *x_axes)
    if tied:
        table_spec = shd.fit(mesh, (V, d), "model", None)
        vocab_sharded = table_spec[0] is not None
        x_spec = shd.fit(mesh, tshape + (d,), *x_axes, None)
    else:
        table_spec = shd.fit(mesh, (V, d), None, "model")
        vocab_sharded = False
        x_spec = shd.fit(mesh, tshape + (d,), *x_axes, "model")
    t0 = tok_spec[0]
    used = t0 if isinstance(t0, tuple) else (t0,)
    dp_groups = [mesh.get_group(ax) for ax in
                 (dp if isinstance(dp, tuple) else (dp,)) if ax in used]
    local_table = shd.local(table, mesh, table_spec, "embed_lookup's table")
    local_tok = shd.local(tokens, mesh, tok_spec, "embed_lookup's tokens")
    start, model_group = None, None
    if vocab_sharded:
        start = mesh.get_local_rank("model") * local_table.shape[0]
        model_group = mesh.get_group("model")
    x = _EmbedLookup.apply(local_table, local_tok, start, model_group,
                           dp_groups)
    if isinstance(table, DTensor) or isinstance(tokens, DTensor):
        return DTensor.from_local(x, mesh, shd.placements(mesh, x_spec),
                                  run_check=False)
    return x


class _EmbedLookup(torch.autograd.Function):
    """The sharded lookup on local shards.  ``start``: the first vocab row
    of a vocab-sharded table's shard (rows outside it give zeros, summed
    over ``model_group``), or None for a table whose rows are all here.
    The backward scatter-adds into the local rows in fp32, all-reduces
    over ``dp_groups`` (the DP axes the tokens are split over) and casts to
    the table's dtype."""

    @staticmethod
    def forward(ctx, table, tok, start, model_group, dp_groups):
        ctx.save_for_backward(tok)
        ctx.meta = (tuple(table.shape), table.dtype, start, dp_groups)
        if start is None:
            return table[tok]
        rel = tok - start
        ok = (rel >= 0) & (rel < table.shape[0])
        x = torch.where(ok[..., None], table[rel.clamp(0, table.shape[0] - 1)],
                        table.new_zeros(()))
        torch.distributed.all_reduce(x, group=model_group)
        return x

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        (rows, d), dtype, start, dp_groups = ctx.meta
        gm = g.float().reshape(-1, d)
        idx = tok.reshape(-1)
        if start is not None:
            idx = idx - start
            ok = (idx >= 0) & (idx < rows)
            gm = torch.where(ok[:, None], gm, gm.new_zeros(()))
            idx = idx.clamp(0, rows - 1)
        dt = torch.zeros((rows, d), dtype=torch.float32, device=g.device)
        dt.index_put_((idx,), gm, accumulate=True)
        for group in dp_groups:
            torch.distributed.all_reduce(dt, group=group)
        return dt.to(dtype), None, None, None, None


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
