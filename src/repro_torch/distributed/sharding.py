"""Sharding rules: DP/FSDP x TP x EP x SP over a ("pod",) "data", "model"
mesh.

Counterpart of the reference package's ``distributed/sharding.py``, rule
for rule.  Axis roles
----------
``("pod", "data")``  -- data parallel + FSDP (ZeRO-3 parameter/optimizer
                       sharding over the *full* DP extent)
``"model"``          -- tensor parallel (Megatron splits), expert parallel
                       (MoE expert dim), and head-parallel KV caches
sequence (SP)        -- long-context caches shard their sequence dim over
                       ``"data"`` when batch < DP extent (long_500k).

A spec is a :class:`PartitionSpec`, a tuple with one entry a tensor dim:
``None``, an axis name, or a tuple of names (the dim split over them, the
first outermost), as JAX's ``PartitionSpec``.  Every rule passes through
:func:`fit`, which drops mesh axes that do not divide the dim.  The rules
take a ``torch.distributed`` ``DeviceMesh`` or a mesh with no devices
(:class:`..launch.mesh.AbstractMesh`); :func:`shardings` and
:func:`distribute` turn specs into DTensor placements on a
``DeviceMesh`` (``Shard(d)`` on each mesh dim a spec names,
``Replicate()`` on the rest).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Tuple, Union

import torch

from .. import _tree
from ..configs.base import ArchConfig, ShapeConfig

AxisName = Union[str, Tuple[str, ...], None]

# Flat-DP mode: small models waste the "model" axis on tensor parallelism
# (every TP collective is pure overhead when a layer fits one chip).  When
# enabled, the "model" axis joins the DP group and TP placements are
# dropped -- a perf-profile knob, not a default.
_FLAT_DP = False


class PartitionSpec(tuple):
    """A tensor's sharding: one entry a dim (``None``, an axis name, or a
    tuple of names).  A tuple, so it compares equal to the plain tuple of
    its entries; a leaf of the spec trees (:func:`is_spec`)."""

    def __new__(cls, *entries: AxisName) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def is_spec(x: Any) -> bool:
    return isinstance(x, PartitionSpec)


def set_flat_dp(value: bool) -> None:
    global _FLAT_DP
    _FLAT_DP = value


def flat_dp() -> bool:
    return _FLAT_DP


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mesh whose ``shape``
    is that mapping."""
    if hasattr(mesh, "mesh_dim_names"):                  # a DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _names(entry: AxisName) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_axis_size(mesh, axis: AxisName) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _names(axis))


def dp_axes(mesh) -> AxisName:
    base = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
    return base + ("model",) if _FLAT_DP else base


def fit(mesh, shape: Tuple[int, ...], *axes: AxisName) -> PartitionSpec:
    """Build a spec, dropping axes that don't divide the dim."""
    if len(axes) != len(shape):
        raise ValueError(f"fit: {len(axes)} axes for shape {tuple(shape)}")
    if _FLAT_DP:
        axes = tuple(None if ax == "model" else ax for ax in axes)
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, axes):
        # keep the longest prefix of axes whose product divides dim
        kept = []
        prod = 1
        for a in _names(ax):
            if a not in sizes:
                continue
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return PartitionSpec(*out)


# ---------------------------------------------------------------------------
# parameter rules (path-regex -> axis roles per dimension, minus leading L)
# ---------------------------------------------------------------------------
def _param_axes(path: str, ndim: int, dp: AxisName, tied: bool = False):
    """Returns per-dim axis roles for a (possibly L-stacked) parameter."""
    # Embedding: d-sharded for untied archs (gather/scatter fully local per
    # d-slice); vocab-sharded when the table doubles as the LM head (tied)
    # so logits stay vocab-parallel.
    embed_axes = ("model", None) if tied else (None, "model")
    rules = [
        # attention
        (r"attn/w[qkv]$", (dp, "model")),
        (r"attn/wo$", ("model", dp)),
        (r"attn/b[qkv]$", ("model",)),
        # dense mlp
        (r"mlp/w_(gate|up)$", (dp, "model")),
        (r"mlp/w_down$", ("model", dp)),
        # shared experts
        (r"moe/shared_(gate|up)$", (dp, "model")),
        (r"moe/shared_down$", ("model", dp)),
        # moe experts: EP on expert dim + FSDP inside
        (r"moe/router$", (dp, None)),
        (r"moe/w_(gate|up)$", ("model", dp, None)),
        (r"moe/w_down$", ("model", None, dp)),
        # mamba2
        (r"in_proj$", (dp, "model")),
        (r"out_proj$", ("model", dp)),
        (r"conv_w$", (None, "model")),
        (r"conv_b$", ("model",)),
        (r"(a_log|dt_bias|d_skip)$", (None,)),
        # xlstm
        (r"o_gate$", (dp, "model")),
        (r"w_gates$", (dp, "model")),
        (r"r_gates$", (None, None, "model")),
        # embeddings / head (see embed_axes above)
        (r"embed$", embed_axes),
        (r"head$", (None, "model")),
        (r"frontend_proj$", (dp, "model")),
        # norms and everything else small: replicated
        (r".*", tuple([None] * ndim)),
    ]
    for pat, axes in rules:
        if re.search(pat, path):
            axes = tuple(axes)
            if len(axes) < ndim:      # L-stacked: leading layer dim(s)
                axes = tuple([None] * (ndim - len(axes))) + axes
            return axes[:ndim]
    raise AssertionError("unreachable")


def _with_paths(tree: Any):
    """``([("/"-joined path, leaf), ...], treedef)``: the reference's
    ``_path_str`` of each leaf's key path (dict keys and sequence
    indices), in JAX's flatten order."""
    pairs, treedef = _tree.flatten_with_keys(tree)
    return [("/".join(str(k) for k in keys), leaf)
            for keys, leaf in pairs], treedef


def _map_with_path(fn, tree: Any) -> Any:
    pairs, treedef = _with_paths(tree)
    return _tree.unflatten(treedef, [fn(p, leaf) for p, leaf in pairs])


def param_specs(mesh, params_shapes: Any, *,
                tied: Optional[bool] = None) -> Any:
    """Specs for a params tree (of tensors, meta or fake tensors, or
    anything with a ``shape``)."""
    dp = dp_axes(mesh)
    if tied is None:
        tied = not any("head" in p for p, _ in _with_paths(params_shapes)[0])

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        return fit(mesh, shape, *_param_axes(path, len(shape), dp, tied))

    return _map_with_path(spec, params_shapes)


def opt_specs(mesh, opt_shapes: Any, params_shapes: Any,
              pspecs: Any) -> Any:
    """Optimizer state mirrors parameter sharding (same-shape leaves; where
    two parameters share a shape, the later one in flatten order)."""
    flat_params = {tuple(l.shape): s for l, s in zip(
        _tree.leaves(params_shapes), _tree.leaves(pspecs, is_spec))}
    dp = dp_axes(mesh)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return PartitionSpec()
        if shape in flat_params:
            return flat_params[shape]
        # fallback (quantized moments etc.): FSDP on the largest dim
        axes = [None] * len(shape)
        axes[shape.index(max(shape))] = dp
        return fit(mesh, shape, *axes)

    return _map_with_path(spec, opt_shapes)


# ---------------------------------------------------------------------------
def batch_specs(mesh, cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, PartitionSpec]:
    dp = dp_axes(mesh)
    out = {"tokens": fit(mesh, (shape.global_batch, shape.seq_len), dp, None),
           "labels": fit(mesh, (shape.global_batch, shape.seq_len), dp, None)}
    if cfg.frontend:
        out["frontend"] = fit(
            mesh, (shape.global_batch, cfg.frontend_tokens, cfg.d_model),
            dp, None, "model")
    return out


def cache_specs(mesh, cfg: ArchConfig, cache_shapes: Any, batch: int) -> Any:
    """KV/state cache sharding.  Batch over DP when divisible; otherwise SP:
    shard the sequence dim over "data" (long_500k, batch=1)."""
    dp = dp_axes(mesh)
    batch_ok = batch % mesh_axis_size(mesh, dp) == 0

    def spec(p, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"(^|/)(k|v)$", p):        # (L_or_apps, B, S, K, Dh)
            if batch_ok:
                s = fit(mesh, shape, None, dp, None, "model", None)
                if s[3] is None:
                    # few KV heads (MQA/GQA) cannot split 16-way: shard the
                    # sequence instead (SP cache, flash-decoding style)
                    s = fit(mesh, shape, None, dp, "model", None, None)
                return s
            return fit(mesh, shape, None, None, "data", "model", None)
        if "conv" in p:                          # (L, B, W, C)
            return fit(mesh, shape, None, dp if batch_ok else None,
                       None, "model")
        if "ssm" in p or "state" in p:           # (L, B, H, N, P)
            return fit(mesh, shape, None, dp if batch_ok else None,
                       "model", None, None)
        if len(shape) >= 2:                      # slstm h/c/n/m: (L, B, H, P)
            axes = [None] * len(shape)
            if batch_ok:
                axes[1] = dp
            return fit(mesh, shape, *axes)
        return PartitionSpec()

    return _map_with_path(spec, cache_shapes)


# ------------------------------------------------------------ per device
def _shard_shape(shape: Tuple[int, ...], spec: PartitionSpec,
                 mesh) -> Tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``spec`` (every
    dim a multiple of its axes' product, as :func:`fit` leaves it)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        n = math.prod(sizes[a] for a in _names(entry))
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways ({entry})")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes of one device's shard of every leaf of ``tree`` (anything with
    ``shape`` and a ``dtype`` with ``itemsize``), summed."""
    leaves = _tree.leaves(tree)
    spec_leaves = _tree.leaves(specs, is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return sum(math.prod(_shard_shape(tuple(l.shape), s, mesh))
               * l.dtype.itemsize for l, s in zip(leaves, spec_leaves))


# ------------------------------------------------------------- placements
def placements(mesh, spec: PartitionSpec) -> Tuple[Any, ...]:
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim that
    tensor dim d names, ``Replicate()`` on the rest.  A dim split over
    several mesh dims must name them in the mesh's order (DTensor splits
    a dim over mesh dims in their order; another order would place other
    rows on each rank)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in _names(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec!r}: dim {d} names {entry} out of "
                             f"the mesh's order {names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def require_whole(mesh, spec: PartitionSpec, what: str) -> None:
    """Raise unless every mesh axis ``spec`` keeps has size 1: a plain
    tensor is a rank's whole copy, which such a spec leaves whole."""
    sizes = axis_sizes(mesh)
    for entry in spec:
        for a in _names(entry):
            if sizes[a] > 1:
                raise ValueError(
                    f"{what}: a plain tensor cannot be split over mesh axis "
                    f"{a!r} of size {sizes[a]} (spec {spec!r}); give a "
                    "DTensor")


def local(t: torch.Tensor, mesh, spec: PartitionSpec,
          what: str) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec``: a DTensor's local tensor
    (its placements must be ``spec``'s), or a plain tensor as it is where
    :func:`require_whole` allows it."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        want = placements(mesh, spec)
        if tuple(t.placements) != want:
            raise ValueError(f"{what}: placements {tuple(t.placements)}, "
                             f"want {want} (spec {spec!r})")
        return t.to_local()
    require_whole(mesh, spec, what)
    return t


def shardings(mesh, specs: Any) -> Any:
    """A tree of ``(mesh, placements)`` pairs mirroring ``specs`` (what
    ``CheckpointManager.restore(shardings=...)`` takes)."""
    leaves, treedef = _tree.flatten(specs, is_spec)
    return _tree.unflatten(treedef, [(mesh, placements(mesh, s))
                                     for s in leaves])


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor placed by its spec: rank 0's
    tensor split over the mesh (``distribute_tensor``)."""
    from torch.distributed.tensor import distribute_tensor
    leaves, treedef = _tree.flatten(tree)
    spec_leaves = _tree.leaves(specs, is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return _tree.unflatten(treedef, [
        distribute_tensor(t, mesh, placements(mesh, s))
        for t, s in zip(leaves, spec_leaves)])
