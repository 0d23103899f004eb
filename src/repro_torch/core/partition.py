"""Large data object partitioning (paper §3.2 "Handling large data objects"),
extended with skew-aware repartitioning.

An object larger than the fast tier can never be migrated whole.  The paper
partitions *one-dimensional arrays with regular references* into equal chunks
that are profiled and placed independently.  Equal chunks are the right
answer only when references really are regular: under skewed access (graph
adjacency with power-law degrees, KV caches with a sliding hot window) an
even split smears the hot subset across every chunk and the knapsack can no
longer pick just the hot head.

**Skew-aware partitioning** uses the profiler's measured per-object access
histograms (``ObjectPhaseProfile.bin_weights``, sampled PEBS-style): the
object's byte range is split by recursive bisection until each chunk's
access density is near-uniform *in every profiled phase* (or a minimum chunk
floor is hit), so chunk boundaries land on the access CDF's knees — small
chunks over the hot head, coarse chunks over the cold tail.  Chunks larger
than the conservative ``capacity/chunk_divisor`` ceiling are always split
further, preserving the paper's policy as the uniform-access limit.

``auto_partition`` decides per object: measured histograms -> skew-aware
bisection; no histograms -> the paper's equal chunking.  ``resplit_refs``
rewrites per-phase reference counts from the same measured histograms (per-
chunk attribution), falling back to size fractions, and is re-run on every
(re)plan so drifted access patterns re-attribute without re-partitioning.

**Leaf alignment** (``auto_partition(..., leaf_aligned=True)``): objects
registered from pytrees carry per-leaf byte spans; snapping chunk cuts to
the nearest leaf boundary (:func:`snap_to_leaf_boundaries`) makes every
chunk moveable as a set of *whole arrays* on real backends — no sub-leaf
copies.

**Coalescing** (:func:`coalesce_chunks`): bisection only ever splits, so
when drift moves the hot window, stale fine chunks linger and the registry
grows monotonically.  The coalescing pass re-merges *adjacent* chunks whose
measured per-phase access densities converged and whose current tiers
agree (never past the conservative ``capacity/chunk_divisor`` ceiling),
capping registry growth across long drift sequences while leaving density
edges — and therefore plan quality — intact.

**Multi-resolution mode** (refined histograms, ``RuntimeConfig.
histogram_refine``): measured histograms are variable-width
:class:`~.histogram.Histogram`\\ s whose hot bins have been adaptively
re-binned finer, so (a) :func:`skew_boundaries` with ``local_floor`` may
cut below the legacy one-bin ceiling — each segment's min-chunk floor is
bounded by the *finest measured bin overlapping it*, with splits
allocated worst-imbalance-first (mass-weighted) under the chunk budget —
and (b) :func:`resplit_hot_chunks` re-splits *existing* chunks whose
refined densities turned imbalanced, which is what lets a previously
coalesced chunk re-split when drift re-heats it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data_objects import DataObject, ObjectRegistry
from .histogram import Histogram, uniform_mass
from .phase import PhaseGraph
from .profiler import PhaseProfiler


def should_partition(obj: DataObject, fast_capacity: int,
                     *, threshold: float = 1.0) -> bool:
    """Partition only objects that cannot fit (``size > threshold*capacity``)
    and are declared chunkable (regular 1-D references)."""
    return obj.chunkable and obj.size_bytes > threshold * fast_capacity


# ---------------------------------------------------------------------------
# measured-histogram geometry
# ---------------------------------------------------------------------------
def bin_mass(weights, lo_frac: float, hi_frac: float) -> float:
    """Integral of the piecewise-constant access density described by
    ``weights`` over the fractional byte range [lo_frac, hi_frac).

    ``weights`` is either a legacy fixed-width weight sequence (relative
    weights over equal-width bins spanning [0, 1]) or a multi-resolution
    :class:`~.histogram.Histogram` (variable-width bins); uniform inputs
    take the bit-identical legacy arithmetic path."""
    if isinstance(weights, Histogram):
        return weights.mass_fraction(lo_frac, hi_frac)
    return uniform_mass(weights, lo_frac, hi_frac)


def _finest_width(bins: Sequence, lo_frac: float, hi_frac: float) -> float:
    """Narrowest measured bin (byte fraction) overlapping [lo_frac,
    hi_frac) across all phase histograms — the local measurement
    resolution the partitioner's min-chunk floor is bounded by."""
    finest = 1.0
    for b in bins:
        if isinstance(b, Histogram):
            finest = min(finest, b.finest_width(lo_frac, hi_frac))
        else:
            n = len(b)
            if n:
                finest = min(finest, 1.0 / n)
    return finest


def chunk_spans(registry: ObjectRegistry, parent: str
                ) -> List[Tuple[DataObject, int, int]]:
    """Chunks of ``parent`` in index order with their [lo, hi) byte spans."""
    chunks = sorted((o for o in registry if o.parent == parent),
                    key=lambda o: o.chunk_index or 0)
    out, acc = [], 0
    for c in chunks:
        out.append((c, acc, acc + c.size_bytes))
        acc += c.size_bytes
    return out


def _clean_bins(phase_bins: Sequence) -> List:
    """Drop empty / zero-mass histograms; pass Histograms through and
    coerce legacy sequences to float arrays."""
    out: List = []
    for b in phase_bins:
        if isinstance(b, Histogram):
            if b.n_bins and b.total > 0.0:
                out.append(b)
        else:
            arr = np.asarray(b, dtype=np.float64)
            if arr.size and arr.sum() > 0.0:
                out.append(arr)
    return out


def skew_boundaries(size_bytes: int, phase_bins: Sequence,
                    *, coarse_bytes: int, min_chunk_bytes: int,
                    tol: float = 0.15, max_chunks: int = 64,
                    local_floor: bool = False) -> List[int]:
    """Chunk boundaries from measured access histograms by recursive
    bisection.

    A segment is split while it exceeds ``coarse_bytes`` (the paper's
    conservative ceiling — large chunks throttle the mover regardless of
    skew), or while any profiled phase's access mass is imbalanced across
    its midpoint by more than ``tol`` (relative to the segment's mass) and
    both halves stay above the min-chunk floor.  ``phase_bins`` entries are
    legacy fixed-width weight sequences or multi-resolution
    :class:`~.histogram.Histogram`\\ s.  Returns interior + end boundaries:
    ``[b_1, ..., b_k, size_bytes]``.

    With ``local_floor`` (the multi-resolution mode), the floor of each
    segment is bounded by the *finest measured bin* overlapping it rather
    than a single global constant: where refined histograms carry fine hot
    bins the cuts may go just as fine (down to ``min_chunk_bytes``), while
    coarsely-binned cold spans stop at their own resolution.  Splits are
    then allocated worst-imbalance-first under the ``max_chunks`` budget
    instead of depth-limited, so a sharp hot head can cut far below the
    legacy one-bin ceiling without exploding the chunk count."""
    bins = _clean_bins(phase_bins)

    def imbalance(lo: int, mid: int, hi: int) -> float:
        worst = 0.0
        for b in bins:
            seg = bin_mass(b, lo / size_bytes, hi / size_bytes)
            if seg <= 1e-12:
                continue
            left = bin_mass(b, lo / size_bytes, mid / size_bytes)
            worst = max(worst, abs(2.0 * left - seg) / seg)
        return worst

    if local_floor:
        return _mr_boundaries(size_bytes, bins, imbalance, 0, size_bytes,
                              coarse_bytes=coarse_bytes,
                              min_chunk_bytes=min_chunk_bytes, tol=tol,
                              max_chunks=max_chunks)

    max_depth = max(1, int(math.ceil(math.log2(max(max_chunks, 2)))))
    bounds: List[int] = []

    def rec(lo: int, hi: int, depth: int) -> None:
        size = hi - lo
        mid = lo + size // 2
        must = size > coarse_bytes
        may = (size >= 2 * min_chunk_bytes and depth < max_depth
               and imbalance(lo, mid, hi) > tol)
        if (must or may) and mid > lo and mid < hi:
            rec(lo, mid, depth + 1)
            rec(mid, hi, depth + 1)
        else:
            bounds.append(hi)

    rec(0, size_bytes, 0)
    return bounds


def _mr_boundaries(size_bytes: int, bins: Sequence, imbalance, seg_lo: int,
                   seg_hi: int, *, coarse_bytes: int, min_chunk_bytes: int,
                   tol: float, max_chunks: int) -> List[int]:
    """Worst-imbalance-first bisection of [seg_lo, seg_hi) under a chunk
    budget, with the per-segment min-chunk floor bounded by the finest
    measured bin overlapping the segment (multi-resolution mode)."""
    import heapq

    def floor_of(lo: int, hi: int) -> int:
        fw = _finest_width(bins, lo / size_bytes, hi / size_bytes)
        return max(min_chunk_bytes, int(fw * size_bytes))

    def seg_mass(lo: int, hi: int) -> float:
        return max((bin_mass(b, lo / size_bytes, hi / size_bytes)
                    for b in bins), default=0.0)

    def entry(lo: int, hi: int):
        size = hi - lo
        mid = lo + size // 2
        must = size > coarse_bytes
        imb = imbalance(lo, mid, hi) if mid > lo and mid < hi else 0.0
        may = (mid > lo and mid < hi and imb > tol
               and size >= 2 * floor_of(lo, hi))
        # mandatory splits first (the mover-throttle ceiling holds
        # regardless of the budget), then by mass-weighted imbalance: a
        # badly-cut *hot* segment wins split budget over an equally
        # imbalanced cold one (relative imbalance alone would spend the
        # budget resolving noise in the tail)
        return (0 if must else 1, -imb * seg_mass(lo, hi), lo, hi,
                must or may)

    heap = [entry(seg_lo, seg_hi)]
    done: List[Tuple[int, int]] = []
    while heap:
        rank, _, lo, hi, splittable = heapq.heappop(heap)
        over_budget = len(heap) + len(done) + 1 >= max_chunks
        if not splittable or (over_budget and rank != 0):
            done.append((lo, hi))
            continue
        mid = lo + (hi - lo) // 2
        heapq.heappush(heap, entry(lo, mid))
        heapq.heappush(heap, entry(mid, hi))
    done.sort()
    return [hi for _, hi in done]


def snap_to_leaf_boundaries(bounds: Sequence[int],
                            leaf_spans: Sequence[Tuple[str, int, int]],
                            size_bytes: int) -> List[int]:
    """Snap each interior chunk cut to the nearest registered leaf boundary.

    ``leaf_spans`` is the object's ``(path, offset, nbytes)`` list recorded
    at pytree registration.  Cuts that collapse onto the same leaf edge (or
    onto 0 / ``size_bytes``) are deduplicated, so an object with fewer
    leaves than requested chunks simply degenerates to leaf-granular
    chunks.  The trailing boundary is always ``size_bytes``."""
    edges = sorted({off for _, off, _ in leaf_spans if 0 < off < size_bytes})
    if not edges:
        return [size_bytes]
    snapped = set()
    for b in bounds:
        if b >= size_bytes:
            continue
        e = min(edges, key=lambda x: (abs(x - b), x))
        snapped.add(e)
    return sorted(snapped) + [size_bytes]


# ---------------------------------------------------------------------------
# physical / logical splitting
# ---------------------------------------------------------------------------
def partition_object_spans(registry: ObjectRegistry, name: str,
                           boundaries: Sequence[int]) -> List[DataObject]:
    """Split ``name`` into chunks at the given byte ``boundaries`` (strictly
    increasing, ending at the object's size), replacing it in the registry."""
    obj = registry[name]
    bounds = list(boundaries)
    if not bounds or bounds[-1] != obj.size_bytes:
        raise ValueError("boundaries must end at the object's size")
    if any(b2 <= b1 for b1, b2 in zip([0] + bounds, bounds)):
        raise ValueError("boundaries must be strictly increasing")
    if len(bounds) == 1:
        return [obj]

    n_chunks = len(bounds)
    payloads: List[Optional[object]] = [None] * n_chunks
    if obj.payload is not None and hasattr(obj.payload, "ndim") \
            and getattr(obj.payload, "ndim", 0) == 1:
        arr = obj.payload
        n_el = arr.shape[0]
        cuts = [0] + [round(b * n_el / obj.size_bytes) for b in bounds]
        cuts[-1] = n_el
        payloads = [arr[cuts[i]:cuts[i + 1]] for i in range(n_chunks)]

    chunks = []
    lo = 0
    for i, hi in enumerate(bounds):
        chunks.append(registry.register(DataObject(
            name=f"{name}#{i}", size_bytes=hi - lo, chunkable=False,
            payload=payloads[i], parent=name, chunk_index=i,
            tier=obj.tier, pinned=obj.pinned)))
        lo = hi
    registry.remove(name)
    return chunks


def partition_object(registry: ObjectRegistry, name: str,
                     chunk_bytes: int) -> List[DataObject]:
    """Split ``name`` into ceil(size/chunk_bytes) equal chunks (the paper's
    regular-reference policy), replacing it."""
    obj = registry[name]
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    n_chunks = max(1, math.ceil(obj.size_bytes / chunk_bytes))
    if n_chunks == 1:
        return [obj]
    bounds = [min((i + 1) * chunk_bytes, obj.size_bytes)
              for i in range(n_chunks)]
    return partition_object_spans(registry, name, bounds)


# ---------------------------------------------------------------------------
# reference attribution
# ---------------------------------------------------------------------------
def resplit_refs(graph: PhaseGraph, registry: ObjectRegistry,
                 profiler: Optional[PhaseProfiler] = None,
                 phases: Optional[Sequence[int]] = None) -> None:
    """Re-attribute every partitioned parent's per-phase reference counts to
    its chunks, using the profiler's measured histograms when available
    (falling back to size fractions).

    Safe to call on every (re)plan: ``annotate_graph`` re-writes parent-name
    reference counts from the (parent-keyed) profiles, and this pass splits
    them back down to chunk granularity with the freshest attribution.

    ``phases`` scopes the re-attribution to the listed phase indices (the
    serving-tick replan path: an undrifted phase was skipped by the scoped
    ``annotate_graph`` too, so its refs still hold the previous build's
    chunk attribution — recomputing it from the same profile version would
    write identical values).
    """
    scope = None if phases is None else set(phases)
    parents = sorted({o.parent for o in registry if o.parent is not None})
    for parent in parents:
        spans = chunk_spans(registry, parent)
        if not spans:
            continue
        total_bytes = sum(c.size_bytes for c, _, _ in spans) or 1
        for ph in graph:
            if scope is not None and ph.index not in scope:
                continue
            if parent not in ph.refs:
                # A parent that was profiled but faded below annotate_graph's
                # one-access floor has no ref key anymore — its chunks are
                # unreferenced too, so stale attribution from an earlier
                # build must not linger (it would shield the cold chunks
                # from eviction forever).
                if (profiler is not None
                        and profiler.profile(ph.index, parent) is not None):
                    for c, _, _ in spans:
                        ph.refs.pop(c.name, None)
                continue
            total = ph.refs.pop(parent)
            for c, _, _ in spans:           # drop stale chunk attribution
                ph.refs.pop(c.name, None)
            bins = None
            if profiler is not None:
                prof = profiler.profile(ph.index, parent)
                if prof is not None:
                    bins = prof.bin_weights
            if bins is None:
                for c, lo, hi in spans:
                    ph.refs[c.name] = total * c.size_bytes / total_bytes
            else:
                masses = [bin_mass(bins, lo / total_bytes, hi / total_bytes)
                          for _, lo, hi in spans]
                norm = sum(masses) or 1.0
                for (c, _, _), m in zip(spans, masses):
                    r = total * m / norm
                    if r > 0.0:
                        # a zero-access chunk is unreferenced this phase; a
                        # 0.0 entry would still count as a reference (dict
                        # membership) and shield the chunk from eviction
                        ph.refs[c.name] = r


# ---------------------------------------------------------------------------
# chunk coalescing (re-merging)
# ---------------------------------------------------------------------------
def coalesce_chunks(registry: ObjectRegistry, graph: PhaseGraph,
                    profiler: Optional[PhaseProfiler],
                    fast_capacity: int, *, chunk_divisor: int = 4,
                    tol: float = 0.15, cold_floor: float = 0.05
                    ) -> Dict[str, Tuple[int, int]]:
    """Merge adjacent chunks whose measured densities converged.

    For every partitioned parent with measured per-phase histograms, two
    adjacent chunks are merge candidates when, in *every* profiled phase,
    their per-byte access densities agree within ``tol`` (relative to the
    larger) or both sit below ``cold_floor`` x the parent's uniform density
    (converged-cold).  Runs of candidates additionally require agreeing
    current tiers (a merged chunk has one residency), matching payload-free
    chunks (physical slices cannot be re-joined without a copy), and a
    merged size within the conservative ``capacity/chunk_divisor`` mover
    ceiling.  Each run also re-checks convergence against its *first*
    member, so a slowly drifting density cannot chain A~B, B~C into a
    merged A..C with A and C far apart.

    Per-phase chunk references are conserved exactly: a merged chunk's
    count is the sum of its members' (the property tests pin this).
    Returns ``{parent: (chunks_before, chunks_after)}`` for every parent
    that changed."""
    coarse = max(1, fast_capacity // chunk_divisor)
    out: Dict[str, Tuple[int, int]] = {}
    parents = sorted({o.parent for o in registry if o.parent is not None})
    for parent in parents:
        # histogram check first: it is O(profiled phases) while chunk_spans
        # scans the whole registry, and most parents have no measured
        # densities on any given tick
        phase_bins = (profiler.object_bins(parent)
                      if profiler is not None else {})
        if not phase_bins:
            continue        # no measured densities: nothing to judge by
        spans = chunk_spans(registry, parent)
        if len(spans) < 2:
            continue
        if any(c.payload is not None for c, _, _ in spans):
            continue        # physical slices: re-joining would copy
        total = spans[-1][2] or 1
        # per-phase per-byte density of each chunk (mass / byte fraction;
        # the parent's uniform density is 1.0 on this scale)
        dens = {phi: [bin_mass(bins, lo / total, hi / total)
                      / max((hi - lo) / total, 1e-300)
                      for _, lo, hi in spans]
                for phi, bins in sorted(phase_bins.items())}

        def converged(i: int, j: int) -> bool:
            for dd in dens.values():
                a, b = dd[i], dd[j]
                hi_ = max(a, b)
                if hi_ <= cold_floor:
                    continue            # both converged-cold in this phase
                if abs(a - b) > tol * hi_:
                    return False
            return True

        runs: List[List[int]] = []
        cur = [0]
        for k in range(1, len(spans)):
            run_size = spans[k][2] - spans[cur[0]][1]
            if (spans[k][0].tier == spans[cur[0]][0].tier
                    and run_size <= coarse
                    and converged(cur[-1], k) and converged(cur[0], k)):
                cur.append(k)
            else:
                runs.append(cur)
                cur = [k]
        runs.append(cur)
        if all(len(r) == 1 for r in runs):
            continue

        # rebuild the parent's chunking from the merged runs
        merged_refs: List[Dict[int, float]] = []
        specs = []
        for run in runs:
            members = [spans[i][0] for i in run]
            lo, hi = spans[run[0]][1], spans[run[-1]][2]
            specs.append((hi - lo, members[0].tier, members[0].pinned))
            refs: Dict[int, float] = {}
            for ph in graph:
                s = 0.0
                present = False
                for m in members:
                    if m.name in ph.refs:
                        present = True
                        s += ph.refs[m.name]
                if present:
                    refs[ph.index] = s
            merged_refs.append(refs)
        for c, _, _ in spans:
            for ph in graph:
                ph.refs.pop(c.name, None)
            registry.remove(c.name)
        for k, (size, tier, pinned) in enumerate(specs):
            registry.register(DataObject(
                name=f"{parent}#{k}", size_bytes=size, chunkable=False,
                parent=parent, chunk_index=k, tier=tier, pinned=pinned))
            for phi, r in merged_refs[k].items():
                graph[phi].refs[f"{parent}#{k}"] = r
        out[parent] = (len(spans), len(runs))
    return out


# ---------------------------------------------------------------------------
# hot-chunk re-splitting (multi-resolution mode)
# ---------------------------------------------------------------------------
def resplit_hot_chunks(registry: ObjectRegistry, graph: PhaseGraph,
                       profiler: Optional[PhaseProfiler],
                       fast_capacity: int, *, chunk_divisor: int = 4,
                       tol: float = 0.15, max_chunks: int = 64,
                       min_chunk_divisor: int = 64,
                       leaf_aligned: bool = False
                       ) -> Dict[str, Tuple[int, int]]:
    """Re-split existing chunks whose measured densities turned imbalanced.

    Bisection only runs when a parent is first partitioned, and
    :func:`coalesce_chunks` only ever merges — so when drift re-heats a
    merged (or originally coarse) chunk, nothing re-cuts it and its hot
    head stays smeared across the whole chunk.  With multi-resolution
    histograms the refined bin edges *can* resolve sub-chunk structure;
    this pass walks every partitioned parent's chunks and re-splits any
    chunk whose measured per-phase mass is imbalanced beyond ``tol``
    (worst-imbalance-first, min-chunk floor bounded by the finest local
    bin, parent chunk count capped at ``max_chunks``).

    Sub-chunks inherit the split chunk's tier/pinned state, and the split
    chunk's per-phase reference counts are conserved exactly — distributed
    over its sub-chunks by measured histogram mass (size fractions when a
    phase has no histogram).  Returns ``{parent: (before, after)}`` for
    every parent that changed.

    ``leaf_aligned`` makes the pass a **no-op**: leaf-aligned chunks are
    whole-array units by contract, a midpoint bisection would cut inside
    a leaf (exactly the sub-leaf copies the flag forbids), and the
    parent's leaf spans are no longer recorded after partitioning, so
    cuts cannot be re-snapped.  (Recording per-chunk leaf spans to allow
    leaf-granular re-splits is a follow-on.)"""
    if leaf_aligned:
        return {}
    coarse = max(1, fast_capacity // chunk_divisor)
    floor = max(coarse // min_chunk_divisor, 1)
    out: Dict[str, Tuple[int, int]] = {}
    parents = sorted({o.parent for o in registry if o.parent is not None})
    for parent in parents:
        spans = chunk_spans(registry, parent)
        if not spans:
            continue
        if any(c.payload is not None for c, _, _ in spans):
            continue        # physical slices: re-cutting would copy
        phase_bins = (profiler.object_bins(parent)
                      if profiler is not None else {})
        bins = _clean_bins(list(phase_bins.values()))
        if not bins:
            continue        # no measured densities: nothing to judge by
        size = spans[-1][2] or 1

        def imbalance(lo: int, mid: int, hi: int) -> float:
            worst = 0.0
            for b in bins:
                seg = bin_mass(b, lo / size, hi / size)
                if seg <= 1e-12:
                    continue
                left = bin_mass(b, lo / size, mid / size)
                worst = max(worst, abs(2.0 * left - seg) / seg)
            return worst

        budget = max_chunks - len(spans)
        sub_bounds: Dict[str, List[int]] = {}
        # allocate the parent-wide split budget worst-imbalance-first
        # across chunks (span order would let an early, mildly imbalanced
        # chunk starve the re-heated one this pass exists for)
        def chunk_imb(lo: int, hi: int) -> float:
            mid = lo + (hi - lo) // 2
            return imbalance(lo, mid, hi) if mid > lo and mid < hi else 0.0

        for c, lo, hi in sorted(spans,
                                key=lambda s_: (-chunk_imb(s_[1], s_[2]),
                                                s_[1])):
            if budget <= 0:
                break
            cuts = _mr_boundaries(
                size, bins, imbalance, lo, hi, coarse_bytes=coarse,
                min_chunk_bytes=floor, tol=tol,
                max_chunks=min(budget + 1, max_chunks))
            if len(cuts) > 1:
                sub_bounds[c.name] = cuts
                budget -= len(cuts) - 1
        if not sub_bounds:
            continue

        # rebuild the parent's chunking with the re-split chunks expanded
        specs: List[Tuple[int, str, bool]] = []
        merged_refs: List[Dict[int, float]] = []
        for c, lo, hi in spans:
            cuts = sub_bounds.get(c.name, [hi])
            seg_lo = lo
            for cut in cuts:
                specs.append((cut - seg_lo, c.tier, c.pinned))
                refs: Dict[int, float] = {}
                for phi in range(len(graph)):
                    ph = graph[phi]
                    if c.name not in ph.refs:
                        continue
                    total_ref = ph.refs[c.name]
                    b = phase_bins.get(phi)
                    chunk_m = (bin_mass(b, lo / size, hi / size)
                               if b is not None else 0.0)
                    if b is not None and chunk_m > 1e-300:
                        frac = bin_mass(b, seg_lo / size,
                                        cut / size) / chunk_m
                    else:
                        frac = (cut - seg_lo) / max(hi - lo, 1)
                    r = total_ref * frac
                    if r > 0.0:
                        refs[phi] = r
                merged_refs.append(refs)
                seg_lo = cut
        for c, _, _ in spans:
            for ph in graph:
                ph.refs.pop(c.name, None)
            registry.remove(c.name)
        for k, (sz, tier, pinned) in enumerate(specs):
            registry.register(DataObject(
                name=f"{parent}#{k}", size_bytes=sz, chunkable=False,
                parent=parent, chunk_index=k, tier=tier, pinned=pinned))
            for phi, r in merged_refs[k].items():
                graph[phi].refs[f"{parent}#{k}"] = r
        out[parent] = (len(spans), len(specs))
    return out


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------
def auto_partition(registry: ObjectRegistry, graph: PhaseGraph,
                   fast_capacity: int, *, chunk_divisor: int = 4,
                   profiler: Optional[PhaseProfiler] = None,
                   skew_aware: bool = True,
                   max_chunks: int = 64,
                   leaf_aligned: bool = False,
                   multi_res: bool = False) -> List[str]:
    """Chunk each chunkable object that cannot fit the fast tier.

    With measured per-object histograms (``profiler`` given and the object
    observed with per-chunk attribution) and ``skew_aware``, boundaries come
    from :func:`skew_boundaries`; otherwise the paper's conservative equal
    split into ``capacity/chunk_divisor``-byte chunks.  With ``multi_res``
    (refined multi-resolution histograms), the bisection allocates splits
    worst-imbalance-first and its min-chunk floor is bounded by the finest
    *local* measured bin instead of a global constant — hot-head chunks can
    cut below the legacy one-bin ceiling.  With ``leaf_aligned`` and a
    pytree-registered object, cuts snap to the nearest leaf boundary
    (chunks moveable as whole arrays).  Per-phase references are
    re-attributed from the same histograms (:func:`resplit_refs`)."""
    coarse = max(1, fast_capacity // chunk_divisor)
    partitioned = []
    for name in list(registry.names()):
        obj = registry[name]
        if not should_partition(obj, fast_capacity):
            continue
        phase_bins = (list(profiler.object_bins(name).values())
                      if profiler is not None else [])
        if skew_aware and phase_bins:
            min_chunk = (max(coarse // 64, 1) if multi_res
                         else max(coarse // 16, 1))
            bounds = skew_boundaries(
                obj.size_bytes, phase_bins, coarse_bytes=coarse,
                min_chunk_bytes=min_chunk, max_chunks=max_chunks,
                local_floor=multi_res)
        else:
            n_chunks = max(1, math.ceil(obj.size_bytes / coarse))
            bounds = [min((i + 1) * coarse, obj.size_bytes)
                      for i in range(n_chunks)]
        if leaf_aligned and obj.leaf_spans:
            bounds = snap_to_leaf_boundaries(bounds, obj.leaf_spans,
                                             obj.size_bytes)
        chunks = partition_object_spans(registry, name, bounds)
        if len(chunks) > 1:
            partitioned.append(name)
    if partitioned:
        resplit_refs(graph, registry, profiler)
    return partitioned
