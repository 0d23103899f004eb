"""NPB-inspired phase workloads (paper §4, Table 3) and LM training traces.

These are phase/data-object traces whose structure mirrors the paper's
benchmarks: same target data objects (Table 3), same phase anatomy (compute
phases delimited by communication), CLASS-C-per-rank object sizes (4 ranks),
and the access-pattern mix that produced the paper's Observation 3 (e.g.
SP's ``in_buffer/out_buffer`` bandwidth-sensitive, ``lhs`` latency-sensitive,
``rhs`` both).  ``passes`` encodes cache filtering: only traffic that reaches
main memory counts (the paper's LLC-miss counters measure the same thing).

``lm_train_workload`` derives the same kind of trace from a transformer
training step (per-layer phases; weight/optimizer/activation objects) — the
production use of the runtime on accelerator memory tiers.
"""

from __future__ import annotations

from typing import Dict, List

from ..core.faults import FaultSpec
from .engine import SimObjectAccess, SimPhaseSpec, SimWorkload

MB = 1024 ** 2
LINE = 64


def _acc(size_bytes: float, passes: float = 1.0, stream: float = 1.0,
         density: List[float] = None) -> SimObjectAccess:
    """Touch ``passes`` full main-memory sweeps over an object."""
    return SimObjectAccess(accesses=passes * size_bytes / LINE,
                           stream_fraction=stream, density=density)


def power_law_density(n_bins: int = 64, alpha: float = 1.2,
                      seed: int = None) -> List[float]:
    """Zipf-like access density over an object's byte range: bin ``i`` gets
    weight ``(i+1)^-alpha`` — the shape of power-law degree distributions
    (a few high-degree vertices absorb most gather traffic).

    ``seed`` permutes the bins: without an offline degree-sort of the vertex
    array (which a runtime system does not get to assume), the hot vertices
    are scattered across the address range — the case where only *measured*
    per-chunk attribution can find them."""
    import numpy as np
    w = np.array([(i + 1.0) ** -alpha for i in range(n_bins)])
    if seed is not None:
        w = w[np.random.default_rng(seed).permutation(n_bins)]
    return list(w)


# ---------------------------------------------------------------------------
def cg_like(scale: float = 1.0) -> SimWorkload:
    """Conjugate-gradient (paper Fig 1): SpMV + dot/axpy phases.

    CLASS-C/4-rank sizes: the whole target set (~170 MB) fits the 256 MB
    fast tier -> cross-phase global search recovers nearly all of the gap
    (paper Fig 11: >90% of CG's win comes from global search)."""
    s = scale
    objects = {
        "a": int(110 * MB * s), "colidx": int(55 * MB * s),
        "rowstr": int(1 * MB * s), "p": int(2 * MB * s),
        "q": int(2 * MB * s), "r": int(2 * MB * s),
        "z": int(2 * MB * s), "w": int(2 * MB * s), "x": int(2 * MB * s),
    }
    o = objects
    phases = [
        SimPhaseSpec("spmv_q=Ap", 0.020, {
            "a": _acc(o["a"], 1.0, 1.0),            # streamed matrix values
            "colidx": _acc(o["colidx"], 1.0, 1.0),
            "rowstr": _acc(o["rowstr"], 1.0, 1.0),
            # indirect x[colidx[j]] gathers: mostly LLC-resident at CLASS C,
            # the misses that escape are dependent loads (chase)
            "p": _acc(o["p"], 6.0, 0.0),
            "q": _acc(o["q"], 1.0, 1.0),
        }),
        SimPhaseSpec("comm_reduce_q", 0.004, {"q": _acc(o["q"], 1.0, 1.0)}),
        SimPhaseSpec("dot_pq", 0.002, {
            "p": _acc(o["p"], 1.0, 1.0), "q": _acc(o["q"], 1.0, 1.0)}),
        SimPhaseSpec("axpy_zr", 0.002, {
            "z": _acc(o["z"], 2.0, 1.0), "r": _acc(o["r"], 2.0, 1.0),
            "p": _acc(o["p"], 1.0, 1.0), "q": _acc(o["q"], 1.0, 1.0)}),
        SimPhaseSpec("norm_comm", 0.003, {"r": _acc(o["r"], 1.0, 1.0)}),
        SimPhaseSpec("update_px", 0.002, {
            "p": _acc(o["p"], 2.0, 1.0), "r": _acc(o["r"], 1.0, 1.0),
            "x": _acc(o["x"], 2.0, 1.0)}),
    ]
    return SimWorkload("cg", phases, objects)


def ft_like(scale: float = 1.0) -> SimWorkload:
    """3-D FFT: few huge streamed arrays (512 MB each per rank at CLASS
    C/4); none fits the fast tier whole -> the one workload where 1-D
    chunk partitioning pays off (paper Fig 11: 58% of FT's win)."""
    s = scale
    objects = {
        "u": int(8 * MB * s), "u0": int(512 * MB * s),
        "u1": int(512 * MB * s), "u2": int(512 * MB * s),
        "twiddle": int(64 * MB * s),
    }
    o = objects
    phases = [
        SimPhaseSpec("evolve", 0.090, {
            "u0": _acc(o["u0"], 0.5, 1.0), "u1": _acc(o["u1"], 0.5, 1.0),
            "twiddle": _acc(o["twiddle"], 1.0, 1.0)}),
        SimPhaseSpec("fft_z", 0.130, {
            # grid arrays are streamed, cache-blocked (0.5 main-memory
            # passes); the roots-of-unity table u is accessed dependently
            # -> latency-sensitive
            "u1": _acc(o["u1"], 0.5, 1.0), "u": _acc(o["u"], 4.0, 0.0)}),
        SimPhaseSpec("transpose_comm", 0.020, {
            "u1": _acc(o["u1"], 0.5, 1.0), "u2": _acc(o["u2"], 0.5, 1.0)}),
        SimPhaseSpec("fft_xy", 0.130, {
            "u2": _acc(o["u2"], 0.5, 1.0), "u": _acc(o["u"], 4.0, 0.0)}),
        SimPhaseSpec("checksum_comm", 0.005, {"u2": _acc(o["u2"], 0.1, 1.0)}),
    ]
    return SimWorkload("ft", phases, objects,
                       chunkable={"u0": True, "u1": True, "u2": True})


def _sweep_workload(name: str, scale: float, lhs_stream: float,
                    lhs_objects: Dict[str, float], buf_mb: float,
                    per_sweep_objects: Dict[str, tuple] = None
                    ) -> SimWorkload:
    """Shared structure for BT/SP: rhs + x/y/z sweeps with per-sweep hot
    sets (the per-phase variation that makes local search pay off)."""
    s = scale
    per_sweep_objects = per_sweep_objects or {}
    objects = {
        "u": int(42 * MB * s), "rhs": int(42 * MB * s),
        "forcing": int(42 * MB * s), "us": int(9 * MB * s),
        "vs": int(9 * MB * s), "ws": int(9 * MB * s),
        "qs": int(9 * MB * s), "rho_i": int(9 * MB * s),
        "square": int(9 * MB * s),
        "in_buffer": int(buf_mb * MB * s), "out_buffer": int(buf_mb * MB * s),
    }
    for lname, lmb in lhs_objects.items():
        objects[lname] = int(lmb * MB * s)
    for axis, (jname, jmb) in per_sweep_objects.items():
        objects[jname] = int(jmb * MB * s)
    o = objects
    def sweep(axis: str, extra: Dict[str, SimObjectAccess]) -> SimPhaseSpec:
        base = {
            "rhs": _acc(o["rhs"], 3.0, 0.5),          # both bw and lat
            "u": _acc(o["u"], 1.0, 1.0),
        }
        for lname in lhs_objects:                      # factorization arrays
            base[lname] = _acc(o[lname], 1.0, lhs_stream)
        if axis in per_sweep_objects:                  # this sweep's jacobian
            jname = per_sweep_objects[axis][0]
            base[jname] = _acc(o[jname], 1.0, lhs_stream)
        base.update(extra)
        return SimPhaseSpec(f"{axis}_solve", 0.030, base)
    phases = [
        SimPhaseSpec("compute_rhs", 0.030, {
            "u": _acc(o["u"], 2.0, 1.0), "rhs": _acc(o["rhs"], 2.0, 1.0),
            "forcing": _acc(o["forcing"], 1.0, 1.0),
            "us": _acc(o["us"], 1.0, 1.0), "vs": _acc(o["vs"], 1.0, 1.0),
            "ws": _acc(o["ws"], 1.0, 1.0), "qs": _acc(o["qs"], 1.0, 1.0),
            "rho_i": _acc(o["rho_i"], 1.0, 1.0),
            "square": _acc(o["square"], 1.0, 1.0)}),
        sweep("x", {"us": _acc(o["us"], 4.0, 1.0)}),
        SimPhaseSpec("x_comm", 0.008, {
            "in_buffer": _acc(o["in_buffer"], 4.0, 1.0),
            "out_buffer": _acc(o["out_buffer"], 4.0, 1.0)}),
        sweep("y", {"vs": _acc(o["vs"], 4.0, 1.0)}),
        SimPhaseSpec("y_comm", 0.008, {
            "in_buffer": _acc(o["in_buffer"], 4.0, 1.0),
            "out_buffer": _acc(o["out_buffer"], 4.0, 1.0)}),
        sweep("z", {"ws": _acc(o["ws"], 4.0, 1.0)}),
        SimPhaseSpec("add_update", 0.010, {
            "u": _acc(o["u"], 2.0, 1.0), "rhs": _acc(o["rhs"], 1.0, 1.0)}),
    ]
    return SimWorkload(name, phases, objects)


def bt_like(scale: float = 1.0) -> SimWorkload:
    # block-tridiagonal: per-sweep jacobian/factor workspaces (Table 3:
    # fjac/njac/lhsa/lhsb/lhsc) are hot only in their own sweep -> the
    # rotating hot set that phase-local search exploits (paper Fig 11:
    # BT +19% from local search).
    return _sweep_workload(
        "bt", scale, lhs_stream=0.6,
        lhs_objects={}, buf_mb=12,
        per_sweep_objects={"x": ("fjac_x", 70), "y": ("njac_y", 70),
                           "z": ("lhs_z", 70)})


def sp_like(scale: float = 1.0) -> SimWorkload:
    # scalar-pentadiagonal: lhs latency-sensitive (paper Fig 4), buffers hot
    return _sweep_workload("sp", scale, lhs_stream=0.0,
                           lhs_objects={"lhs": 120}, buf_mb=24)


def lu_like(scale: float = 1.0) -> SimWorkload:
    """SSOR: lower/upper sweeps touch the same hot arrays every phase ->
    cross-phase global placement wins (paper Fig 11: >90% for LU)."""
    s = scale
    objects = {
        "u": int(42 * MB * s), "rsd": int(42 * MB * s),
        "frct": int(42 * MB * s), "flux": int(9 * MB * s),
        "abcd": int(680 * MB * s), "buf": int(6 * MB * s),
    }
    o = objects
    phases = [
        SimPhaseSpec("rhs", 0.030, {
            "rsd": _acc(o["rsd"], 3.0, 1.0), "frct": _acc(o["frct"], 1.0, 1.0),
            "flux": _acc(o["flux"], 4.0, 1.0), "u": _acc(o["u"], 2.0, 1.0)}),
        SimPhaseSpec("lower_sweep", 0.040, {
            "rsd": _acc(o["rsd"], 3.0, 0.3), "abcd": _acc(o["abcd"], 0.15, 1.0),
            "u": _acc(o["u"], 1.0, 1.0)}),
        SimPhaseSpec("lower_comm", 0.005, {"buf": _acc(o["buf"], 2.0, 1.0)}),
        SimPhaseSpec("upper_sweep", 0.040, {
            "rsd": _acc(o["rsd"], 3.0, 0.3), "abcd": _acc(o["abcd"], 0.15, 1.0),
            "u": _acc(o["u"], 1.0, 1.0)}),
        SimPhaseSpec("upper_comm", 0.005, {"buf": _acc(o["buf"], 2.0, 1.0)}),
        SimPhaseSpec("update_u", 0.010, {
            "u": _acc(o["u"], 2.0, 1.0), "rsd": _acc(o["rsd"], 1.0, 1.0)}),
    ]
    return SimWorkload("lu", phases, objects)


def mg_like(scale: float = 1.0) -> SimWorkload:
    """Multigrid V-cycle: 256 MB grids per rank that cannot fit the fast
    tier; stencil locality keeps main-memory traffic low -> small inherent
    gap, one small migration (paper Table 4: MG moved 17 MB once)."""
    s = scale
    objects = {"buff": int(20 * MB * s), "u": int(120 * MB * s),
               "v": int(120 * MB * s), "r": int(120 * MB * s)}
    o = objects
    phases = [
        SimPhaseSpec("resid", 0.050, {
            "u": _acc(o["u"], 0.3, 0.85), "v": _acc(o["v"], 0.3, 1.0),
            "r": _acc(o["r"], 0.3, 0.85)}),
        SimPhaseSpec("rprj_down", 0.030, {"r": _acc(o["r"], 0.4, 0.85)}),
        SimPhaseSpec("comm_halo", 0.008, {"buff": _acc(o["buff"], 3.0, 1.0)}),
        SimPhaseSpec("psinv_up", 0.050, {
            "r": _acc(o["r"], 0.3, 0.85), "u": _acc(o["u"], 0.4, 0.85)}),
        SimPhaseSpec("interp", 0.030, {
            "u": _acc(o["u"], 0.3, 1.0), "v": _acc(o["v"], 0.2, 1.0)}),
    ]
    return SimWorkload("mg", phases, objects, chunkable={"u": True, "r": True})


def nek_like(scale: float = 1.0, n_vars: int = 48) -> SimWorkload:
    """Nek5000-eddy-like: many simulation variables + geometry arrays with
    phase-varying hot sets (the workload where adaptivity matters; paper
    Table 4: 102 migrations, 1.1 GB moved, 70.6% overlapped)."""
    s = scale
    objects: Dict[str, int] = {}
    for i in range(n_vars):
        objects[f"v{i:02d}"] = int((4 + (i * 5) % 28) * MB * s)
    objects["geom"] = int(200 * MB * s)
    phases: List[SimPhaseSpec] = []
    for p in range(8):
        touches: Dict[str, SimObjectAccess] = {
            "geom": _acc(objects["geom"], 0.2, 1.0)}
        for i in range(n_vars):
            if (i + p) % 4 == 0:    # rotating hot set across phases
                stream = 1.0 if i % 3 else 0.3
                touches[f"v{i:02d}"] = _acc(objects[f"v{i:02d}"], 4.0, stream)
        phases.append(SimPhaseSpec(f"nek_phase{p}", 0.020, touches))
        if p % 3 == 2:
            phases.append(SimPhaseSpec(
                f"nek_comm{p}", 0.005,
                {"v00": _acc(objects["v00"], 0.5, 1.0)}))
    return SimWorkload("nek5000", phases, objects)


NPB_WORKLOADS = {
    "cg": cg_like, "ft": ft_like, "bt": bt_like,
    "lu": lu_like, "sp": sp_like, "mg": mg_like, "nek5000": nek_like,
}


# ---------------------------------------------------------------------------
# scenario matrix — steady-state migration-churn workloads for the
# slack-aware async scheduler (beyond the paper's one-shot NPB placements).
# Each scenario's per-phase hot set exceeds the fast tier, so movement
# recurs every iteration and the mover's overlap quality shows up directly
# in steady-state iteration time.
# ---------------------------------------------------------------------------
def kv_serving(scale: float = 1.0, n_blocks: int = 12, n_phases: int = 12,
               window: int = 3) -> SimWorkload:
    """Serving-style KV-cache growth: decode phases over a growing context.

    One weights object is hot in every phase; the KV cache is two rings of
    fixed-size blocks (keys and values) whose hot *window* — the blocks
    holding the most recent tokens — slides one block per decode phase,
    while long-context attention keeps touching the deep history lightly
    (blocks three-to-five positions behind the window; the pair that just
    left the window goes briefly cold, so it is evictable).  The window
    plus weights exceed the fast tier, so every phase boundary pairs two
    fetches (one K, one V block) with two evictions — the FIFO mover
    serializes all four copies on the critical path; the slack scheduler
    keeps evictions off the fence and runs the fetches on concurrent
    channels."""
    s = scale
    blk = int(24 * MB * s)
    objects: Dict[str, int] = {"w": int(96 * MB * s)}
    for b in range(n_blocks):
        objects[f"k{b:02d}"] = blk
        objects[f"v{b:02d}"] = blk
    phases: List[SimPhaseSpec] = []
    for p in range(n_phases):
        touches: Dict[str, SimObjectAccess] = {
            "w": _acc(objects["w"], 1.0, 1.0)}
        hot = [(p + k) % n_blocks for k in range(window)]
        for b in hot:           # recent-token attention: bandwidth-bound
            touches[f"k{b:02d}"] = _acc(blk, 4.0, 1.0)
            touches[f"v{b:02d}"] = _acc(blk, 4.0, 1.0)
        for back in range(3, 6):
            b = (p - back) % n_blocks
            if b not in hot:    # deep-history attention, cache-filtered
                touches[f"k{b:02d}"] = _acc(blk, 0.1, 1.0)
                touches[f"v{b:02d}"] = _acc(blk, 0.1, 1.0)
        phases.append(SimPhaseSpec(f"decode{p}", 0.008, touches))
    return SimWorkload("kv_serving", phases, objects)


def moe_expert_churn(scale: float = 1.0, n_experts: int = 16,
                     n_phases: int = 8) -> SimWorkload:
    """MoE expert working-set churn: routed token groups activate a rotating
    expert pair each phase.

    Experts are only referenced in the phase that routes to them, so their
    copy window spans nearly the whole iteration — but the fast tier only
    holds four experts beside the shared trunk, so each boundary still
    pairs two fetches with two evictions.  Expert GEMMs are mixed-
    sensitivity (irregular token gather/scatter), the router table is pure
    pointer chasing."""
    s = scale
    ex = int(40 * MB * s)
    objects: Dict[str, int] = {"shared": int(64 * MB * s),
                               "router": int(4 * MB * s)}
    for e in range(n_experts):
        objects[f"exp{e:02d}"] = ex
    phases: List[SimPhaseSpec] = []
    for p in range(n_phases):
        touches: Dict[str, SimObjectAccess] = {
            "shared": _acc(objects["shared"], 1.5, 1.0),
            "router": _acc(objects["router"], 2.0, 0.0),
        }
        for e in ((2 * p) % n_experts, (2 * p + 1) % n_experts):
            touches[f"exp{e:02d}"] = _acc(ex, 4.0, 0.35)
        phases.append(SimPhaseSpec(f"route{p}", 0.012, touches))
    return SimWorkload("moe_churn", phases, objects)


def graph_chase(scale: float = 1.0) -> SimWorkload:
    """Pointer-chasing graph analytics with two adjacency shards.

    The frontier is dependent-load bound (pure chasing); the two adjacency
    shards are large, chunkable, and each hot in its own gather phase — the
    shard swap each iteration moves ~6 chunks through the copy engine, and
    chunk-granular double buffering lets the gather consume early chunks
    while later ones are still in flight."""
    s = scale
    objects = {
        "frontier": int(16 * MB * s),
        "visited": int(32 * MB * s),
        "adjA": int(320 * MB * s),
        "adjB": int(320 * MB * s),
    }
    o = objects
    phases = [
        SimPhaseSpec("gatherA", 0.020, {
            "adjA": _acc(o["adjA"], 3.0, 0.85),
            "frontier": _acc(o["frontier"], 0.5, 0.0),
        }),
        SimPhaseSpec("gatherB", 0.020, {
            "adjB": _acc(o["adjB"], 3.0, 0.85),
            "frontier": _acc(o["frontier"], 0.5, 0.0),
        }),
        SimPhaseSpec("apply", 0.008, {
            "visited": _acc(o["visited"], 4.0, 0.6),
            "frontier": _acc(o["frontier"], 1.0, 0.0),
        }),
    ]
    return SimWorkload("graph_chase", phases, objects,
                       chunkable={"adjA": True, "adjB": True})


def graph_chase_skewed(scale: float = 1.0, alpha: float = 1.3,
                       seed: int = 7, density_bins: int = 64) -> SimWorkload:
    """Power-law graph analytics over two oversized adjacency shards.

    Each 640 MB shard's gather traffic follows a permuted power-law density
    (exponent ``alpha``): a few scattered hot regions — high-degree vertex
    neighborhoods, *not* sorted to the array head — absorb most accesses.
    With uniform attribution every equal chunk looks identically warm, so
    the planner cycles whole shards through the fast tier; with measured
    per-chunk attribution, skew-aware bisection isolates the hot regions
    and the knapsack keeps exactly them resident, cutting migration traffic
    and steady-state time.

    ``density_bins`` sets the *true* density's native resolution.  Above
    the profiler's bin budget (64 by default) the truth carries structure
    a fixed-width measured histogram cannot resolve — the regime where
    adaptive multi-resolution refinement (``RuntimeConfig.
    histogram_refine``) pays: hot-head bins refine below one legacy bin
    while the cold tail coarsens."""
    s = scale
    objects = {
        "frontier": int(16 * MB * s),
        "visited": int(32 * MB * s),
        "adjA": int(640 * MB * s),
        "adjB": int(640 * MB * s),
    }
    o = objects
    dens_a = power_law_density(density_bins, alpha, seed=seed)
    dens_b = power_law_density(density_bins, alpha, seed=seed + 1)
    phases = [
        SimPhaseSpec("gatherA", 0.020, {
            "adjA": _acc(o["adjA"], 3.0, 0.85, density=dens_a),
            "frontier": _acc(o["frontier"], 0.5, 0.0),
        }),
        SimPhaseSpec("gatherB", 0.020, {
            "adjB": _acc(o["adjB"], 3.0, 0.85, density=dens_b),
            "frontier": _acc(o["frontier"], 0.5, 0.0),
        }),
        SimPhaseSpec("apply", 0.008, {
            "visited": _acc(o["visited"], 4.0, 0.6),
            "frontier": _acc(o["frontier"], 1.0, 0.0),
        }),
    ]
    return SimWorkload("graph_chase_skew", phases, objects,
                       chunkable={"adjA": True, "adjB": True})


def kv_serving_skewed(scale: float = 1.0, n_blocks: int = 12,
                      n_phases: int = 12, window: int = 3,
                      sub: int = 1, taper: float = 0.62) -> SimWorkload:
    """KV-cache serving with the cache as two monolithic chunkable rings.

    Same access anatomy as :func:`kv_serving`, but the keys and values are
    single large registered objects (``kcache``/``vcache``) — the realistic
    allocation for a paged cache arena — so the *runtime* must discover the
    block structure: each decode phase's access density over the ring has a
    sharp sliding hot window (recent tokens, 4 passes) and a light
    deep-history band (0.1 passes).  Without per-chunk attribution every
    equal chunk looks identically warm and the planner cannot place the
    window; with it, skew-aware bisection cuts the ring along the measured
    per-phase density edges and the local search prefetches exactly the
    window chunks.

    ``sub > 1`` resolves the true density *within* each block at ``sub``
    sub-bins: a hot block's mass tapers geometrically (``taper``) from its
    head — the recent-token gradient inside a block — so the truth carries
    structure finer than one block.  A fixed-width measured histogram at
    block granularity smears it; adaptive multi-resolution refinement
    resolves the intra-block head and lets hot chunks shrink below one
    legacy bin."""
    s = scale
    blk = int(24 * MB * s)
    cache = blk * n_blocks
    objects: Dict[str, int] = {"w": int(96 * MB * s),
                               "kcache": cache, "vcache": cache}

    def expand(weights: List[float]) -> List[float]:
        if sub <= 1:
            return list(weights)
        g = [taper ** k for k in range(sub)]
        gs = sum(g)
        out: List[float] = []
        for w in weights:
            if w >= 1.0:        # hot block: recent-token head gradient
                out.extend(w * sub * gk / gs for gk in g)
            else:               # deep history / cold: flat within the block
                out.extend(w for _ in range(sub))
        return out

    phases: List[SimPhaseSpec] = []
    for p in range(n_phases):
        weights = [0.0] * n_blocks
        hot = [(p + k) % n_blocks for k in range(window)]
        for b in hot:
            weights[b] = 4.0
        for back in range(3, 6):
            b = (p - back) % n_blocks
            if b not in hot:
                weights[b] = 0.1
        total_passes = sum(weights)
        acc = total_passes * blk / LINE
        dens = expand(weights)
        touches: Dict[str, SimObjectAccess] = {
            "w": _acc(objects["w"], 1.0, 1.0),
            "kcache": SimObjectAccess(accesses=acc, stream_fraction=1.0,
                                      density=dens),
            "vcache": SimObjectAccess(accesses=acc, stream_fraction=1.0,
                                      density=list(dens)),
        }
        phases.append(SimPhaseSpec(f"decode{p}", 0.008, touches))
    return SimWorkload("kv_serving_skew", phases, objects,
                       chunkable={"kcache": True, "vcache": True})


def paged_attention(scale: float = 1.0, n_pages: int = 28,
                    page_mb: float = 12.0, n_requests: int = 8,
                    n_phases: int = 12, active: int = 3,
                    seed: int = 11) -> SimWorkload:
    """Paged-attention serving: variable-length requests over a paged KV
    arena (a serving trace).

    The KV cache is one monolithic chunkable arena of ``n_pages``
    fixed-size pages.  Requests have *variable lengths* (2–6 pages) and a
    paged allocator hands them whatever pages are free: page assignment is
    a seeded permutation of the arena, so a request's pages are scattered —
    no spatial locality, exactly like a production paged-KV allocator
    after churn.  Each decode phase serves a rotating window of ``active``
    requests; a request's two most recent pages absorb the dense
    recent-token attention (4 main-memory passes) while its older pages see
    only the light deep-history band (0.15 passes).  The page table is
    dependent-load indirection (pure chasing) and the weights are hot
    every phase.

    Uniform chunk attribution sees a uniformly-warm 336 MB arena that
    cannot fit the fast tier; only measured per-chunk attribution can find
    the scattered active pages, so this workload exercises the full
    hot-chunk pipeline under paging-induced fragmentation."""
    import numpy as np
    s = scale
    page = int(page_mb * MB * s)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_pages)
    lengths = 2 + rng.integers(0, 5, size=n_requests)      # 2..6 pages
    pages: Dict[int, List[int]] = {}
    cur = 0
    for r in range(n_requests):
        pages[r] = [int(perm[(cur + k) % n_pages])
                    for k in range(int(lengths[r]))]
        cur += int(lengths[r])
    objects = {"w": int(96 * MB * s), "page_table": int(4 * MB * s),
               "kv_arena": page * n_pages}
    phases: List[SimPhaseSpec] = []
    for p in range(n_phases):
        weights = [0.0] * n_pages
        for j in range(active):
            r = (p + j) % n_requests
            own = pages[r]
            for k, pg in enumerate(own):
                weights[pg] += 4.0 if k >= len(own) - 2 else 0.15
        acc = sum(weights) * page / LINE
        touches: Dict[str, SimObjectAccess] = {
            "w": _acc(objects["w"], 1.0, 1.0),
            "page_table": _acc(objects["page_table"], 2.0, 0.0),
            "kv_arena": SimObjectAccess(accesses=acc, stream_fraction=0.9,
                                        density=list(weights)),
        }
        phases.append(SimPhaseSpec(f"decode{p}", 0.008, touches))
    return SimWorkload("paged_serving", phases, objects,
                       chunkable={"kv_arena": True})


def fsdp_grad_buckets(scale: float = 1.0, n_layers: int = 6) -> SimWorkload:
    """FSDP-style gradient-bucket churn (a training trace).

    Fully-sharded training materializes per-layer state transiently: the
    forward pass all-gathers each layer's weights just in time; the
    backward pass revisits them in reverse and fills a per-layer *gradient
    bucket* that is reduce-scattered right after the layer's backward and
    then goes cold until the next iteration.  Optimizer shards are touched
    only in the trailing update phase.  The per-phase hot set is small
    (one layer's weights + one bucket) but rotates through every layer
    each iteration while the total state is ~3x the fast tier — the
    highest-churn scenario in the matrix: every phase boundary retires one
    bucket and prefetches the next layer's state, so the mover's
    eviction-off-the-fence and overlap quality dominate steady-state time.
    Weight gathers are bandwidth-bound; bucket reduction mixes in the
    irregular index traffic of the sharded reduce; optimizer math streams
    both its shard and the weights."""
    s = scale
    wb = int(44 * MB * s)           # one layer's gathered weights
    gb = int(44 * MB * s)           # its gradient bucket
    ob = int(26 * MB * s)           # its optimizer shard
    objects: Dict[str, int] = {"act_stash": int(48 * MB * s)}
    for i in range(n_layers):
        objects[f"w{i}"] = wb
        objects[f"g{i}"] = gb
        objects[f"opt{i}"] = ob
    phases: List[SimPhaseSpec] = []
    for i in range(n_layers):
        phases.append(SimPhaseSpec(f"fwd{i}", 0.010, {
            f"w{i}": _acc(wb, 2.0, 1.0),
            "act_stash": _acc(objects["act_stash"], 0.5, 1.0)}))
    for i in reversed(range(n_layers)):
        phases.append(SimPhaseSpec(f"bwd{i}", 0.014, {
            f"w{i}": _acc(wb, 2.0, 1.0),
            f"g{i}": _acc(gb, 3.0, 0.8),
            "act_stash": _acc(objects["act_stash"], 0.5, 1.0)}))
        phases.append(SimPhaseSpec(f"rs{i}", 0.004, {
            f"g{i}": _acc(gb, 2.0, 0.6)}))
    opt_touches: Dict[str, SimObjectAccess] = {}
    for i in range(n_layers):
        opt_touches[f"opt{i}"] = _acc(ob, 2.0, 1.0)
        opt_touches[f"w{i}"] = _acc(wb, 1.0, 1.0)
    phases.append(SimPhaseSpec("opt_update", 0.012, opt_touches))
    return SimWorkload("fsdp_buckets", phases, objects)


SCENARIO_WORKLOADS = {
    "kv_serving": kv_serving,
    "moe_churn": moe_expert_churn,
    "graph_chase": graph_chase,
    "fsdp_buckets": fsdp_grad_buckets,
}


# ---------------------------------------------------------------------------
# multi-tenant serving — the tenancy layer's target workload.
# Driven directly by ``bench_tenants`` (not part of SCENARIO_WORKLOADS: it
# needs per-tenant registration through ``rt.tenant()`` handles, which the
# generic scenario runner does not do).
# ---------------------------------------------------------------------------

#: tenant -> (priority, slo) for ``tenant_serving``.  Popularity across
#: tenants is Zipf-like: one whale absorbs most of the traffic, three mid
#: tenants split a thin tail, and one cold archive tenant barely shows up.
#: The whale's priority and the mids' tight SLO (0.75 = stricter latency
#: budget => more weight per unit priority) give fast-tier weights 8 : 4/3
#: : 1/2 — whale share 2/3 of capacity, mids 1/9 each.
TENANT_SERVING_QOS = {
    "whale": (8.0, 1.0),
    "m0": (1.0, 0.75),
    "m1": (1.0, 0.75),
    "m2": (1.0, 0.75),
    "cold": (0.5, 1.0),
}


def tenant_serving(scale: float = 1.0, n_rounds: int = 8,
                   whale_compute_s: float = 0.060) -> SimWorkload:
    """Multi-tenant KV-serving: one whale, three mid tenants, one cold.

    Each round interleaves one whale decode phase with one decode phase per
    mid tenant; a trailing archive scan touches the cold tenant's state.
    All object and phase names carry ``tenant/`` prefixes — the runtime's
    tenant namespaces — so per-tenant latency can be read straight off the
    phase trace.

    The QoS tension the bandwidth-partition policy has to resolve:

    * The *whale* is a long-context stream — big weights, a 12-position
      KV-block ring with a 2-wide hot window sliding one position per
      round, and deep-history attention over positions 2-3 behind it.
      Its per-phase working set (weights + 4 block pairs = 128 MB) just
      fits the whale's QoS share, so the partitioned solve can rotate
      the ring under the whale's compute-rich phases — but the ring's
      per-iteration sweep (~256 MB) dwarfs any share, and the deep
      history's per-byte traffic is *higher* than the mid tenants' hot
      windows, so an aggregate optimizer spends the last of the fast
      tier on whale ring blocks instead of mid windows.
    * The *mids* are short-context decoders whose phases are memory-bound:
      every byte of their hot window served from slow lands directly on
      their (small) phase time.  Starving them is cheap in aggregate time
      and catastrophic in per-tenant p99.
    * The *cold* tenant's archive sees ~0.05 sweeps/iteration — below any
      sensible admission heat floor; it should be demoted to
      serve-from-slow, not squat in fast capacity.
    """
    s = scale
    objects: Dict[str, int] = {}
    # whale: 64 MB weights + 12 K/V block pairs of 8 MB
    objects["whale/w"] = int(64 * MB * s)
    n_blk, blk = 12, int(8 * MB * s)
    for b in range(n_blk):
        objects[f"whale/k{b:02d}"] = blk
        objects[f"whale/v{b:02d}"] = blk
    # mids: 8 MB weights + 8 K/V block pairs of 3 MB each — hot set
    # (weights + 2-position window = 20 MB) sized to fit a mid tenant's
    # fast-tier share, so the partitioned solve can serve a mid fully
    m_blk_n, m_blk = 8, int(3 * MB * s)
    for m in range(3):
        objects[f"m{m}/w"] = int(8 * MB * s)
        for b in range(m_blk_n):
            objects[f"m{m}/k{b:02d}"] = m_blk
            objects[f"m{m}/v{b:02d}"] = m_blk
    objects["cold/archive"] = int(96 * MB * s)

    phases: List[SimPhaseSpec] = []
    for p in range(n_rounds):
        # whale decode: hot window @3.0 sweeps, deep history (2-3 positions
        # back) @2.5 — per-byte deep traffic ~5 sweeps/iter, above the mid
        # windows' ~4, so the aggregate knapsack prefers whale ring blocks
        # over mid hot windows once weights + windows are placed.
        touches: Dict[str, SimObjectAccess] = {
            "whale/w": _acc(objects["whale/w"], 1.0, 1.0)}
        hot = [(p + k) % n_blk for k in range(2)]
        for b in hot:
            touches[f"whale/k{b:02d}"] = _acc(blk, 3.0, 1.0)
            touches[f"whale/v{b:02d}"] = _acc(blk, 3.0, 1.0)
        for back in range(2, 4):
            b = (p - back) % n_blk
            if b not in hot:
                touches[f"whale/k{b:02d}"] = _acc(blk, 2.5, 1.0)
                touches[f"whale/v{b:02d}"] = _acc(blk, 2.5, 1.0)
        phases.append(SimPhaseSpec(f"whale/decode{p}", whale_compute_s,
                                   touches))
        # mid decodes: memory-bound (compute ~ fast-tier mem time)
        for m in range(3):
            mt: Dict[str, SimObjectAccess] = {
                f"m{m}/w": _acc(objects[f"m{m}/w"], 1.0, 1.0)}
            mhot = [(p + k) % m_blk_n for k in range(2)]
            for b in mhot:
                mt[f"m{m}/k{b:02d}"] = _acc(m_blk, 2.0, 1.0)
                mt[f"m{m}/v{b:02d}"] = _acc(m_blk, 2.0, 1.0)
            phases.append(SimPhaseSpec(f"m{m}/decode{p}", 0.004, mt))
    phases.append(SimPhaseSpec("cold/scan", 0.004, {
        "cold/archive": _acc(objects["cold/archive"], 0.05, 1.0)}))
    return SimWorkload("tenant_serving", phases, objects)

# Skewed variants: the hot-chunk placement pipeline's target workloads.
# Separate registry, so that the base matrix stays as it was; compared
# against the uniform (chunk_aware=False) pipeline.
SKEWED_SCENARIO_WORKLOADS = {
    "graph_chase_skew": graph_chase_skewed,
    "kv_serving_skew": kv_serving_skewed,
    "paged_serving": paged_attention,
}


# ---------------------------------------------------------------------------
# chaos fault profiles — fixed-seed FaultSpecs for the scenario matrix.
# The chaos scenario family is the full matrix above re-run under one of
# these profiles; fixed seeds against the deterministic virtual-time issue
# sequence make every chaos run as reproducible as a fault-free one.
# ---------------------------------------------------------------------------
def chaos_gated_spec(seed: int = 0) -> FaultSpec:
    """The gated profile: 5% transient ``start_move`` failures
    plus one permanently collapsed channel (channel 1 at 8x slowdown).
    Under this profile every scenario is expected to hold >= 0.85x its
    fault-free slack with zero audit violations."""
    return FaultSpec(seed=seed, transient_rate=0.05,
                     straggler_channel=1, straggler_channel_factor=8.0)


def chaos_heavy_spec(seed: int = 0) -> FaultSpec:
    """Kitchen-sink profile for robustness tests: every fault class on at
    once (transients, stuck handles, late failures, straggler windows) —
    the survival test, not the performance gate."""
    return FaultSpec(seed=seed, transient_rate=0.08, stuck_rate=0.02,
                     late_fail_rate=0.04, straggler_rate=0.05)


CHAOS_FAULT_PROFILES = {
    "gated": chaos_gated_spec,
    "heavy": chaos_heavy_spec,
}


# ---------------------------------------------------------------------------
def lm_train_workload(*, n_layers: int, layer_bytes: int, opt_bytes: int,
                      act_bytes: int, name: str = "lm",
                      layer_group: int = 4,
                      compute_per_group_s: float = 0.002) -> SimWorkload:
    """Transformer training step as a Unimem phase trace on accelerator
    memory tiers.

    Objects: per-layer-group weights, optimizer shards, activation
    checkpoints.  Phases: forward groups, backward groups (reverse order),
    optimizer update.  Weights are read in fwd+bwd; activations written in
    fwd and read in bwd; optimizer state touched only in the update phase —
    the access pattern that makes optimizer state the prime offload victim.
    """
    groups = max(1, n_layers // layer_group)
    objects: Dict[str, int] = {}
    for g in range(groups):
        objects[f"w{g}"] = layer_bytes * layer_group
        objects[f"opt{g}"] = opt_bytes * layer_group
        objects[f"act{g}"] = act_bytes * layer_group
    phases: List[SimPhaseSpec] = []
    for g in range(groups):
        phases.append(SimPhaseSpec(f"fwd{g}", compute_per_group_s, {
            f"w{g}": _acc(objects[f"w{g}"], 1.0, 1.0),
            f"act{g}": _acc(objects[f"act{g}"], 1.0, 1.0)}))
    for g in reversed(range(groups)):
        phases.append(SimPhaseSpec(f"bwd{g}", 2 * compute_per_group_s, {
            f"w{g}": _acc(objects[f"w{g}"], 2.0, 1.0),
            f"act{g}": _acc(objects[f"act{g}"], 1.0, 1.0)}))
    for g in range(groups):
        phases.append(SimPhaseSpec(f"opt{g}", compute_per_group_s / 2, {
            f"opt{g}": _acc(objects[f"opt{g}"], 2.0, 1.0),
            f"w{g}": _acc(objects[f"w{g}"], 1.0, 1.0)}))
    return SimWorkload(name, phases, objects)
