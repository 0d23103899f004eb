"""Placement-policy pipeline: a declarative Plan IR with pluggable stages.

The paper's runtime separates *characterizing* memory access from
*deciding* placement from *executing* moves (§3); PR 3 gave the first and
third their own pluggable layers (``InstrumentationSource``, the copy
backend registry).  This module does the same for the decision layer:
planning is a **pipeline of five registered stages**, each an
independently testable transform over (profiles, chunk registry, tier
state):

====================  =====================================================
``attribute``         write measured phase times + per-object access counts
                      into the phase graph (``PhaseProfiler.annotate_graph``)
``partition``         split oversized chunkable objects along the measured
                      access CDF and re-attribute references to chunks
                      (``partition.auto_partition`` / ``resplit_refs``);
                      optionally snap cuts to pytree leaf boundaries
``coalesce``          re-merge adjacent chunks whose measured densities
                      converged and whose tiers agree — caps registry
                      growth across drift sequences
                      (``partition.coalesce_chunks``)
``solve``             best-of-two knapsack search (phase-local /
                      cross-phase-global), scoped to the phases whose
                      inputs changed when a standing program is available
``schedule``          annotate every move with its copy window, duration
                      and slack (``planner.emit_schedule``)
====================  =====================================================

The pipeline's product is a :class:`PlanProgram` — an explicit,
JSON-serializable intermediate representation that carries the per-phase
residency sets, the move intents with slack deadlines, the per-phase
solve records (the standing state scoped replans re-solve against), and
the *provenance* of every stage run (which profile epoch and chunk
generation produced each decision).  ``PlanProgram`` subsumes
:class:`~.planner.PlacementPlan`'s query surface, so the movers consume
the IR directly.

Policies are selected by name through a string-keyed registry mirroring
:mod:`.backends` (``RuntimeConfig.policy = "unimem"`` →
:func:`make_policy`); a custom policy registers a factory with
:func:`register_policy` and may reuse, reorder, or replace any stage.

**Scoped replanning** falls out of the IR: when a standing program is
passed back into the solve stage, phases whose entry residency and input
fingerprint still match reuse their recorded decision without re-solving
(see :class:`~.planner.PhaseDecision`), so responding to a localized
drift costs O(affected phases' knapsacks) instead of O(plan) — and the
result is provably equal to a full replan, because any phase whose
inputs changed in any way fails the fingerprint match.
"""

from __future__ import annotations

import dataclasses
import json
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

from . import partition as partition_mod
from . import tenancy as tenancy_mod
from .data_objects import ObjectRegistry
from .phase import Phase, PhaseGraph
from .planner import (GlobalContrib, MoveOp, PhaseDecision, PlacementPlan,
                      Planner, ScheduledMove, emit_schedule)
from .profiler import PhaseProfiler
from .tenancy import TenantSpec, tenant_of
from .tiers import MachineProfile

#: canonical stage order of the unimem pipeline
STAGE_NAMES = ("attribute", "partition", "coalesce", "solve", "schedule")


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StageProvenance:
    """One pipeline stage run: what transformed the state, and against
    which profile epoch / registry chunk generation / histogram resolution
    epoch it ran."""

    stage: str
    policy: str
    profile_epoch: int
    chunk_generation: int
    detail: str = ""
    hist_epoch: int = 0
    # owning cluster host ("" on the single-host path): multi-host plans
    # carry per-host provenance so an aggregated global program records
    # which host's pipeline produced each stage
    host: str = ""


def fault_provenance(n_degraded: int, n_rollbacks: int, profile_epoch: int,
                     chunk_generation: int,
                     hist_epoch: int = 0) -> StageProvenance:
    """Extra provenance entry the session appends to a plan rebuilt after
    fault events (degraded serves / eviction rollbacks under the previous
    plan): it marks that the rebuild's profile inputs were shaped by
    failures, not only by workload drift.  Appended *in addition to* the
    canonical ``STAGE_NAMES`` stages, and only on fault-bearing rebuilds
    — fault-free provenance is byte-identical to the legacy pipeline."""
    return StageProvenance(
        stage="fault", policy="fault-replay", profile_epoch=profile_epoch,
        chunk_generation=chunk_generation,
        detail=(f"{n_degraded} degraded serves, {n_rollbacks} eviction "
                f"rollbacks since last plan"),
        hist_epoch=hist_epoch)


@dataclasses.dataclass
class PlanProgram(PlacementPlan):
    """The pipeline's product: a :class:`~.planner.PlacementPlan` plus the
    declarative bookkeeping that makes plans inspectable, serializable and
    incrementally re-solvable.

    ``phase_decisions`` (inherited) always holds the *local-search*
    records even when the global strategy won the best-of-two — they are
    the standing residency a scoped replan re-solves against.
    ``provenance`` records each stage run with the profile epoch and chunk
    generation it consumed; ``capacity_bytes`` pins the budget the solve
    ran under (a changed budget invalidates scoped reuse wholesale)."""

    policy: str = "unimem"
    provenance: List[StageProvenance] = dataclasses.field(
        default_factory=list)
    profile_epoch: int = 0
    chunk_generation: int = 0
    capacity_bytes: int = 0
    # histogram resolution epoch the build consumed: bumped whenever any
    # measured histogram is adaptively re-binned, so a program records
    # which profiling resolution produced its decisions
    hist_epoch: int = 0
    # Multi-tenant bandwidth partition (policy="bandwidth_partition"; all
    # empty on single-workload plans): the fast-tier byte share each
    # tenant's sub-solve ran under, the copy channels each tenant owns
    # (consumed by the mover's channel chooser), and the tenants admission
    # control demoted to serve-from-slow with the reason why.
    tenant_shares: Dict[str, int] = dataclasses.field(default_factory=dict)
    tenant_channels: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    tenant_admission: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    # Multi-host cluster aggregation (policy="cluster"; all empty on
    # single-host plans): the host whose pipeline built this program
    # (None = unclustered), per-host residency sections keyed by host id
    # (each a JSON-safe summary of that host's solve: strategy,
    # residents, predicted/baseline times, capacity), and the cross-host
    # shard migrations the coordinator chose, priced over interconnect
    # links.
    host: Optional[str] = None
    host_sections: Dict[str, Any] = dataclasses.field(default_factory=dict)
    migrations: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    # ------------------------------------------------------------ construction
    @classmethod
    def from_plan(cls, plan: PlacementPlan, *, policy: str,
                  provenance: Sequence[StageProvenance],
                  profile_epoch: int, chunk_generation: int,
                  capacity_bytes: int, hist_epoch: int = 0,
                  phase_decisions: Optional[Sequence[PhaseDecision]] = None,
                  global_contribs: Optional[Sequence[GlobalContrib]] = None,
                  graph_digest: Optional[tuple] = None) -> "PlanProgram":
        return cls(
            strategy=plan.strategy, residents=plan.residents,
            moves=plan.moves,
            predicted_iteration_time=plan.predicted_iteration_time,
            baseline_iteration_time=plan.baseline_iteration_time,
            schedule=plan.schedule,
            phase_decisions=list(phase_decisions
                                 if phase_decisions is not None
                                 else plan.phase_decisions),
            global_contribs=list(global_contribs
                                 if global_contribs is not None
                                 else plan.global_contribs),
            graph_digest=(graph_digest if graph_digest is not None
                          else plan.graph_digest),
            phase_baseline=list(plan.phase_baseline),
            phase_gain_bw=list(plan.phase_gain_bw),
            phase_gain_lat=list(plan.phase_gain_lat),
            policy=policy, provenance=list(provenance),
            profile_epoch=profile_epoch, chunk_generation=chunk_generation,
            capacity_bytes=capacity_bytes, hist_epoch=hist_epoch)

    # ----------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return dict(
            policy=self.policy, strategy=self.strategy,
            residents=[sorted(r) for r in self.residents],
            moves=[dataclasses.asdict(m) for m in self.moves],
            schedule=[dict(op=dataclasses.asdict(s.op), window_s=s.window_s,
                           duration_s=s.duration_s, slack_s=s.slack_s)
                      for s in self.schedule],
            predicted_iteration_time=self.predicted_iteration_time,
            baseline_iteration_time=self.baseline_iteration_time,
            phase_decisions=[dict(
                phase_index=d.phase_index,
                entry_residents=sorted(d.entry_residents),
                entry_bytes=d.entry_bytes,
                fingerprint=d.fingerprint,    # nested tuples -> JSON lists
                moves=[dataclasses.asdict(m) for m in d.moves],
                exit_residents=sorted(d.exit_residents),
                exit_bytes=d.exit_bytes,
                benefits=d.benefits,
                classes=d.classes) for d in self.phase_decisions],
            global_contribs=[dict(
                phase_index=g.phase_index, version=list(g.version),
                generation=g.generation, objs=list(g.objs),
                row=[float(v) for v in g.row],
                cls_row=([int(v) for v in g.cls_row]
                         if g.cls_row is not None else None))
                for g in self.global_contribs],
            graph_digest=self.graph_digest,   # nested tuples -> JSON lists
            phase_baseline=list(self.phase_baseline),
            phase_gain_bw=list(self.phase_gain_bw),
            phase_gain_lat=list(self.phase_gain_lat),
            provenance=[dataclasses.asdict(p) for p in self.provenance],
            profile_epoch=self.profile_epoch,
            chunk_generation=self.chunk_generation,
            capacity_bytes=self.capacity_bytes,
            hist_epoch=self.hist_epoch,
            tenant_shares=dict(self.tenant_shares),
            tenant_channels={t: list(c)
                             for t, c in self.tenant_channels.items()},
            tenant_admission=dict(self.tenant_admission),
            host=self.host,
            host_sections={h: dict(s)
                           for h, s in self.host_sections.items()},
            migrations=[dict(m) for m in self.migrations])

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlanProgram":
        def tuplify(x):
            return tuple(tuplify(e) for e in x) if isinstance(x, list) else x

        moves = [MoveOp(**m) for m in d["moves"]]
        schedule = [ScheduledMove(MoveOp(**s["op"]), s["window_s"],
                                  s["duration_s"], s["slack_s"])
                    for s in d["schedule"]]
        import numpy as np
        decisions = [PhaseDecision(
            phase_index=pd["phase_index"],
            entry_residents=frozenset(pd["entry_residents"]),
            entry_bytes=pd["entry_bytes"],
            fingerprint=tuplify(pd["fingerprint"]),
            moves=tuple(MoveOp(**m) for m in pd["moves"]),
            exit_residents=frozenset(pd["exit_residents"]),
            exit_bytes=pd["exit_bytes"],
            benefits=pd.get("benefits"),
            classes=pd.get("classes")) for pd in d["phase_decisions"]]
        contribs = [GlobalContrib(
            phase_index=g["phase_index"], version=tuple(g["version"]),
            generation=g["generation"], objs=tuple(g["objs"]),
            row=np.asarray(g["row"], dtype=np.float64),
            cls_row=(np.asarray(g["cls_row"], dtype=np.uint8)
                     if g.get("cls_row") is not None else None))
            for g in d.get("global_contribs", [])]
        digest = d.get("graph_digest")
        return cls(
            strategy=d["strategy"],
            residents=[set(r) for r in d["residents"]],
            moves=moves,
            predicted_iteration_time=d["predicted_iteration_time"],
            baseline_iteration_time=d["baseline_iteration_time"],
            schedule=schedule, phase_decisions=decisions,
            global_contribs=contribs,
            graph_digest=tuplify(digest) if digest is not None else None,
            phase_baseline=list(d.get("phase_baseline", [])),
            phase_gain_bw=list(d.get("phase_gain_bw", [])),
            phase_gain_lat=list(d.get("phase_gain_lat", [])),
            policy=d["policy"],
            provenance=[StageProvenance(**p) for p in d["provenance"]],
            profile_epoch=d["profile_epoch"],
            chunk_generation=d["chunk_generation"],
            capacity_bytes=d["capacity_bytes"],
            hist_epoch=d.get("hist_epoch", 0),
            tenant_shares={t: int(v) for t, v in
                           d.get("tenant_shares", {}).items()},
            tenant_channels={t: [int(c) for c in chs] for t, chs in
                             d.get("tenant_channels", {}).items()},
            tenant_admission=dict(d.get("tenant_admission", {})),
            host=d.get("host"),
            host_sections={h: dict(s) for h, s in
                           d.get("host_sections", {}).items()},
            migrations=[dict(m) for m in d.get("migrations", [])])

    @classmethod
    def from_json(cls, s: str) -> "PlanProgram":
        return cls.from_dict(json.loads(s))

    @property
    def reused_phases(self) -> int:
        return sum(1 for d in self.phase_decisions if d.reused)


# ---------------------------------------------------------------------------
# pipeline state
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PipelineState:
    """The mutable context threaded through the pipeline stages: the
    characterized inputs (graph, registry, profiler), the solver, the
    budget, the driving config (duck-typed — only the ``enable_*`` /
    ``chunk_aware`` / ``coalesce`` / ``scoped_replan`` / ``leaf_aligned``
    attributes are read), and the standing program a replan may re-solve
    against."""

    machine: MachineProfile
    registry: ObjectRegistry
    graph: PhaseGraph
    profiler: PhaseProfiler
    planner: Planner
    capacity: int
    config: Any
    standing: Optional[PlanProgram] = None
    provenance: List[StageProvenance] = dataclasses.field(
        default_factory=list)
    plan: Optional[PlacementPlan] = None        # set by the solve stage
    local_decisions: List[PhaseDecision] = dataclasses.field(
        default_factory=list)
    global_contribs: List[GlobalContrib] = dataclasses.field(
        default_factory=list)
    graph_digest: Optional[tuple] = None
    # declared tenant QoS contracts (None = single-workload pipeline) and
    # the partition the bandwidth_partition solve produced
    tenants: Optional[Dict[str, TenantSpec]] = None
    tenant_solution: Optional[Dict[str, Any]] = None
    # Phases the drift monitor identified as drifted this replan (None =
    # unscoped build).  The attribute/partition stages restrict their
    # rewrites to these phases when it is provably safe to do so (see
    # stage_attribute) — an undrifted phase's profile version and the
    # registry generation pin its attribution, so re-running it would
    # write identical values.
    drift_scope: Optional[Sequence[int]] = None

    def record(self, policy: str, stage: str, detail: str = "") -> None:
        self.provenance.append(StageProvenance(
            stage=stage, policy=policy,
            profile_epoch=self.profiler.epoch,
            chunk_generation=self.registry.generation, detail=detail,
            hist_epoch=getattr(self.profiler, "hist_epoch", 0),
            host=self._cfg("host", None) or ""))

    def _cfg(self, name: str, default: Any) -> Any:
        return getattr(self.config, name, default)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------
def _gated_drift_scope(state: PipelineState) -> Optional[List[int]]:
    """The drift scope, or None when scoped attribution is not provably
    safe: it requires a standing program from the same lineage (so every
    phase was attributed by a previous build), an unchanged registry
    generation (chunk spans pin the attribution), and single-resolution
    histograms (multi-res re-splitting re-attributes outside the scope)."""
    scope = state.drift_scope
    if scope is None:
        return None
    if (state.standing is None
            or not state._cfg("scoped_replan", True)
            or state.standing.chunk_generation != state.registry.generation
            or state._cfg("histogram_refine", False)):
        return None
    return sorted(scope)


def stage_attribute(state: PipelineState, policy: str = "unimem") -> None:
    """Write measured phase times and per-object access counts into the
    phase graph (objects faded below one access are de-referenced).

    During a scoped drift response only the drifted phases are rewritten:
    the session's re-profiling froze every other phase's profile state
    (bitwise), so their graph annotations from the previous build are
    already what a full pass would write."""
    scope = _gated_drift_scope(state)
    state.drift_scope = scope       # partition stage reuses the gated value
    state.profiler.annotate_graph(state.graph, phases=scope)
    state.record(policy, "attribute",
                 f"{len(state.graph)} phases annotated" if scope is None
                 else f"{len(scope)}/{len(state.graph)} phases annotated"
                      " (scoped)")


def stage_partition(state: PipelineState, policy: str = "unimem") -> None:
    """Split oversized chunkable objects (skew-aware when histograms are
    measured) and re-attribute per-phase references to chunks.  In
    multi-resolution mode (``histogram_refine``), additionally re-split
    existing chunks whose refined histograms resolved sub-chunk imbalance
    — the pass that lets a coalesced chunk re-split when drift re-heats
    it."""
    if not state._cfg("enable_partitioning", True):
        return
    multi_res = state._cfg("histogram_refine", False)
    newly = partition_mod.auto_partition(
        state.registry, state.graph, state.capacity,
        profiler=state.profiler,
        skew_aware=state._cfg("chunk_aware", True),
        leaf_aligned=state._cfg("leaf_aligned", False),
        multi_res=multi_res)
    if not newly:
        # Replan with parents partitioned on an earlier build: the
        # attribute stage just rewrote parent-name refs from the
        # parent-keyed profiles, so re-attribute them to chunks with the
        # freshest histograms.  (auto_partition already did this for
        # anything it partitioned; without chunk_aware the profiler has no
        # histograms and size fractions apply.)  Scoped in lockstep with
        # the attribute stage: a phase it skipped still holds the previous
        # build's chunk attribution, which this pass would reproduce.
        partition_mod.resplit_refs(state.graph, state.registry,
                                   state.profiler,
                                   phases=state.drift_scope)
    resplits = {}
    if multi_res and state._cfg("chunk_aware", True):
        resplits = partition_mod.resplit_hot_chunks(
            state.registry, state.graph, state.profiler, state.capacity,
            leaf_aligned=state._cfg("leaf_aligned", False))
    detail = f"split {len(newly)}" if newly else "re-attributed"
    if resplits:
        detail += "; resplit " + ";".join(
            f"{p}:{b}->{a}" for p, (b, a) in sorted(resplits.items()))
    state.record(policy, "partition", detail)


def stage_coalesce(state: PipelineState, policy: str = "unimem") -> None:
    """Re-merge adjacent chunks whose measured densities converged and
    whose tiers agree (caps registry growth across drift sequences)."""
    if not state._cfg("coalesce", True):
        return
    merged = partition_mod.coalesce_chunks(
        state.registry, state.graph, state.profiler, state.capacity)
    state.record(policy, "coalesce",
                 ";".join(f"{p}:{b}->{a}" for p, (b, a) in sorted(
                     merged.items())) or "no-op")


def solve_best(planner: Planner, graph: PhaseGraph, profiler: PhaseProfiler,
               config: Any,
               standing: Optional[Sequence[PhaseDecision]] = None,
               standing_global: Optional[Sequence[GlobalContrib]] = None,
               standing_digest: Optional[tuple] = None
               ) -> Tuple[Optional[PlacementPlan], List[PhaseDecision],
                          List[GlobalContrib], Optional[tuple]]:
    """The paper's best-of-two search with optional scoped solving.
    Returns (chosen plan or None, the local-search decisions, the
    global-search contributions, the graph digest) — the aux records are
    kept on the program regardless of which strategy won, so the *next*
    replan can scope."""
    plans: List[PlacementPlan] = []
    decisions: List[PhaseDecision] = []
    contribs: List[GlobalContrib] = []
    digest: Optional[tuple] = None
    local: Optional[PlacementPlan] = None
    glob: Optional[PlacementPlan] = None
    if getattr(config, "enable_local_search", True):
        local = planner.plan_local(graph, profiler, standing=standing,
                                   standing_digest=standing_digest)
        decisions = local.phase_decisions
        digest = local.graph_digest
        plans.append(local)
    if getattr(config, "enable_global_search", True):
        # the local predicted time arms the planner's dominance bound: a
        # global solve provably unable to win the best-of-two is skipped,
        # and the pruned plan's certified lower bound keeps min() below
        # picking the same winner (ties go to local either way)
        glob = planner.plan_global(
            graph, profiler, standing_global=standing_global,
            prune_above=(local.predicted_iteration_time
                         if local is not None else None))
        contribs = glob.global_contribs
        plans.append(glob)
    if not plans:
        return None, decisions, contribs, digest
    best = min(plans, key=lambda p: p.predicted_iteration_time)
    if glob is not None and best is not glob:
        # surface the global search's reuse behaviour on whichever plan
        # wins (plan() does the same)
        best.global_mode = glob.global_mode
        best.global_rows_reused = glob.global_rows_reused
    return best, decisions, contribs, digest


def stage_solve(state: PipelineState, policy: str = "unimem") -> None:
    """Best-of-two knapsack search.  With a compatible standing program
    and ``scoped_replan``, both searches reuse every phase whose profile
    version, registry generation, entry residency and cross-phase windows
    still match (O(affected phases), plans equal to a full replan by
    construction)."""
    standing = standing_global = standing_digest = None
    if (state.standing is not None
            and state._cfg("scoped_replan", True)
            and state.standing.capacity_bytes == state.planner.capacity):
        standing = state.standing.phase_decisions or None
        standing_global = state.standing.global_contribs or None
        standing_digest = state.standing.graph_digest
    (state.plan, state.local_decisions, state.global_contribs,
     state.graph_digest) = solve_best(
        state.planner, state.graph, state.profiler, state.config,
        standing=standing, standing_global=standing_global,
        standing_digest=standing_digest)
    reused = sum(1 for d in state.local_decisions if d.reused)
    detail = (f"{state.plan.strategy}; reused {reused}/"
              f"{len(state.local_decisions)} phase solves; "
              f"global {state.plan.global_mode} "
              f"({state.plan.global_rows_reused} rows reused)"
              if state.plan is not None else "no search enabled")
    state.record(policy, "solve", detail)


def stage_solve_lru(state: PipelineState, policy: str = "lru") -> None:
    """Clock/LRU baseline solve (ablation plugin): walk the phases in
    order; every object a phase references is touched (most recently
    used) and demand-fetched at that phase's own boundary — no lookahead
    window, so the fence pays the whole copy; to make room, the
    least-recently-used resident the phase does not reference is evicted.
    No Eq. (1)-(5) benefit model is consulted, which is exactly what the
    ablation measures."""
    graph, reg = state.graph, state.registry
    cap = state.planner.capacity
    size = lambda o: reg[o].size_bytes
    residents = {o.name for o in reg if o.tier == "fast"}
    resident_bytes = sum(size(o) for o in residents)
    last_use: Dict[str, int] = {}
    clock = 0
    moves: List[MoveOp] = []
    placements: List[set] = []
    for ph in graph:
        refs = [o for o in ph.refs if o in reg and ph.refs[o] > 0.0]
        # hotter references first: when not everything fits, the LRU
        # baseline still serves the phase's heaviest objects
        for o in sorted(refs, key=lambda o: (-ph.refs[o], o)):
            clock += 1
            last_use[o] = clock
            if o in residents or reg[o].pinned:
                continue
            sz = size(o)
            if sz > cap:
                continue
            while resident_bytes + sz > cap:
                victims = [r for r in residents
                           if r not in ph.refs and not reg[r].pinned]
                if not victims:
                    break
                v = min(victims, key=lambda r: (last_use.get(r, 0), r))
                residents.discard(v)
                resident_bytes -= size(v)
                moves.append(MoveOp(v, "slow", ph.index, ph.index, size(v),
                                    size(v) / state.machine.copy_bw))
            if resident_bytes + sz <= cap:
                residents.add(o)
                resident_bytes += sz
                moves.append(MoveOp(o, "fast", ph.index, ph.index, sz,
                                    sz / state.machine.copy_bw))
        placements.append(set(residents))
    state.plan = PlacementPlan(
        "lru", placements, moves, graph.iteration_time(),
        graph.iteration_time())
    state.record(policy, "solve", f"lru: {len(moves)} moves")


def stage_solve_interval(state: PipelineState,
                         policy: str = "interval") -> None:
    """Online interval-guidance solve (ablation plugin), after Olson et
    al.'s application guidance for heterogeneous memory (arxiv
    2110.02150): each phase is one profiling interval; an object's
    priority is an exponentially decayed accumulation of its per-interval
    access *density* (bytes of traffic per byte of footprint), so recent
    intervals dominate but persistent hotness is remembered across the
    loop.  At every interval boundary the policy greedily packs the
    highest-density objects into fast memory, evicting the coldest
    residents to make room — guidance comes entirely from the decayed
    interval profile; no Eq. (1)-(5) benefit model, no slack-window
    lookahead, and every move is a demand move priced at its full
    ``size/copy_bw`` boundary cost."""
    graph, reg = state.graph, state.registry
    cap = state.planner.capacity
    decay = state._cfg("interval_decay", 0.6)
    size = lambda o: reg[o].size_bytes
    heat: Dict[str, float] = {}
    residents = {o.name for o in reg if o.tier == "fast"}
    resident_bytes = sum(size(o) for o in residents)
    moves: List[MoveOp] = []
    placements: List[set] = []
    for ph in graph:
        for o in heat:
            heat[o] *= decay
        for o, traffic in ph.refs.items():
            if o in reg and traffic > 0.0:
                heat[o] = heat.get(o, 0.0) + traffic / max(size(o), 1)
        want: set = set()
        want_bytes = 0
        for o in sorted((o for o in heat if heat[o] > 0.0 and o in reg),
                        key=lambda o: (-heat[o], o)):
            sz = size(o)
            if reg[o].pinned or sz > cap:
                continue
            if want_bytes + sz <= cap:
                want.add(o)
                want_bytes += sz
        # coldest stragglers out first, hottest arrivals in afterwards —
        # both at this interval's boundary, the paper's guidance point
        for v in sorted(residents - want,
                        key=lambda o: (heat.get(o, 0.0), o)):
            if v not in reg or reg[v].pinned:
                continue
            residents.discard(v)
            resident_bytes -= size(v)
            moves.append(MoveOp(v, "slow", ph.index, ph.index, size(v),
                                size(v) / state.machine.copy_bw))
        for o in sorted(want - residents, key=lambda o: (-heat[o], o)):
            sz = size(o)
            if resident_bytes + sz > cap:
                continue
            residents.add(o)
            resident_bytes += sz
            moves.append(MoveOp(o, "fast", ph.index, ph.index, sz,
                                sz / state.machine.copy_bw))
        placements.append(set(residents))
    state.plan = PlacementPlan(
        "interval", placements, moves, graph.iteration_time(),
        graph.iteration_time())
    state.record(policy, "solve",
                 f"interval: {len(moves)} moves, decay={decay:g}")


def stage_solve_bandwidth_partition(
        state: PipelineState, policy: str = "bandwidth_partition") -> None:
    """Multi-tenant solve: admission control, QoS-weighted partitioning of
    the fast tier and the copy channels, then one scoped Unimem local
    solve per admitted tenant under its own byte share.

    The partition is computed by :mod:`.tenancy`: capacity water-fills by
    ``priority/slo`` weight capped at each tenant's demand (unused shares
    redistribute work-conservingly), channels apportion by largest
    remainder so every channel is owned by exactly one tenant.  Each
    admitted tenant then gets an *isolated* knapsack: a phase graph
    filtered to its namespace and a throwaway planner whose capacity is
    the tenant's share — so one whale can never out-bid the tail inside a
    shared knapsack, which is the entire point.  Demoted tenants' fast
    residents are evicted at phase 0 and the demotion is recorded in
    ``tenant_admission`` (the session logs ``DegradedServe`` provenance
    from it).  Objects outside every declared namespace form a pseudo
    tenant with neutral weight.  With **no** tenants declared this stage
    is byte-for-byte :func:`stage_solve` — single-workload plans stay
    bit-identical to the unimem pipeline."""
    tenants = state.tenants
    if not tenants:
        stage_solve(state, policy)
        return
    graph, reg, planner = state.graph, state.registry, state.planner
    cap = planner.capacity
    member: Dict[str, str] = {}     # object -> tenant key ("" = unowned)
    for o in reg:
        t = tenant_of(o.name, tenants)
        member[o.name] = t if t is not None else ""
    # every declared tenant partitions even when idle; the pseudo tenant
    # only exists if unowned objects are actually referenced
    class _Pseudo:
        weight = 1.0
    specs: Dict[str, Any] = dict(tenants)
    referenced = {o for ph in graph for o, v in ph.refs.items() if v > 0.0}
    if any(member.get(o, "") == "" for o in referenced):
        specs[""] = _Pseudo()
    demand = {t: 0 for t in specs}
    traffic = {t: 0.0 for t in specs}
    hot = {t: 0 for t in specs}
    for ph in graph:
        per_phase: Dict[str, int] = {}
        for o, v in ph.refs.items():
            if v <= 0.0 or o not in reg:
                continue
            t = member.get(o, "")
            if t not in specs:
                continue
            traffic[t] += v
            per_phase[t] = per_phase.get(t, 0) + reg[o].size_bytes
        for t, b in per_phase.items():
            hot[t] = max(hot[t], b)
    for o in reg:
        t = member.get(o.name, "")
        if t in specs and o.name in referenced:
            demand[t] += o.size_bytes
    # admission: only declared tenants can be demoted (the pseudo tenant
    # is the shared substrate, not a QoS contract)
    demoted = tenancy_mod.admission_control(
        tenants, traffic, demand, cap,
        heat_floor=state._cfg("tenant_admission_heat", 0.0) or 0.0,
        churn_guard=state._cfg("tenant_churn_guard", None),
        hot_bytes=hot)
    admitted = {t: s for t, s in specs.items() if t not in demoted}
    shares = tenancy_mod.capacity_shares(cap, admitted, demand)
    channels = tenancy_mod.channel_shares(
        state._cfg("copy_channels", 2) or 1,
        {t: s for t, s in admitted.items() if t in tenants})
    size = lambda o: reg[o].size_bytes
    moves: List[MoveOp] = []
    placements = [set() for _ in graph]
    n_ph = len(graph)
    B = graph.iteration_time()
    gain_bw = [0.0] * n_ph
    gain_lat = [0.0] * n_ph
    predicted = B
    for t in sorted(admitted):
        mem = {n for n, owner in member.items() if owner == t}
        fgraph = PhaseGraph([
            Phase(ph.index, ph.name, ph.kind,
                  {o: v for o, v in ph.refs.items() if o in mem}, ph.time)
            for ph in graph])
        share = shares.get(t, 0)
        sub = Planner(state.machine, reg, planner.cf, share,
                      vectorized=planner.vectorized,
                      enact_consistent=planner.enact_consistent)
        # Entry residency can overshoot the share: evictions are issued
        # lazily, so a rebuild mid-rotation (e.g. a calibration fold)
        # snapshots fast bytes whose departures were booked by the old
        # plan.  The local solve keeps entry residents it was never asked
        # to fetch, so an unclamped entry would bake the overshoot in as
        # permanent residency beyond the share.  Shed the lowest-traffic
        # residents down to the share and evict them at phase 0.
        init = {o.name for o in reg if o.tier == "fast" and o.name in mem}
        over = sum(size(o) for o in init) - share
        if over > 0:
            traffic_of = {n: 0.0 for n in init}
            for ph in fgraph:
                for o, v in ph.refs.items():
                    if o in traffic_of and v > 0.0:
                        traffic_of[o] += v
            for n in sorted(init, key=lambda n: (
                    traffic_of[n] / max(size(n), 1), n)):
                if over <= 0:
                    break
                if reg[n].pinned:
                    continue
                init.discard(n)
                over -= size(n)
                moves.append(MoveOp(n, "slow", 0, 0, size(n),
                                    size(n) / state.machine.copy_bw))
        sub._initial_residents = lambda init=init: set(init)
        local = sub.plan_local(fgraph, state.profiler)
        moves.extend(local.moves)
        for i, residents in enumerate(local.residents[:n_ph]):
            placements[i] |= residents
        predicted -= max(0.0, B - local.predicted_iteration_time)
        for i in range(min(n_ph, len(local.phase_gain_bw))):
            gain_bw[i] += local.phase_gain_bw[i]
        for i in range(min(n_ph, len(local.phase_gain_lat))):
            gain_lat[i] += local.phase_gain_lat[i]
    # demoted tenants serve from slow: evict their fast residents so
    # admitted tenants actually get the capacity the shares promise
    for t in sorted(demoted):
        for o in sorted(n for n, owner in member.items() if owner == t):
            if o in reg and reg[o].tier == "fast" and not reg[o].pinned:
                moves.append(MoveOp(o, "slow", 0, 0, size(o),
                                    size(o) / state.machine.copy_bw))
    state.plan = PlacementPlan(
        "bandwidth_partition", placements, moves, max(0.0, predicted), B,
        phase_baseline=[ph.time for ph in graph],
        phase_gain_bw=gain_bw, phase_gain_lat=gain_lat)
    state.tenant_solution = dict(
        shares={t: int(v) for t, v in shares.items()},
        channels={t: list(c) for t, c in channels.items()},
        admission=dict(demoted))
    state.record(
        policy, "solve",
        f"{len(admitted)} tenants admitted, {len(demoted)} demoted; "
        + ";".join(f"{t or '<unowned>'}:{shares.get(t, 0)}B"
                   f"+ch{channels.get(t, [])}"
                   for t in sorted(specs)))


def stage_schedule(state: PipelineState, policy: str = "unimem") -> None:
    """Annotate every move with its copy window, duration and slack — the
    schedule the slack-aware mover releases most-urgent-first.  The
    planner entry points already emit the schedule for the plans they
    build; this stage only fills it in for plans that arrived without one
    (a custom policy's solve stage), so a normal build does not pay for
    the emission twice."""
    if state.plan is None:
        return
    if len(state.plan.schedule) != len(state.plan.moves):
        state.plan.schedule = emit_schedule(
            state.plan.moves, state.graph, state.machine.copy_bw)
    state.record(policy, "schedule",
                 f"{len(state.plan.schedule)} moves annotated")


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------
@runtime_checkable
class PlacementPolicy(Protocol):
    """A placement policy builds a :class:`PlanProgram` from characterized
    state (and optionally re-solves against a standing program)."""

    name: str

    def build(self, state: PipelineState) -> Optional[PlanProgram]: ...


class UnimemPolicy:
    """The paper's planner as a five-stage pipeline (see module docstring).
    Custom policies can subclass and override ``stages``."""

    name = "unimem"
    stages: Tuple[Callable[[PipelineState, str], None], ...] = (
        stage_attribute, stage_partition, stage_coalesce, stage_solve,
        stage_schedule)

    def build(self, state: PipelineState) -> Optional[PlanProgram]:
        for stage in self.stages:
            stage(state, self.name)
        if state.plan is None:
            return None
        return PlanProgram.from_plan(
            state.plan, policy=self.name, provenance=state.provenance,
            profile_epoch=state.profiler.epoch,
            chunk_generation=state.registry.generation,
            capacity_bytes=state.planner.capacity,
            hist_epoch=getattr(state.profiler, "hist_epoch", 0),
            phase_decisions=state.local_decisions,
            global_contribs=state.global_contribs,
            graph_digest=state.graph_digest)


class LruPolicy(UnimemPolicy):
    """Clock/LRU baseline for ablations: the solve stage is replaced by a
    demand-driven recency policy (fetch what the phase touches, evict the
    least-recently-used resident to make room, no benefit model, no
    lookahead triggers), while the characterization stages — attribute,
    partition, coalesce — and the schedule stage are reused unchanged.
    Quantifies how much of Unimem's win comes from the Eq. (1)-(5) solve
    rather than from chunking/attribution alone."""

    name = "lru"
    stages = (stage_attribute, stage_partition, stage_coalesce,
              stage_solve_lru, stage_schedule)


class IntervalPolicy(UnimemPolicy):
    """Olson-style online interval guidance (arxiv 2110.02150) as a
    placement policy: the solve stage ranks objects by exponentially
    decayed per-interval access density and greedily packs fast memory at
    every interval boundary, while the characterization stages —
    attribute, partition, coalesce — and the schedule stage are reused
    unchanged.  The third point on the ablation axis: LRU shows what
    recency alone buys, interval guidance what decayed frequency/density
    profiling buys, and the Unimem solve what the calibrated Eq. (1)-(5)
    benefit model adds on top."""

    name = "interval"
    stages = (stage_attribute, stage_partition, stage_coalesce,
              stage_solve_interval, stage_schedule)


class BandwidthPartitionPolicy(UnimemPolicy):
    """Multi-tenant QoS policy (the stage slot named open since PR 4):
    the solve stage is replaced by admission control + QoS-weighted
    partitioning of fast-tier capacity and copy channels + one isolated
    Unimem local solve per admitted tenant, while the characterization
    stages — attribute, partition, coalesce — and the schedule stage are
    reused unchanged.  The program additionally carries
    ``tenant_shares`` / ``tenant_channels`` / ``tenant_admission``; the
    mover consumes the channel ownership map for its chooser.  With no
    tenants declared the pipeline is bit-identical to ``unimem``.

    Scoped standing-plan reuse is disabled for multi-tenant solves (the
    merged plan records no per-phase decisions to reuse); each rebuild
    re-partitions and re-solves, which is what admission control needs
    anyway — shares must track the live traffic mix."""

    name = "bandwidth_partition"
    stages = (stage_attribute, stage_partition, stage_coalesce,
              stage_solve_bandwidth_partition, stage_schedule)

    def build(self, state: PipelineState) -> Optional[PlanProgram]:
        program = super().build(state)
        if program is not None and state.tenant_solution:
            program.tenant_shares = dict(state.tenant_solution["shares"])
            program.tenant_channels = {
                t: list(c)
                for t, c in state.tenant_solution["channels"].items()}
            program.tenant_admission = dict(
                state.tenant_solution["admission"])
        return program


# ---------------------------------------------------------------------------
# registry (mirrors core.backends)
# ---------------------------------------------------------------------------
PolicyFactory = Callable[..., PlacementPolicy]

_REGISTRY: Dict[str, PolicyFactory] = {}


def register_policy(name: str, factory: PolicyFactory,
                    *, overwrite: bool = False) -> None:
    """Register a placement-policy factory under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"policy {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _REGISTRY[name] = factory


def available_policies() -> List[str]:
    return sorted(_REGISTRY)


def make_policy(name: str, **options: Any) -> PlacementPolicy:
    """Instantiate the policy registered under ``name``."""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown placement policy {name!r}; registered: "
                         f"{available_policies()}")
    return factory(**options)


register_policy("unimem", lambda **_: UnimemPolicy())
register_policy("lru", lambda **_: LruPolicy())
register_policy("interval", lambda **_: IntervalPolicy())
register_policy("bandwidth_partition",
                lambda **_: BandwidthPartitionPolicy())
