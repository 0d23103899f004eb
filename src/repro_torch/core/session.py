"""Runtime session — the v2 user-facing surface of the Unimem runtime.

The paper's Table-2 API (``unimem_malloc`` / ``unimem_start`` /
``unimem_end``) is imperative: every driver repeats the same
``alloc -> start_loop -> begin_iteration -> phase_begin/phase_end``
choreography and hand-feeds instrumentation dicts into each ``phase_end``.
The session keeps the paper's workflow (Fig 8: profile -> model -> plan ->
move -> monitor) but makes the instrumented path the zero-effort path:

* :meth:`register` is **pytree-native**: pass a JAX pytree (arrays or
  ``ShapeDtypeStruct``\\ s) and the session records the object's size *and*
  each leaf's byte span, so chunk attribution can align to leaf boundaries
  and :class:`~.instrumentation.XlaCostAnalysisSource` can map compiled
  programs back onto the object.
* the loop is two context managers — ``with rt.iteration():`` around the
  step, ``with rt.phase("fwd"):`` around each phase.  Phases
  **auto-register on first use** (no upfront name list), timing is
  captured by the context, and an exception can never leave a phase open.
* instrumentation comes from a pluggable
  :class:`~.instrumentation.InstrumentationSource` (manual dicts, the
  simulator's physics, XLA cost analysis); explicit keyword overrides on
  ``phase(...)`` always win.
* the copy engine is resolved from the string-keyed backend registry
  (``RuntimeConfig.backend`` -> :mod:`.backends`), not constructor wiring.

``UnimemRuntime`` (:mod:`.runtime`) subclasses this session and keeps the
old imperative methods as deprecated shims, so every pre-v2 driver runs
unchanged — and produces bit-identical plans, since the shims delegate to
the same internals (parity-tested in ``tests/test_api_v2.py``).

Workflow semantics (unchanged from the paper + earlier PRs): iteration 1
profiles each phase; at its end the planner builds a placement plan (best
of phase-local / cross-phase-global); from iteration 2 on the proactive
mover enforces the plan and the variation monitor re-triggers profiling on
>10% drift — incrementally by default (the plan is never dropped once
built; see ``RuntimeConfig.incremental_replan``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time as _time
from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import _tree
from . import backends as backends_mod
from . import initial as initial_mod
from . import perfmodel
from . import policy as policy_mod
from .data_objects import DataObject, ObjectRegistry
from .faults import (ChaosBackend, CopyError, DegradedServe, FaultLog,
                     FaultSpec)
from .instrumentation import InstrumentationSource, PhaseSample
from .monitor import VariationMonitor
from .mover import (ProactiveMover, SlackAwareMover, TierBackend,
                    _handle_orphaned)
from .perfmodel import CalibrationConstants
from .phase import Phase, PhaseGraph, PhaseTraceEvent
from .planner import MoveOp, PlacementPlan, Planner, emit_schedule
from .profiler import PhaseProfiler
from .tenancy import TenantHandle, TenantSpec, tenant_of
from .tiers import MachineProfile


@dataclasses.dataclass
class RuntimeConfig:
    fast_capacity_bytes: Optional[int] = None   # default: machine.fast.capacity
    enable_initial_placement: bool = True
    enable_partitioning: bool = True
    enable_local_search: bool = True
    enable_global_search: bool = True
    drift_threshold: float = 0.10
    profile_iterations: int = 1
    seed: int = 0
    # Migration engine: "slack" = slack-aware multi-channel scheduler (the
    # overlap engine), "fifo" = the paper's single-queue phase-boundary mover.
    mover: str = "slack"
    copy_channels: int = 2          # concurrent copy channels ("slack" only)
    # Copy backend, resolved through the string-keyed registry
    # (:mod:`.backends`): "torch" = copies on CUDA copy streams whose tier
    # flips at issue, "torch_async" = tier flips when the copy lands,
    # "sim" = the simulated copy engine.
    backend: str = "torch"
    # Hot-chunk placement pipeline: ingest per-chunk attribution
    # (access_bins), partition along the measured access CDF, attribute
    # chunk references from histogram mass.  False reproduces the paper's
    # object-granularity profiling + equal chunking.
    chunk_aware: bool = True
    # Drift response: keep serving the current plan while re-profiling, then
    # emit only the diff moves.  False restores the paper's full reset
    # (plan dropped, iterations served unplaced until re-profiled).
    incremental_replan: bool = True
    # How much accumulated profile weight survives a drift event (0 = start
    # from scratch, 1 = new observations barely move the running means).
    replan_decay: float = 0.25
    # Placement policy, resolved through the string-keyed policy registry
    # (:mod:`.policy`): the pipeline of attribute -> partition ->
    # coalesce -> solve -> schedule stages that turns profiles into a
    # PlanProgram.  "unimem" is the paper's planner.
    policy: str = "unimem"
    # Re-merge adjacent chunks whose measured densities converged and whose
    # tiers agree (caps chunk-registry growth across drift sequences).
    coalesce: bool = True
    # Scoped replanning: with a standing program, re-solve only the phases
    # whose solve inputs changed (O(affected phases), provably equal to a
    # full replan).  False always re-solves every phase.
    scoped_replan: bool = True
    # Snap partition cuts to registered pytree leaf boundaries so chunks
    # are moveable as whole arrays on real backends (no sub-leaf copies).
    leaf_aligned: bool = False
    # Multi-resolution profiling histograms (core/histogram.py): total bin
    # budget per measured (phase, object) histogram.  None accumulates at
    # the instrumentation's native uniform resolution — the legacy
    # fixed-width behavior, bit-identical plans included.
    histogram_bins: Optional[int] = None
    # Adaptive refinement: between profiling iterations, hot bins re-bin
    # finer (down to the budget's min width) while cold regions coarsen to
    # pay for it, so the next iteration's samples resolve the hot head —
    # and the partitioner may cut hot-head chunks below the legacy one-bin
    # ceiling (re-splitting previously coalesced chunks when drift
    # re-heats them).  Off by default: plans stay bit-identical to the
    # fixed-width pipeline.
    histogram_refine: bool = False
    # Per-channel priorities for the simulated multi-channel copy engine
    # (e.g. [0, 1] reserves channel 1 for urgent fetches: bulk demotion
    # evictions may only use the minimum-priority channels and can never
    # head-of-line-block a fetch).  None = all channels equal (legacy).
    copy_channel_priorities: Optional[Sequence[int]] = None
    # Online calibration feedback (perfmodel.fold_online): after each
    # (re)plan settles, regress the plan's per-phase predicted gains
    # against the measured phase times, fold per-class correction factors
    # into CalibrationConstants.cf_bw/cf_lat (the two benefit classes can
    # be mis-calibrated in opposite directions) and a movement-price
    # factor from measured fence stalls into cf_move, then rebuild the
    # plan under the corrected model.  Off by default — all folds are
    # multiplicative with neutral 1.0 factors, so every plan is
    # bit-identical to the pre-feedback pipeline.
    calibrate_feedback: bool = False
    # Max correction/rebuild rounds per plan epoch (a profiling-driven
    # build re-arms the budget; each recalibration rebuild re-measures).
    calibration_rounds: int = 3
    # Relative |predicted - measured| / measured below which the model
    # counts as calibrated and no correction fires.
    calibration_tolerance: float = 0.10
    # EMA blend toward the regression target (1.0 jumps straight there).
    calibration_blend: float = 1.0
    # Interval-guidance policy (policy="interval", Olson et al. style):
    # per-interval exponential decay of the access-heat ranking.
    interval_decay: float = 0.6
    # Fault injection (core/faults.py): a seeded FaultSpec wraps the
    # resolved backend in a ChaosBackend.  None (default) injects nothing
    # and leaves every plan/trace bitwise identical to the fault-free
    # pipeline.
    fault_spec: Optional[FaultSpec] = None
    # Max transient start_move failures retried per move (the backoff is
    # additionally bounded by the move's slack deadline).
    copy_retry_limit: int = 3
    # Straggler threshold: an in-flight copy exceeding this factor times
    # its priced full-bandwidth time is cancelled and reissued on another
    # channel; the same factor bounds fence waits (deadline abandonment,
    # the no-deadlock guarantee against stuck handles).  None resolves to
    # 4.0 when a fault_spec is set (channel contention alone legitimately
    # costs up to copy_channels x) and stays off otherwise.
    straggler_factor: Optional[float] = None
    # Ring-buffer bound on session.fault_log: long-running chaos/serving
    # loops keep only the most recent entries while the dropped-entry
    # counter keeps provenance counts exact.  0/None = unbounded.
    fault_log_limit: int = 1024
    # Continuous calibration: with calibrate_feedback on, re-arm a
    # measurement (and fold, if the error warrants one) every Nth
    # iteration instead of only once per (re)plan epoch — the background
    # controller for drift the monitor's threshold never trips.  None
    # (default) keeps the per-epoch cadence and is bitwise identical.
    calibrate_every: Optional[int] = None
    # Admission control (bandwidth_partition policy): a tenant whose
    # access density falls below this fraction of the mean across
    # trafficked tenants is demoted to serve-from-slow.  0 disables.
    tenant_admission_heat: float = 0.1
    # Optional churn guard: a tenant whose per-phase hot set exceeds this
    # factor times its capacity share is demoted (its share could never
    # hold a useful fraction of any working set).  None = off.
    tenant_churn_guard: Optional[float] = None
    # Cluster host id this session manages a shard for (None = the
    # unclustered single-host path, bitwise identical to PR 8).  Threads
    # host provenance through plan stage records, fault_log events and
    # stats(), and gives the chaos backend its per-host RNG sub-stream.
    host: Optional[str] = None


@dataclasses.dataclass
class PhaseContext:
    """Handle yielded by ``with rt.phase(...) as pc`` — carries the fence
    stall absorbed at entry and, after exit, the recorded elapsed time and
    the instrumentation sample that was folded into the profiler."""

    name: str
    index: int
    stall_s: float = 0.0
    elapsed: float = 0.0
    sample: Optional[PhaseSample] = None


@dataclasses.dataclass
class TierAudit:
    """Result of :meth:`Session.audit_tiers`: the invariant violations
    found before healing, whether a corrective heal ran, and whether the
    post-heal re-check came back clean."""

    violations: List[str]
    healed: bool = False
    clean_after_heal: bool = True

    @property
    def ok(self) -> bool:
        return not self.violations


class Session:
    """The v2 runtime session (see module docstring)."""

    def __init__(self, machine: MachineProfile,
                 config: Optional[RuntimeConfig] = None,
                 backend: Optional[TierBackend] = None,
                 cf: Optional[CalibrationConstants] = None):
        self.machine = machine
        self.config = config or RuntimeConfig()
        self.registry = ObjectRegistry()
        self.backend = backend if backend is not None else \
            backends_mod.make_backend(
                self.config.backend, machine,
                mover=self.config.mover, channels=self.config.copy_channels,
                priorities=self.config.copy_channel_priorities,
                fault_spec=self.config.fault_spec, host=self.config.host)
        if (self.config.fault_spec is not None
                and not isinstance(self.backend, ChaosBackend)):
            # any backend (including one passed in) gains the configured
            # fault profile; the "chaos" factory already wrapped its inner
            self.backend = ChaosBackend(self.backend, self.config.fault_spec,
                                        host=self.config.host)
        self.cf = cf or CalibrationConstants()
        self.capacity = (self.config.fast_capacity_bytes
                         if self.config.fast_capacity_bytes is not None
                         else machine.fast.capacity_bytes)
        self.profiler = PhaseProfiler(
            machine, seed=self.config.seed,
            hist_bins=self.config.histogram_bins,
            hist_refine=self.config.histogram_refine)
        self.monitor = VariationMonitor(threshold=self.config.drift_threshold)
        self.planner = Planner(
            machine, self.registry, self.cf, self.capacity,
            enact_consistent=self.config.histogram_refine)
        self.policy = policy_mod.make_policy(self.config.policy)
        self.mover: Optional[ProactiveMover] = None
        self.plan: Optional[PlacementPlan] = None
        self.graph: Optional[PhaseGraph] = None
        self.source: Optional[InstrumentationSource] = None
        self._phase_names: List[str] = []
        self._phase_ids: Dict[str, int] = {}
        self._loop_started = False
        self._iter_open = False
        self._open_phase: Optional[str] = None
        self._iteration = 0
        self._events_this_iter: List[PhaseTraceEvent] = []
        self._profiling = True
        self._profiled_iters = 0
        self._baseline_pending = False
        self._plan_n_phases = 0     # phase count the live plan was built on
        # Scoped drift response: the phase indices being re-profiled (None
        # = every phase).  Set by _reprofile, consumed until the rebuild.
        self._drift_scope: Optional[set] = None
        self._static_refs: Dict[str, float] = {}
        self.n_replans = 0              # drift-triggered replan cycles
        self.n_incremental_replans = 0  # ... served without dropping the plan
        # Calibration feedback state: per-iteration measurement
        # accumulators, the per-plan-epoch correction budget, and the flag
        # that invalidates standing-plan reuse after a CF change (a cf
        # change moves every cached benefit without touching any reuse
        # fingerprint, so scoped reuse must be bypassed wholesale).
        self._iter_stall_s = 0.0
        self._iter_elapsed_s = 0.0
        self._iter_phase_elapsed: Dict[int, float] = {}
        self._measuring_baseline = False
        self._measure_pending = False
        self._cal_rounds_left = 0
        self._cf_dirty = False
        # best measured iteration this plan epoch and the constants that
        # produced it — the feedback's safety net: a fold that makes the
        # *measured* iteration worse is reverted, so calibration can only
        # keep a model whose plan demonstrably improved the workload
        self._cal_best: Optional[tuple] = None
        # profiler state frozen at the first fold of an epoch, so a revert
        # re-solves from the same inputs that produced the epoch's best plan
        self._cal_snapshot: Optional[dict] = None
        self.n_recalibrations = 0       # CF folds applied by the feedback
        self.last_measured_iteration_time: Optional[float] = None
        self.last_pred_err: Optional[float] = None
        # Fault-tolerance bookkeeping: the session-level log of
        # DegradedServe/EvictionRollback events (stamped with iteration),
        # the audit counters, and the per-iteration/per-epoch flags that
        # trigger auto-audits and fault provenance.
        self.fault_log = FaultLog(self.config.fault_log_limit)
        self.n_degraded_serves = 0
        self.n_eviction_rollbacks = 0
        self.n_admission_demotions = 0
        # Tenant namespaces (core/tenancy.py): declared QoS contracts,
        # consumed by the bandwidth_partition policy and fault provenance.
        self.tenants: Dict[str, TenantSpec] = {}
        self.n_audits = 0
        self.n_audit_violations = 0
        self.n_heals = 0
        self._faults_this_iter = False
        self._degraded_phases: set = set()      # cleared each iteration
        self._degraded_since_plan = 0
        self._rollbacks_since_plan = 0

    # ------------------------------------------------------------ registration
    def register(self, name: str, spec: Any = None, *,
                 size_bytes: Optional[int] = None,
                 payload: Any = None, chunkable: bool = False,
                 pinned: bool = False,
                 static_refs: Optional[float] = None,
                 manage_payload: Optional[bool] = None) -> DataObject:
        """``unimem_malloc``, pytree-native.

        ``spec`` may be an integer byte size or a pytree (dicts, lists,
        tuples) of tensors (real tensors, or ``meta``-device tensors that
        stand for shapes only);
        for a pytree, each leaf's byte span is recorded on the object so
        downstream attribution can align to leaf boundaries.  Concrete
        array pytrees are kept as the object's movable ``payload`` unless
        ``manage_payload=False`` (register sizes only — the runtime then
        tracks tiers logically, e.g. for donated training state).
        ``static_refs`` feeds the initial-placement compiler analysis."""
        leaf_spans = None
        if spec is not None:
            if isinstance(spec, int):
                size_bytes = spec
            else:
                leaves_with_path = _tree.flatten_with_path(spec)[0]
                spans, off, concrete = [], 0, True
                for path, leaf in leaves_with_path:
                    if not isinstance(leaf, torch.Tensor):
                        raise TypeError(
                            f"leaf {path} of {name!r} is not a tensor; "
                            "register(size_bytes=...) for opaque objects")
                    nbytes = leaf.numel() * leaf.element_size()
                    spans.append((path, off, nbytes))
                    off += nbytes
                    if leaf.is_meta:
                        concrete = False
                leaf_spans = spans
                size_bytes = off
                if payload is None and concrete and manage_payload is not False:
                    payload = spec
        if size_bytes is None:
            if payload is None:
                raise ValueError(f"register({name!r}): need a pytree spec, "
                                 "size_bytes, or payload")
            size_bytes = sum(l.numel() * l.element_size()
                             for l in _tree.leaves(payload))
        obj = self.registry.alloc(name, int(size_bytes), chunkable=chunkable,
                                  payload=payload, pinned=pinned)
        obj.leaf_spans = leaf_spans
        if static_refs is not None:
            self._static_refs[name] = static_refs
        return obj

    def tenant(self, name: str, *, priority: float = 1.0,
               slo: float = 1.0) -> TenantHandle:
        """Declare (or re-fetch) a tenant namespace.

        The returned handle scopes ``register``/``phase`` under
        ``"<name>/"``, so two tenants may both register a ``"kv"`` object
        (distinct qualified names) while a same-tenant duplicate still
        trips the registry's duplicate check.  Access attribution,
        profiles, capacity/channel shares, and fault-log entries all
        carry the tenant id via the name prefix.  Re-declaring an
        existing tenant with different QoS parameters is an error —
        contracts don't silently drift mid-run."""
        spec = TenantSpec(name, priority=priority, slo=slo)
        have = self.tenants.get(name)
        if have is not None:
            if have != spec:
                raise ValueError(
                    f"tenant {name!r} already declared with "
                    f"priority={have.priority:g}, slo={have.slo:g}")
            return TenantHandle(self, have)
        self.tenants[name] = spec
        return TenantHandle(self, spec)

    def attach_source(self, source: Optional[InstrumentationSource]) -> None:
        """Install the instrumentation source consulted at every phase exit
        (explicit keyword overrides on ``phase(...)`` still win)."""
        self.source = source

    # ------------------------------------------------------------- loop set-up
    def _resolved_straggler_factor(self) -> Optional[float]:
        """Explicit config wins; otherwise straggler detection arms itself
        (factor 4.0) whenever faults are injected — the no-deadlock
        guarantee against stuck handles — and stays off fault-free."""
        if self.config.straggler_factor is not None:
            return self.config.straggler_factor
        return 4.0 if self.config.fault_spec is not None else None

    def _make_mover(self):
        if self.config.mover == "slack":
            return SlackAwareMover(
                self.registry, self.backend,
                retry_limit=self.config.copy_retry_limit,
                straggler_factor=self._resolved_straggler_factor())
        if self.config.mover == "fifo":
            return ProactiveMover(self.registry, self.backend,
                                  retry_limit=self.config.copy_retry_limit)
        raise ValueError(f"unknown mover {self.config.mover!r}")

    def _start_loop(self, phase_names: Sequence[str]) -> None:
        """(Re)initialize loop state.  A re-entered loop must not inherit
        the previous loop's plan, drift baselines, or accumulated profiles
        (the ``start_loop`` re-entry bug): everything derived from profiled
        iterations is reset here."""
        self._phase_names = list(phase_names)
        self._phase_ids = {n: i for i, n in enumerate(self._phase_names)}
        self._iteration = 0
        self._profiling = True
        self._profiled_iters = 0
        self.plan = None
        self._baseline_pending = False
        self._plan_n_phases = 0
        self._drift_scope = None
        self._events_this_iter = []
        self._iter_open = False
        self._open_phase = None
        self._iter_stall_s = 0.0
        self._iter_elapsed_s = 0.0
        self._iter_phase_elapsed = {}
        self._measuring_baseline = False
        self._measure_pending = False
        self._cal_rounds_left = 0
        self._cf_dirty = False
        self._cal_best = None
        self._cal_snapshot = None
        self.last_measured_iteration_time = None
        self.last_pred_err = None
        self._faults_this_iter = False
        self._degraded_phases = set()
        self._degraded_since_plan = 0
        self._rollbacks_since_plan = 0
        self.profiler.clear()
        self.monitor = VariationMonitor(threshold=self.config.drift_threshold)
        self.graph = PhaseGraph(
            [Phase(i, n) for i, n in enumerate(self._phase_names)])
        self.mover = self._make_mover()
        self._loop_started = True
        if self.config.enable_initial_placement and self._static_refs:
            placed = initial_mod.initial_placement(
                self.registry, self._static_refs, self.capacity)
            place = getattr(self.backend, "place", None)
            for name in placed:
                if place is not None:   # allocation-time placement: no copy
                    place(self.registry[name], "fast")
                else:
                    try:
                        self.backend.start_move(self.registry[name], "fast")
                    except CopyError:
                        # initial placement is a best-effort hint — a
                        # failed placement copy just means the object
                        # starts slow and the plan fetches it later
                        continue

    def _ensure_loop(self) -> None:
        if not self._loop_started:
            self._start_loop([])

    def _phase_id(self, name: str) -> int:
        """Resolve a phase name, auto-registering it on first use."""
        idx = self._phase_ids.get(name)
        if idx is not None:
            return idx
        idx = len(self._phase_names)
        self._phase_ids[name] = idx
        self._phase_names.append(name)
        if self.graph is not None:
            self.graph.phases.append(Phase(idx, name))
        return idx

    # --------------------------------------------------------------- contexts
    @contextlib.contextmanager
    def iteration(self):
        """One main-loop iteration (``unimem_start``/``unimem_end``): the
        loop auto-starts on first entry; profiling, planning and drift
        bookkeeping run at exit.  An exception abandons the iteration's
        buffered events so the next iteration starts clean."""
        self._ensure_loop()
        if self._iter_open:
            raise RuntimeError("iterations cannot nest")
        self._begin_iteration()
        try:
            yield self
        except BaseException:
            self._iter_open = False
            self._open_phase = None
            self._events_this_iter = []
            raise
        self._end_iteration()

    @contextlib.contextmanager
    def phase(self, name, *, accesses: Optional[Dict[str, float]] = None,
              time_shares: Optional[Dict[str, float]] = None,
              access_bins: Optional[Dict[str, Sequence[float]]] = None,
              elapsed: Optional[float] = None):
        """One phase of the iteration.  ``name`` is a phase name
        (auto-registered on first use) or a pre-registered phase index.

        Entry fences and triggers proactive moves; exit records the phase's
        elapsed time (explicit ``elapsed`` > the source's virtual time >
        the context's wall clock) and folds the instrumentation into the
        profiler/monitor.  Explicit keyword instrumentation wins over the
        attached source; an exception closes the phase without recording
        (a crashed phase's timing is garbage), so a phase can never be
        left open."""
        self._ensure_loop()
        if not self._iter_open:
            raise RuntimeError(
                f"phase({name!r}) outside an iteration; wrap the loop body "
                "in `with rt.iteration():`")
        if self._open_phase is not None:
            raise RuntimeError(
                f"phase {self._open_phase!r} is still open; phases cannot "
                "nest")
        if isinstance(name, int):
            if not 0 <= name < len(self._phase_names):
                raise IndexError(f"phase index {name} out of range "
                                 f"(registered: {self._phase_names})")
            index = name
        else:
            index = self._phase_id(name)
        pname = self._phase_names[index]
        self._open_phase = pname
        stall = self._phase_begin(index)
        ctx = PhaseContext(name=pname, index=index, stall_s=stall)
        t0 = _time.perf_counter()
        try:
            yield ctx
        except BaseException:
            self._open_phase = None
            raise
        wall = _time.perf_counter() - t0
        sample = None
        if self.source is not None:
            # per-field precedence: explicit keyword > source > measured
            # (an explicit accesses override must not silently discard the
            # source's virtual elapsed or its access_bins)
            sample = self.source.collect(pname)
            if accesses is None:
                accesses = sample.accesses
            if time_shares is None:
                time_shares = sample.time_shares
            if access_bins is None:
                access_bins = sample.access_bins
            if elapsed is None:
                elapsed = sample.elapsed
        ctx.elapsed = elapsed if elapsed is not None else wall
        ctx.sample = sample
        self._open_phase = None
        self._phase_end(index, elapsed=ctx.elapsed, accesses=accesses,
                        time_shares=time_shares, access_bins=access_bins)

    # ------------------------------------------------------------- main loop
    def _begin_iteration(self) -> None:
        self._iter_open = True
        self._events_this_iter = []
        self._iter_stall_s = 0.0
        self._iter_elapsed_s = 0.0
        self._iter_phase_elapsed = {}
        self._degraded_phases = set()
        # The plan's prediction made observable: the first *settled*
        # iteration after a (re)plan — the one that begins with the
        # monitor-baseline window already closed, so the plan's one-time
        # enactment transient (bulk fetches landing mid-iteration) does
        # not contaminate the steady-state measurement the feedback
        # regresses against.  Its measured time (phase elapsed + fence
        # stalls) closes the loop at _end_iteration.
        self._measuring_baseline = (self._measure_pending
                                    and self.plan is not None
                                    and not self._baseline_pending
                                    and not self._profiling)

    def _phase_begin(self, index: int) -> float:
        """Enter phase ``index``: fence + trigger proactive moves.  Returns
        the fence stall in seconds (simulated backends) — real backends
        block and return 0.

        The mover is driven with the phase count the plan was *built*
        against, not the live one: auto-registration can grow the phase
        list under a live plan (a conditional eval/ckpt phase entered
        mid-loop), and a changed modulus would re-wrap negative
        trigger_phase moves onto the wrong boundary.  A phase the plan has
        never seen has no moves keyed to it — skip the mover entirely."""
        if self.plan is not None and self.mover is not None:
            n = self._plan_n_phases or len(self._phase_names)
            if index >= n:
                return 0.0
            stall = self.mover.on_phase_start(self.plan, index, n)
            self._drain_mover_faults()
            self._iter_stall_s += stall
            return stall
        return 0.0

    def _phase_end(self, index: int, *, elapsed: float,
                   accesses: Optional[Dict[str, float]] = None,
                   time_shares: Optional[Dict[str, float]] = None,
                   access_bins: Optional[Dict[str, Sequence[float]]] = None
                   ) -> None:
        """Leave phase ``index``.  ``accesses`` are the true per-object
        main-memory access counts for this execution (the instrumentation
        the paper gets from PEBS sampling); ``access_bins`` optionally
        carries each object's access distribution over its byte range
        (per-chunk attribution — the sampled address histogram)."""
        if not self.config.chunk_aware:
            access_bins = None
        ev = PhaseTraceEvent(phase_index=index, time=elapsed,
                             accesses=dict(accesses or {}),
                             time_shares=time_shares,
                             access_bins=access_bins)
        self._events_this_iter.append(ev)
        self._iter_elapsed_s += elapsed
        self._iter_phase_elapsed[index] = (
            self._iter_phase_elapsed.get(index, 0.0) + elapsed)
        if self._profiling:
            # Scoped drift response: only the drifted phases re-observe, so
            # every other phase's profile state stays bitwise identical and
            # its standing plan decision remains provably reusable.  A
            # phase whose access *set* visibly changed joins the scope even
            # if its time held (instrumentation is collected every
            # iteration, so the check is free).
            if (self._drift_scope is not None
                    and index not in self._drift_scope
                    and self._access_set_drifted(ev)):
                self._drift_scope.add(index)
                self.profiler.decay(self.config.replan_decay,
                                    phases=[index])
            if self._drift_scope is None or index in self._drift_scope:
                self.profiler.observe(ev)
        elif self._baseline_pending:
            # First iteration after (re)planning: phase times now reflect the
            # enacted placement — record them as the monitor baseline (the
            # paper monitors performance *after* data movement).
            self.monitor.set_baseline(index, elapsed)
            if index == len(self._phase_names) - 1:
                self._baseline_pending = False
        else:
            # a phase served degraded this iteration carries a *confirmed*
            # fault slowdown — the monitor skips its debounce for it
            drift = self.monitor.observe(
                index, elapsed, faulted=index in self._degraded_phases)
            if drift is not None:
                self._reprofile()

    def _end_iteration(self) -> None:
        self._iter_open = False
        self._iteration += 1
        if self._profiling:
            self._profiled_iters += 1
            if self._profiled_iters >= self.config.profile_iterations:
                self._build_plan()
                self._profiling = False
                self._profiled_iters = 0
            elif self.config.histogram_refine:
                # Multi-resolution refinement between profiling iterations
                # (never after the last: a split without a subsequent
                # observation carries no new information): the next
                # iteration's sampled addresses land in the refined bins,
                # so the hot head resolves finer at the same bin budget.
                # Scoped to the drifted phases during a scoped drift
                # response, so every other phase's profile state — and its
                # standing plan decision — stays bitwise intact.
                self.profiler.refine_histograms(
                    self.config.histogram_bins,
                    phases=(sorted(self._drift_scope)
                            if self._drift_scope is not None else None))
        elif self._baseline_pending and self._events_this_iter:
            # variable phase sets: if the baseline iteration did not reach
            # the last registered phase, close the baseline window here
            self._baseline_pending = False
        if (self._measuring_baseline and not self._baseline_pending
                and self.plan is not None and self._events_this_iter):
            self._measuring_baseline = False
            self._measure_pending = False
            self._on_baseline_measured(self._iter_elapsed_s
                                       + self._iter_stall_s)
        # Continuous calibration: every Nth iteration re-arms a settled
        # measurement so the feedback keeps folding between plan epochs
        # (per-epoch measurements stay the primary signal — the periodic
        # re-arm only fires when no measurement is already in flight).
        N = self.config.calibrate_every
        if (N and self.config.calibrate_feedback and self.plan is not None
                and not self._profiling and not self._baseline_pending
                and not self._measure_pending and not self._measuring_baseline
                and self._iteration % N == 0):
            self._measure_pending = True
            self._cal_rounds_left = max(self._cal_rounds_left, 1)
        # any failure path this iteration triggers the tier-state audit
        # (self-healing); heal-time correctives may fault too — drain them
        self._drain_mover_faults()
        if self._faults_this_iter:
            self._faults_this_iter = False
            self.audit_tiers()
            self._drain_mover_faults()
            self._faults_this_iter = False

    # --------------------------------------------------------- fault handling
    def _drain_mover_faults(self) -> bool:
        """Collect the mover's DegradedServe/EvictionRollback events into
        the session log (stamped with the iteration) and update counters.
        Returns True when new events were drained."""
        events = getattr(self.mover, "fault_events", None)
        if not events:
            return False
        n = self._plan_n_phases or len(self._phase_names) or 1
        for ev in events:
            ev.iteration = self._iteration
            if self.tenants and getattr(ev, "tenant", None) is None:
                ev.tenant = tenant_of(ev.obj, self.tenants)
            if self.config.host is not None:
                ev.host = self.config.host
            self.fault_log.append(ev)
            if isinstance(ev, DegradedServe):
                self.n_degraded_serves += 1
                self._degraded_since_plan += 1
                self._degraded_phases.add(ev.phase_index % n)
            else:
                self.n_eviction_rollbacks += 1
                self._rollbacks_since_plan += 1
        events.clear()
        self._faults_this_iter = True
        return True

    def _audit_violations(self) -> List[str]:
        """Cross-check runtime residency, the mover's in-flight book, and
        the capacity book.  Violation-free on every fault-free run *and*
        after every handled failure (rollbacks keep residency consistent
        by never flipping tiers)."""
        violations: List[str] = []
        for obj in self.registry:
            if obj.tier not in ("fast", "slow"):
                violations.append(
                    f"{obj.name}: invalid tier {obj.tier!r}")
        inflight = (getattr(self.mover, "_inflight", None) or {}
                    if self.mover is not None else {})
        evict_inflight = set()
        for name, h in inflight.items():
            if _handle_orphaned(self.registry, name, h):
                violations.append(
                    f"{name}: in-flight handle for a retired object")
            elif (getattr(h, "dst", None) == "slow"
                    and not getattr(h, "landed", False)):
                evict_inflight.add(name)
        # Capacity book.  Evictions are issued lazily (at their trigger
        # phase), so settled fast residency legitimately overshoots the
        # budget *between* an object's fetch and its scheduled departure —
        # only bytes with no booked departure count against capacity.  A
        # departure is booked by an in-flight eviction (landing flips the
        # tier) or a plan-scheduled one (the cyclic schedule re-evicts
        # every iteration, which is also what re-absorbs a rolled-back
        # eviction).  The heal's corrective evictions land in the
        # in-flight set, which is what makes healing convergent.
        planned_evict: set = set()
        planned_fast: set = set()
        if self.plan is not None:
            planned_evict = {m.obj for m in self.plan.moves
                             if m.dst == "slow"}
            for residents in self.plan.residents:
                planned_fast |= set(residents)
            for obj in self.registry:
                if (obj.tier == "fast" and not obj.pinned
                        and obj.name not in planned_fast
                        and obj.name not in planned_evict
                        and obj.name not in evict_inflight):
                    violations.append(
                        f"{obj.name}: fast residency diverged from the "
                        f"plan (placed slow everywhere, no eviction booked)")
        booked = evict_inflight | planned_evict
        fast_bytes = sum(o.size_bytes for o in self.registry
                         if o.tier == "fast" and o.name not in booked)
        if fast_bytes > self.capacity:
            violations.append(
                f"capacity: {fast_bytes} standing fast bytes (no booked "
                f"departure) exceed the fast tier's {self.capacity}")
        return violations

    def audit_tiers(self, heal: bool = True) -> TierAudit:
        """Tier-state reconciliation audit (run automatically after any
        failure path; assertable in tests).  Divergence self-heals with a
        one-shot corrective reconciliation via :meth:`_restore_plan` —
        the same mechanics the calibration revert uses."""
        self.n_audits += 1
        violations = self._audit_violations()
        if not violations:
            return TierAudit(violations=[])
        self.n_audit_violations += len(violations)
        if not heal or self.plan is None:
            return TierAudit(violations=violations, healed=False,
                             clean_after_heal=False)
        self.n_heals += 1
        self._restore_plan(self.plan)
        post = self._audit_violations()
        return TierAudit(violations=violations, healed=True,
                         clean_after_heal=not post)

    # ------------------------------------------------------------- internals
    def _pipeline_state(self) -> "policy_mod.PipelineState":
        """Characterized inputs for the placement-policy pipeline.  The
        standing program (when a plan is live and incremental replanning is
        on) lets the solve stage re-solve only the phases whose inputs
        changed."""
        # A CF fold moves every cached benefit value without touching any
        # reuse fingerprint (profile versions and registry generation are
        # unchanged), so after one the standing program must be dropped
        # wholesale — scoped reuse would splice stale-benefit decisions
        # into the recalibrated plan.
        standing = (self.plan
                    if (self.config.incremental_replan
                        and not self._cf_dirty
                        and isinstance(self.plan, policy_mod.PlanProgram))
                    else None)
        return policy_mod.PipelineState(
            machine=self.machine, registry=self.registry, graph=self.graph,
            profiler=self.profiler, planner=self.planner,
            capacity=self.capacity, config=self.config, standing=standing,
            tenants=dict(self.tenants) if self.tenants else None,
            drift_scope=(sorted(self._drift_scope)
                         if self._drift_scope is not None
                         and standing is not None else None))

    def _build_plan(self, *, recalibration: bool = False) -> None:
        assert self.graph is not None
        self.plan = self.policy.build(self._pipeline_state())
        self._drift_scope = None
        self._cf_dirty = False
        if self.plan is None:
            return
        if (self.config.host is not None
                and isinstance(self.plan, policy_mod.PlanProgram)):
            self.plan.host = self.config.host
        if ((self._degraded_since_plan or self._rollbacks_since_plan)
                and isinstance(self.plan, policy_mod.PlanProgram)):
            # fault-bearing rebuild: stamp the provenance (an *extra*
            # entry — the canonical stage list is untouched)
            self.plan.provenance.append(policy_mod.fault_provenance(
                self._degraded_since_plan, self._rollbacks_since_plan,
                self.profiler.epoch, self.registry.generation,
                hist_epoch=getattr(self.profiler, "hist_epoch", 0)))
        self._degraded_since_plan = 0
        self._rollbacks_since_plan = 0
        # Admission-control provenance: every tenant the bandwidth
        # partition demoted to serve-from-slow this epoch gets a
        # DegradedServe entry (phase -1 = whole-tenant, not one fetch).
        # Logged directly — not via mover fault_events — so the chaos
        # counters and the fault-triggered audit stay untouched.
        for t, why in sorted(
                (getattr(self.plan, "tenant_admission", None) or {}).items()):
            self.n_admission_demotions += 1
            self.fault_log.append(DegradedServe(
                obj=t, phase_index=-1, reason=f"admission:{why}",
                iteration=self._iteration, tenant=t,
                host=self.config.host))
        if not recalibration:
            # a profiling-driven build opens a new plan epoch: re-arm the
            # calibration-correction budget and the best-measured memory
            self._cal_rounds_left = self.config.calibration_rounds
            self._cal_best = None
            self._cal_snapshot = None
        self._measure_pending = True
        self._plan_n_phases = len(self._phase_names)
        self._baseline_pending = True
        self.monitor.consume_events()
        # Enact iteration-start moves for the new plan immediately.
        if self.mover is not None:
            if hasattr(self.mover, "load_plan"):
                self.mover.load_plan(self.plan, self.graph)
            self.mover.on_phase_start(self.plan, 0, self._plan_n_phases)
            self._drain_mover_faults()

    def _on_baseline_measured(self, measured: float) -> None:
        """Calibration feedback — the live extension of
        :func:`perfmodel.calibrate`'s CF idiom (paper §3.1.2) to in-loop
        observations.  The first settled iteration after a (re)plan is
        the plan's own prediction made observable: ``measured`` is its
        phase elapsed plus fence stalls, directly comparable to
        ``predicted_iteration_time`` (baseline − modeled gain + unhidden
        movement cost).  When the relative error exceeds the tolerance,
        two measurement channels the session already separates fold
        corrections into the constants:

        * **per-phase elapsed** — each phase's realized gain (profiled
          baseline time minus measured time) against the plan's booked
          per-class gains regresses multiplicative corrections onto
          ``cf_bw`` / ``cf_lat`` (:func:`perfmodel.solve_gain_folds`;
          only a per-class fold can change the knapsack's ranking);
        * **fence stalls** — measured stall over booked unhidden movement
          cost calibrates the movement-price factor ``cf_move``.

        The plan is then rebuilt under the corrected model — bounded by
        ``calibration_rounds`` per plan epoch so a noisy workload cannot
        thrash the solve."""
        assert self.plan is not None
        plan = self.plan
        predicted = plan.predicted_iteration_time
        self.last_measured_iteration_time = measured
        self.last_pred_err = (abs(predicted - measured) / measured
                              if measured > 0 else None)
        if not self.config.calibrate_feedback:
            return
        if self._cal_best is None or measured < self._cal_best[0]:
            self._cal_best = (measured, self.cf, plan)
        # The epoch closes when the correction budget is spent, the model
        # believes itself (predicted within tolerance of measured), or the
        # fold trajectory is demonstrably worsening — the corrected model's
        # plan measures more than half a tolerance band worse than the
        # epoch's best.  The early stop matters as much as the folds: every
        # additional excursion iteration both runs slow *and* pollutes the
        # profiler history the eventual revert rebuilds from.
        band = 1.0 + 0.5 * self.config.calibration_tolerance
        worsening = (self._cal_best is not None
                     and measured > self._cal_best[0] * band)
        closing = (self._cal_rounds_left <= 0 or self.last_pred_err is None
                   or self.last_pred_err <= self.config.calibration_tolerance
                   or worsening)
        if closing:
            # Best-of-measured safety net, decided once per epoch: the fold
            # trajectory may climb through worse intermediate plans and can
            # also end *honest but pessimal* — a self-consistent model whose
            # plan measures worse than the uncorrected one.  Reverting
            # restores the epoch's best *plan*, not just its constants:
            # re-solving under the old constants is a lottery, because the
            # knapsack weighs benefit minus fetch cost and objects the
            # excursion already moved fast are selected for free while the
            # best plan's picks now carry fetch costs (placement lock-in).
            # Near-ties inside the band stay on the current constants.
            (best_meas, best_cf, best_plan) = (
                self._cal_best if self._cal_best is not None
                else (measured, self.cf, plan))
            snapshot, self._cal_snapshot = self._cal_snapshot, None
            self._cal_rounds_left = 0
            self._cal_best = None
            if best_cf is not self.cf and measured > best_meas * band:
                best_cf = dataclasses.replace(
                    best_cf, provenance=best_cf.provenance
                    + (f"online:revert(iter{self._iteration})",))
                self.cf = best_cf
                self.planner.cf = best_cf
                if snapshot is not None:
                    # the excursion's iterations ran under thrashing plans;
                    # drop the history they contaminated (identity-preserving
                    # restore: other components hold the same object) so the
                    # restored plan's standing state and any later drift
                    # replan see the inputs that produced it.
                    self.profiler.__dict__.clear()
                    self.profiler.__dict__.update(snapshot)
                self._cf_dirty = False
                self._restore_plan(best_plan)
            return
        rows = []
        pb, gb, gl = (plan.phase_baseline, plan.phase_gain_bw,
                      plan.phase_gain_lat)
        for idx, elapsed in sorted(self._iter_phase_elapsed.items()):
            if idx < len(pb) and idx < len(gb) and idx < len(gl) \
                    and (gb[idx] != 0.0 or gl[idx] != 0.0):
                rows.append((gb[idx], gl[idx], pb[idx] - elapsed))
        mult_bw, mult_lat = (perfmodel.solve_gain_folds(rows)
                             if rows else (1.0, 1.0))
        booked_cost = sum(m.est_unhidden_cost for m in plan.moves)
        # nothing booked -> the stall ratio is unattributable; stay put
        mult_move = (self._iter_stall_s / booked_cost
                     if booked_cost > 1e-12 else 1.0)
        new_cf = perfmodel.fold_online(
            self.cf, gain_bw=mult_bw, gain_lat=mult_lat, move=mult_move,
            blend=self.config.calibration_blend,
            note=self._fold_note())
        if new_cf is self.cf:
            return
        if self._cal_snapshot is None:
            self._cal_snapshot = copy.deepcopy(self.profiler.__dict__)
        self._cal_rounds_left -= 1
        self.n_recalibrations += 1
        self.cf = new_cf
        self.planner.cf = new_cf
        self._cf_dirty = True
        self._build_plan(recalibration=True)

    def _fold_note(self) -> str:
        """Provenance note for an online CF fold.  With tenants declared,
        names the namespaces whose phases contributed measurements this
        iteration, so a fold's origin is attributable per tenant."""
        note = f"iter{self._iteration}"
        if not self.tenants:
            return note
        seen = set()
        for idx in self._iter_phase_elapsed:
            if 0 <= idx < len(self._phase_names):
                t = tenant_of(self._phase_names[idx], self.tenants)
                if t is not None:
                    seen.add(t)
        if seen:
            note += "[" + ",".join(sorted(seen)) + "]"
        return note

    def _restore_plan(self, plan: PlacementPlan) -> None:
        """Re-enact a previously measured plan from the live tier state.

        The plan's recurring schedule encodes its phase-to-phase rotation,
        and move issue is idempotent (an object already at its destination
        is skipped), so resuming the schedule is sound once the tier state
        is reconciled to the plan's iteration-start residency: corrective
        fetches bring missing residents in, corrective evictions push out
        stragglers the excursion left behind (without them the restored
        plan would silently enjoy more than its capacity-checked budget).
        The correctives are enacted *once*, through a throwaway copy of the
        plan, and the session keeps the pristine plan: the mover replays
        ``plan.moves`` every iteration, so a corrective baked into the
        standing plan would recur — evicting an object the plan re-fetches
        mid-iteration each time around, a permanent thrash cycle the plan
        never asked for.  ``est_unhidden_cost`` stays 0 because they are
        one-time reconciliation moves, not per-iteration plan cost."""
        assert self.graph is not None
        want0 = plan.residents[0] if plan.residents else set()
        corrective: List[MoveOp] = []
        for obj in self.registry:
            if obj.pinned:
                continue
            if obj.name in want0:
                if obj.tier != "fast":
                    corrective.append(
                        MoveOp(obj.name, "fast", 0, 0, obj.size_bytes))
            elif obj.tier == "fast":
                corrective.append(
                    MoveOp(obj.name, "slow", 0, 0, obj.size_bytes))
        enact = plan
        if corrective:
            enact = dataclasses.replace(
                plan, moves=list(plan.moves) + corrective,
                schedule=(list(plan.schedule) + emit_schedule(
                    corrective, self.graph, self.machine.copy_bw)
                    if plan.schedule else []))
        self.plan = plan
        self._drift_scope = None
        self._measure_pending = True
        self._plan_n_phases = len(self._phase_names)
        self._baseline_pending = True
        self.monitor.consume_events()
        if self.mover is not None:
            if hasattr(self.mover, "load_plan"):
                self.mover.load_plan(enact, self.graph)
            self.mover.on_phase_start(enact, 0, self._plan_n_phases)
            self._drain_mover_faults()

    def _reprofile(self) -> None:
        """Drift response.  Incremental (default): keep serving the current
        plan, decay the profile history so fresh observations dominate, and
        rebuild from the live tier state when enough iterations re-profiled —
        the plan is never dropped, so no iteration runs unplaced.  Legacy:
        the paper's full reset.

        With ``scoped_replan`` and a standing program, the re-profiling
        itself is *scoped to the drifted phases*: only their histories are
        decayed and re-observed, every other phase's profile state stays
        bitwise identical, and the rebuild re-solves O(drifted phases)
        knapsacks instead of O(plan).  A phase that drifted without
        tripping the monitor is caught on the next cycle (its post-replan
        baseline re-arms the monitor)."""
        self.n_replans += 1
        if self.config.incremental_replan and self.plan is not None:
            self.n_incremental_replans += 1
            drifted = set(self.monitor.drifted_phases())
            scope = None
            if (self.config.scoped_replan and drifted
                    and isinstance(self.plan, policy_mod.PlanProgram)):
                scope = drifted
            self._drift_scope = scope
            self.profiler.decay(
                self.config.replan_decay,
                phases=sorted(scope) if scope is not None else None)
            if self.config.histogram_refine:
                # refine before the re-profiling window opens so the
                # re-observed iterations sample into the adapted bins (a
                # re-heated region's bins split; the re-split pass can
                # then cut below the old coarse ceiling at rebuild)
                self.profiler.refine_histograms(
                    self.config.histogram_bins,
                    phases=sorted(scope) if scope is not None else None)
            self._profiling = True
            self._profiled_iters = 0
        else:
            self._drift_scope = None
            self.profiler.clear()
            self._profiling = True
            self._profiled_iters = 0
            self.plan = None
            self._iteration = 0
        # Drift fires mid-iteration: the phases already executed this
        # iteration (including the drifted one) were routed to the monitor,
        # not the profiler — replay them so the re-profiling window covers
        # the full iteration, not just the phases after the drift.
        for ev in self._events_this_iter:
            if (self._drift_scope is not None
                    and ev.phase_index not in self._drift_scope
                    and self._access_set_drifted(ev)):
                self._drift_scope.add(ev.phase_index)
                self.profiler.decay(self.config.replan_decay,
                                    phases=[ev.phase_index])
            if self._drift_scope is None or ev.phase_index in self._drift_scope:
                self.profiler.observe(ev)

    def _access_set_drifted(self, ev: PhaseTraceEvent) -> bool:
        """Access-mix drift the time-based monitor cannot see: an object
        carrying a material share of this execution's accesses has no
        profile entry for the phase (it appeared), or a profiled hot
        object received none (it vanished)."""
        total = sum(ev.accesses.values())
        profs = self.profiler.profiles_for_phase(ev.phase_index)
        if total > 0.0:
            for obj, acc in ev.accesses.items():
                if acc > 0.05 * total and obj not in profs:
                    return True
        ptotal = sum(p.data_access for p in profs.values())
        for obj, p in profs.items():
            if (p.data_access > 0.05 * max(ptotal, 1.0)
                    and ev.accesses.get(obj, 0.0) <= 0.0):
                return True
        return False

    # ------------------------------------------------------------- reporting
    def phase_names(self) -> List[str]:
        """Registered phases in first-use order."""
        return list(self._phase_names)

    def stats(self) -> Dict[str, Any]:
        mv = self.mover.stats if self.mover else None
        busy = getattr(self.backend, "busy_seconds", None)
        copy_busy_s = busy() if busy is not None else None
        overlap_time = None
        if copy_busy_s and mv is not None:
            overlap_time = max(0.0, 1.0 - mv.fence_stall_s / copy_busy_s)
        return dict(
            iteration=self._iteration,
            strategy=self.plan.strategy if self.plan else None,
            predicted_iteration_time=(self.plan.predicted_iteration_time
                                      if self.plan else None),
            mover=self.config.mover,
            n_moves=mv.n_moves if mv else 0,
            moved_bytes=mv.moved_bytes if mv else 0,
            overlap_fraction=mv.overlap_fraction if mv else None,
            fence_stall_s=mv.fence_stall_s if mv else 0.0,
            copy_busy_s=copy_busy_s,
            overlap_time_fraction=overlap_time,
            fast_resident_bytes=self.registry.bytes_in_tier("fast"),
            n_objects=len(self.registry),
            n_replans=self.n_replans,
            n_incremental_replans=self.n_incremental_replans,
            measured_iteration_time=self.last_measured_iteration_time,
            pred_err=self.last_pred_err,
            cf_bw=self.cf.cf_bw,
            cf_lat=self.cf.cf_lat,
            cf_move=self.cf.cf_move,
            n_recalibrations=self.n_recalibrations,
            # fault tolerance (all zero / empty on a fault-free run)
            n_retries=mv.n_retries if mv else 0,
            n_degraded_serves=self.n_degraded_serves,
            n_eviction_rollbacks=self.n_eviction_rollbacks,
            fault_log_dropped=getattr(self.fault_log, "dropped", 0),
            # multi-tenancy (zero / empty without declared tenants)
            n_tenants=len(self.tenants),
            n_admission_demotions=self.n_admission_demotions,
            n_straggler_reissues=mv.n_straggler_reissues if mv else 0,
            n_audits=self.n_audits,
            n_audit_violations=self.n_audit_violations,
            n_heals=self.n_heals,
            channel_health=(self.mover.health.summary()
                            if hasattr(self.mover, "health") else {}),
            # multi-host provenance (None on the unclustered path)
            host=self.config.host,
        )
