"""Data placement decision (paper §3.1.3).

Two searches, both driven by Eq. (1)-(5) and solved as 0/1 knapsacks:

* **phase-local search** — phases are decided one by one in order, with full
  knowledge of what earlier decisions left resident in the fast tier.
  Candidates are the objects the phase references; each candidate's weight is
  ``w = BFT - COST - extra_COST`` where ``extra_COST`` prices evicting
  just-big-enough non-candidate residents.  Moves are scheduled at the
  earliest dependency-safe trigger point (Fig 5) so the proactive mover can
  overlap them.
* **cross-phase global search** — one knapsack over per-object benefit summed
  across all phases; a single placement for the whole iteration, no
  steady-state movement.

The planner predicts the iteration time of each plan with the same models and
keeps the better one (the paper's best-of-two).

**Scale.** The planner is a serving-tick operation: a scoped replan at
10k-100k chunks must land in O(10 ms).  The default ``vectorized`` mode is
an end-to-end array program — candidate extraction, Eq. (1)-(3) benefit
evaluation, Eq. (4) move pricing, eviction quoting and the knapsack itself
all run over numpy arrays (:class:`_ProfileView` blocks per (phase, parent),
:class:`_PhaseLayout` per phase) with no per-candidate Python loop left on
the hot path.  ``vectorized=False`` preserves the original per-candidate
scalar path — the oracle for equivalence tests and the baseline for the
planner-latency benchmark; both modes produce identical plans bit for bit.

**Amortization.** All shape-dependent preprocessing is cached on the
planner across ticks and invalidated by the exact inputs it derives from:
chunk spans and registry lookup tables per ``registry.generation``
(:class:`_GenCache`), profile blocks per ``profiler.phase_version``
(:class:`_ProfileView.refresh`), candidate layouts per (phase refs,
generation, profiled parents) (:class:`_PhaseLayout`), trigger points and
overlap windows per graph digest (:class:`_TriggerIndex`), and the
cross-phase candidate universe per (digest, generation).  A tick that
drifts one phase recomputes that phase's blocks and row and nothing else.

**Scoped replanning.** ``plan_local`` records one :class:`PhaseDecision`
per phase: the residency it entered with, a *fingerprint* of every input
the phase's solve read (reference set, candidate benefits, dependency-safe
trigger points and overlap windows), and the decision it produced (moves,
exit residency).  A replan handed the standing decisions
(``plan_local(..., standing=...)``) re-solves **only** the phases whose
entry state or fingerprint changed and splices the cached decisions for
the rest — so a localized drift re-solves O(affected phases) knapsacks
instead of O(plan), while remaining *provably equal* to a full replan:
any phase whose inputs changed in any way fails the fingerprint match and
is re-solved, and residency changes cascade until the entry state
re-converges with the cached trajectory.

``plan_global`` is scoped the same way: per-phase benefit rows
(:class:`GlobalContrib`) are reused when their (profile version, registry
generation, object universe) key still matches, the totals are re-summed
from the rows in phase order (never incrementally updated — float
summation order is part of the bit-identity contract), and the whole
decision is memoized so a zero-drift rebuild returns it outright.  When
the chooser supplies the local plan's predicted time (``prune_above``), a
fractional-knapsack upper bound on the global gains can prove "global
cannot win this rebuild" and skip the solve entirely; the pruned result
carries a certified lower bound on the global predicted time, so the
best-of-two chooser picks the same winner it would have with a full
solve.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import knapsack, perfmodel
from .data_objects import ObjectRegistry
from .partition import bin_mass, chunk_spans
from .perfmodel import CalibrationConstants
from .phase import PhaseGraph
from .profiler import PhaseProfiler
from .tiers import MachineProfile


@dataclasses.dataclass(frozen=True)
class MoveOp:
    """One scheduled tier move.

    ``trigger_phase`` may be negative: trigger in the *previous* iteration,
    ``n + trigger_phase`` phases from its start.  ``est_unhidden_cost`` is the
    Eq. (4) cost the model expects to remain on the critical path.
    ``est_benefit`` is the Eq. (5) benefit that justified the move — the
    slack-aware scheduler uses it to break priority ties."""

    obj: str
    dst: str                     # "fast" | "slow"
    trigger_phase: int
    needed_by: int               # phase index whose start fences the move
    size_bytes: int
    est_unhidden_cost: float = 0.0
    est_benefit: float = 0.0


@dataclasses.dataclass(frozen=True)
class ScheduledMove:
    """A MoveOp with timing annotations: *when* to start it, not just where
    the object lives (the schedule-emission path of the slack-aware mover).

    ``window_s`` is the compute time between the move's trigger point and the
    start of its consuming phase; ``duration_s`` the copy time at full engine
    bandwidth; ``slack_s = window_s - duration_s`` is how long the move's
    start may be delayed past its trigger before it lands late.  Negative
    slack means the fence will stall no matter what — those moves are issued
    first."""

    op: MoveOp
    window_s: float
    duration_s: float
    slack_s: float

    @property
    def urgency(self) -> tuple:
        """Sort key: tightest slack first, then biggest benefit per byte."""
        density = self.op.est_benefit / max(self.op.size_bytes, 1)
        return (self.slack_s, -density)


@dataclasses.dataclass(frozen=True)
class PhaseDecision:
    """One phase's local-search solve, recorded for scoped replanning.

    ``fingerprint`` captures every input the phase's knapsack read beyond
    the entry residency: the phase's reference set, each candidate's
    Eq. (1)-(3) benefit, and each candidate's dependency-safe trigger point
    and overlap window (which couple the phase to the rest of the graph's
    measured times).  A replan may reuse the decision verbatim iff the
    entry state *and* the fingerprint match bitwise — anything else
    re-solves, which is what makes scoped replans provably equal to full
    replans."""

    phase_index: int
    entry_residents: frozenset
    entry_bytes: int
    fingerprint: tuple
    moves: Tuple[MoveOp, ...]
    exit_residents: frozenset
    exit_bytes: int
    # Eq. (1)-(3) benefit of every placed object, cached so a replan that
    # reuses this decision can also reuse its predicted-time term without
    # re-batching benefits (values are bitwise-reproducible from the same
    # profile version, so the cache never changes the plan).
    benefits: Optional[Dict[str, float]] = dataclasses.field(
        default=None, compare=False)
    # Resolved benefit class ("bw" | "lat") of every placed object whose
    # benefit is non-zero — the calibration decomposition's attribution
    # key, cached for the same reason as ``benefits`` (classes are a pure
    # function of the same profile version).  ``None`` on decisions from
    # pre-cache serialized plans; the decomposition falls back to the
    # scalar classifier for those.
    classes: Optional[Dict[str, str]] = dataclasses.field(
        default=None, compare=False)
    reused: bool = dataclasses.field(default=False, compare=False)


@dataclasses.dataclass
class PlacementPlan:
    strategy: str                            # "local" | "global" | "none"
    residents: List[Set[str]]                # per phase: fast-tier residents
    moves: List[MoveOp]
    predicted_iteration_time: float
    baseline_iteration_time: float
    # Timing-annotated schedule (one entry per MoveOp), emitted by the
    # planner when it has a profiled graph; movers that don't need timing
    # (the FIFO baseline) simply ignore it.
    schedule: List[ScheduledMove] = dataclasses.field(default_factory=list)
    # Per-phase solve records from the local search (empty for global
    # plans): the standing state a scoped replan re-solves against.
    phase_decisions: List[PhaseDecision] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    # Per-phase benefit contributions from the global search (empty for
    # local plans): the scoped replan's cache for the global totals.
    global_contribs: List["GlobalContrib"] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    # (times, per-phase positive-ref key tuples) of the graph this plan was
    # built against.  When a replan's digest matches, every trigger point
    # and overlap window is provably unchanged, so phase reuse needs no
    # per-candidate window computation at all (the scoped fast path).
    graph_digest: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    # Per-phase prediction decomposition for the calibration feedback: the
    # profiled baseline phase times and the booked slow->fast gain per
    # phase split by benefit class ("bw" = Eq. 2, "lat" = Eq. 3).  One
    # measured iteration then yields one realized-gain equation per phase,
    # which is what makes the per-class correction factors identifiable
    # (a whole-iteration scalar cannot separate the classes).
    phase_baseline: List[float] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    phase_gain_bw: List[float] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    phase_gain_lat: List[float] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    # How the global search resolved this build: "solved" (fresh solve),
    # "reused" (whole-decision memo hit — zero drift), or "pruned" (the
    # dominance bound proved local wins and the solve was skipped; the
    # plan's predicted time is then a certified *lower bound*).  The
    # chooser copies these onto whichever plan it returns, so callers see
    # the global search's reuse behaviour regardless of the winner.
    global_mode: str = dataclasses.field(
        default="solved", repr=False, compare=False)
    global_rows_reused: int = dataclasses.field(
        default=0, repr=False, compare=False)

    def moves_for_phase(self, phase_index: int, n_phases: int) -> List[MoveOp]:
        """Moves triggered at the start of ``phase_index`` (wrapping)."""
        return [m for m in self.moves
                if m.trigger_phase % n_phases == phase_index % n_phases]

    def fences_for_phase(self, phase_index: int) -> List[MoveOp]:
        return [m for m in self.moves if m.needed_by == phase_index]

    def scheduled_for_phase(self, phase_index: int,
                            n_phases: int) -> List["ScheduledMove"]:
        """Schedule entries released at the start of ``phase_index``, most
        urgent first."""
        out = [s for s in self.schedule
               if s.op.trigger_phase % n_phases == phase_index % n_phases]
        return sorted(out, key=lambda s: s.urgency)

    @property
    def total_moved_bytes(self) -> int:
        return sum(m.size_bytes for m in self.moves)


def emit_schedule(moves: Sequence[MoveOp], graph, copy_bw: float
                  ) -> List[ScheduledMove]:
    """Annotate each move with its copy window, duration and slack."""
    out: List[ScheduledMove] = []
    for m in moves:
        window = graph.window_between(m.trigger_phase, m.needed_by)
        duration = m.size_bytes / copy_bw
        out.append(ScheduledMove(m, window, duration, window - duration))
    return out


# ---------------------------------------------------------------------------
# amortized per-generation registry tables
# ---------------------------------------------------------------------------
class _GenCache:
    """Registry lookup tables computed once per ``registry.generation``:
    sizes, pinned flags and parents per name, plus lazily-built chunk
    spans per parent (the partition attribution order every consumer of
    ``chunk_spans`` must agree on).  Names/sizes/parents/pins are
    immutable per name, so generation (plus a length check for
    registration without a bump) is the exact invalidation key; tiers are
    mutable and deliberately *not* cached here."""

    __slots__ = ("generation", "count", "sizes", "pinned", "parent_of",
                 "_spans", "_span_idx", "_span_total", "_span_sizes")

    def __init__(self, registry: ObjectRegistry):
        self.generation = registry.generation
        sizes: Dict[str, int] = {}
        pinned: Set[str] = set()
        parent_of: Dict[str, str] = {}
        for o in registry:
            sizes[o.name] = o.size_bytes
            if o.pinned:
                pinned.add(o.name)
            if o.parent is not None:
                parent_of[o.name] = o.parent
        self.count = len(sizes)
        self.sizes = sizes
        self.pinned = pinned
        self.parent_of = parent_of
        self._spans: Dict[str, List[Tuple[str, int, int]]] = {}
        self._span_idx: Dict[str, Dict[str, int]] = {}
        self._span_total: Dict[str, int] = {}
        self._span_sizes: Dict[str, np.ndarray] = {}

    def spans(self, registry: ObjectRegistry, parent: str
              ) -> List[Tuple[str, int, int]]:
        s = self._spans.get(parent)
        if s is None:
            s = self._spans[parent] = [
                (c.name, lo, hi) for c, lo, hi in chunk_spans(registry, parent)]
            self._span_total[parent] = sum(hi - lo for _, lo, hi in s) or 1
        return s

    def span_total(self, registry: ObjectRegistry, parent: str) -> int:
        self.spans(registry, parent)
        return self._span_total[parent]

    def span_idx(self, registry: ObjectRegistry, parent: str
                 ) -> Dict[str, int]:
        d = self._span_idx.get(parent)
        if d is None:
            d = self._span_idx[parent] = {
                name: i for i, (name, _, _) in
                enumerate(self.spans(registry, parent))}
        return d

    def span_sizes(self, registry: ObjectRegistry, parent: str) -> np.ndarray:
        a = self._span_sizes.get(parent)
        if a is None:
            a = self._span_sizes[parent] = np.array(
                [hi - lo for _, lo, hi in self.spans(registry, parent)],
                dtype=np.int64)
        return a


_MISSING = object()


# ---------------------------------------------------------------------------
class _ProfileView:
    """Batched profile/benefit lookups for one (planner, profiler) pair,
    held across ticks.

    Replaces the per-candidate scalar path (a registry scan per chunk lookup
    plus a scalar Eq. (1)-(3) evaluation per candidate) with one numpy
    evaluation per (phase, parent) block.  Chunk attribution fractions —
    measured-histogram mass over the chunk's byte span, size fraction when
    no histogram exists — are computed once per (phase, parent).  Values
    agree bitwise with the scalar path.

    Everything cached here is a pure function of (profiler state at that
    phase's version, registry generation, calibration constants):
    :meth:`refresh` evicts exactly the phases whose profile version moved,
    and the planner rebuilds the view outright on generation / profiler /
    calibration changes — so cross-tick reuse can never change a plan."""

    def __init__(self, planner: "Planner", profiler: PhaseProfiler):
        self.planner = planner
        self.profiler = profiler
        self.generation = planner.registry.generation
        self.cf = planner.cf
        # phase -> profile version the caches below were filled under
        self._versions: Dict[int, tuple] = {}
        # phase -> profiles_for_phase() snapshot
        self._direct: Dict[int, Dict] = {}
        # phase -> {parent: attribution-fraction array aligned with spans}
        self._fracs: Dict[int, Dict[str, np.ndarray]] = {}
        # phase -> {parent: (benefit array, class array) | None}
        self._blocks: Dict[int, Dict[str, Optional[tuple]]] = {}
        # phase -> {obj: benefit or None (no profile)}
        self._benefit: Dict[int, Dict[str, Optional[float]]] = {}
        # phase -> {obj: resolved benefit class "bw" | "lat"}
        self._class: Dict[int, Dict[str, str]] = {}
        # scalar-path fallbacks for objects outside ensure()'s candidate
        # sets (e.g. residents carried over from earlier phases)
        self._fallback: Dict[int, Dict[str, float]] = {}
        self._fallback_class: Dict[int, Dict[str, str]] = {}

    _CACHES = ("_versions", "_direct", "_fracs", "_blocks", "_benefit",
               "_class", "_fallback", "_fallback_class")

    def refresh(self) -> None:
        """Evict every phase whose profile version drifted since its
        caches were filled (called once per plan build)."""
        stale = [ph for ph, ver in self._versions.items()
                 if self.profiler.phase_version(ph) != ver]
        for ph in stale:
            for name in self._CACHES:
                getattr(self, name).pop(ph, None)

    def _touch(self, phase: int) -> None:
        if phase not in self._versions:
            self._versions[phase] = self.profiler.phase_version(phase)

    def direct(self, phase: int) -> Dict:
        """The phase's direct profiles (name -> AccessProfile snapshot)."""
        d = self._direct.get(phase)
        if d is None:
            self._touch(phase)
            d = self._direct[phase] = self.profiler.profiles_for_phase(phase)
        return d

    def _frac_arr(self, phase: int, parent: str) -> np.ndarray:
        per = self._fracs.setdefault(phase, {})
        arr = per.get(parent)
        if arr is None:
            planner = self.planner
            gen = planner._gen()
            spans = gen.spans(planner.registry, parent)
            total = gen.span_total(planner.registry, parent)
            pp = self.direct(phase).get(parent)
            bins = pp.bin_weights if pp is not None else None
            if bins is None:
                arr = gen.span_sizes(planner.registry, parent) / total
            else:
                arr = np.array(
                    [bin_mass(bins, lo / total, hi / total)
                     for _, lo, hi in spans], dtype=np.float64)
            per[parent] = arr
        return arr

    def _pblock(self, phase: int, parent: str) -> Optional[tuple]:
        """(benefit, class) arrays for every chunk of ``parent`` in span
        order, or None when the parent has no profile at this phase.  One
        ``benefit_batch`` per (phase, parent) — elementwise identical to
        the scalar per-chunk path."""
        per = self._blocks.setdefault(phase, {})
        blk = per.get(parent, _MISSING)
        if blk is not _MISSING:
            return blk
        self._touch(phase)
        pp = self.direct(phase).get(parent)
        if pp is None:
            per[parent] = None
            return None
        frac = self._frac_arr(phase, parent)
        planner = self.planner
        vals, cls = perfmodel.benefit_batch(
            pp.data_access * frac, pp.n_samples,
            np.maximum(pp.samples_with_access * frac, 1.0),
            pp.phase_time, pp.cacheline_bytes,
            planner.machine, planner.cf, return_class=True)
        blk = (vals, cls)
        per[parent] = blk
        return blk

    def ensure(self, phase: int, objs: Sequence[str]) -> None:
        """Batch-compute benefits for every not-yet-cached object."""
        self._touch(phase)
        cache = self._benefit.setdefault(phase, {})
        ccache = self._class.setdefault(phase, {})
        planner = self.planner
        gen = planner._gen()
        direct = self.direct(phase)
        d_names: List[str] = []
        d_prof: List = []
        for o in objs:
            if o in cache:
                continue
            p = direct.get(o)
            if p is not None:
                d_names.append(o)
                d_prof.append(p)
                continue
            par = gen.parent_of.get(o)
            pp = direct.get(par) if par is not None else None
            if pp is None:
                cache[o] = None
                continue
            blk = self._pblock(phase, par)
            idx = gen.span_idx(planner.registry, par)[o]
            cache[o] = float(blk[0][idx])
            ccache[o] = "lat" if blk[1][idx] else "bw"
        if not d_prof:
            return
        cols = np.array(
            [(p.data_access, p.n_samples, p.samples_with_access,
              p.phase_time, p.cacheline_bytes) for p in d_prof],
            dtype=np.float64)
        bft, cls = perfmodel.benefit_batch(
            cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3], cols[:, 4],
            planner.machine, planner.cf, return_class=True)
        for name, b, c in zip(d_names, bft, cls):
            cache[name] = float(b)
            ccache[name] = "lat" if c else "bw"

    def has_profile(self, phase: int, obj: str) -> bool:
        return self._benefit.get(phase, {}).get(obj) is not None

    def benefit(self, phase: int, obj: str) -> float:
        b = self._benefit.get(phase, {}).get(obj)
        if b is not None:
            return b
        # outside ensure()'s candidate sets (residents carried over from
        # earlier phases): the exact scalar path, memoized — its registry
        # scan must not run once per (phase, resident)
        self._touch(phase)
        per = self._fallback.setdefault(phase, {})
        val = per.get(obj)
        if val is None:
            val = self.planner._benefit_scalar(self.profiler, phase, obj)
            per[obj] = val
        return val

    def gain_class(self, phase: int, obj: str) -> str:
        """Resolved benefit class of ``(phase, obj)`` — batch-cached when
        :meth:`ensure` computed the benefit, scalar-memoized otherwise
        (the same fallback population as :meth:`benefit`)."""
        c = self._class.get(phase, {}).get(obj)
        if c is not None:
            return c
        self._touch(phase)
        per = self._fallback_class.setdefault(phase, {})
        c = per.get(obj)
        if c is None:
            c = self.planner._gain_class_scalar(self.profiler, phase, obj)
            per[obj] = c
        return c


class _WindowIndex:
    """O(log n) dependency-safe trigger points for one plan build.

    ``graph.trigger_point`` walks backwards through the phase list per
    (object, phase) query — O(n) dictionary probes each, and the planner
    issues one query per candidate.  This index inverts the graph once
    (object -> sorted referencing phases) and answers each query with a
    bisect, returning *bitwise-identical* trigger indices; the overlap
    window itself is still summed by ``graph.window_between`` so plan
    float values are unchanged."""

    def __init__(self, graph: PhaseGraph):
        self.graph = graph
        self.n = len(graph)
        by: Dict[str, List[int]] = {}
        for p in graph:
            for o, v in p.refs.items():
                if v > 0.0:
                    by.setdefault(o, []).append(p.index)  # ascending
        self._by = by

    def trigger(self, obj: str, phase_index: int) -> int:
        n = self.n
        refs = self._by.get(obj)
        if refs:
            i = bisect.bisect_left(refs, phase_index)
            if i > 0:                       # nearest referencing phase < p
                return refs[i - 1] + 1
            if refs[-1] > phase_index:      # wrap into the previous iter
                return refs[-1] - n + 1
        return phase_index - (n - 1)

    def pair(self, obj: str, phase_index: int) -> Tuple[int, float]:
        t = self.trigger(obj, phase_index)
        return (t, self.graph.window_between(t, phase_index))


class _TriggerIndex:
    """:class:`_WindowIndex` held across ticks, keyed on the graph digest.

    Same bitwise-identical trigger/window answers, plus two memo layers
    the serving tick needs: equal referencing-phase tuples are interned so
    all chunks of one parent (identical reference patterns) share a single
    trigger memo entry, and ``window_between`` sums are memoized per
    (trigger, phase) — the digest pins every measured time and positive
    reference set these derive from, so reuse cannot change a value."""

    def __init__(self, graph: PhaseGraph):
        self.graph = graph
        self.n = len(graph)
        by: Dict[str, List[int]] = {}
        for p in graph:
            for o, v in p.refs.items():
                if v > 0.0:
                    by.setdefault(o, []).append(p.index)  # ascending
        canon: Dict[tuple, tuple] = {}
        self._refs: Dict[str, tuple] = {
            o: canon.setdefault(t, t)
            for o, t in ((o, tuple(l)) for o, l in by.items())}
        self._tmemo: Dict[Tuple[int, int], int] = {}
        self._wmemo: Dict[Tuple[int, int], float] = {}

    def _trig(self, refs: Optional[tuple], phase_index: int) -> int:
        if refs:
            key = (id(refs), phase_index)
            t = self._tmemo.get(key)
            if t is None:
                i = bisect.bisect_left(refs, phase_index)
                if i > 0:
                    t = refs[i - 1] + 1
                elif refs[-1] > phase_index:
                    t = refs[-1] - self.n + 1
                else:
                    t = phase_index - (self.n - 1)
                self._tmemo[key] = t
            return t
        return phase_index - (self.n - 1)

    def trigger(self, obj: str, phase_index: int) -> int:
        return self._trig(self._refs.get(obj), phase_index)

    def window(self, trigger: int, phase_index: int) -> float:
        key = (trigger, phase_index)
        w = self._wmemo.get(key)
        if w is None:
            w = self._wmemo[key] = self.graph.window_between(
                trigger, phase_index)
        return w

    def pair(self, obj: str, phase_index: int) -> Tuple[int, float]:
        t = self.trigger(obj, phase_index)
        return (t, self.window(t, phase_index))


@dataclasses.dataclass(eq=False)
class GlobalContrib:
    """One phase's per-object benefit contributions to the cross-phase
    global search, with the profile version / registry generation they
    were computed against — the scoped replan's reuse key for the global
    totals.  ``row`` is aligned with ``objs``; full and scoped builds sum
    the same per-phase rows the same way, so reuse keeps the totals
    bitwise identical to a full recompute.  ``cls_row`` (0 = "bw",
    1 = "lat", aligned with ``row``) caches the resolved benefit classes
    for the calibration decomposition; optional — ``None`` on rows from
    scalar-mode builds or pre-cache serialized plans, for which the
    decomposition falls back to the scalar classifier."""

    phase_index: int
    version: Tuple[int, int]
    generation: int
    objs: Tuple[str, ...]
    row: np.ndarray
    cls_row: Optional[np.ndarray] = None


def graph_digest(graph: PhaseGraph) -> tuple:
    """(measured times, per-phase positively-referenced object tuples) —
    everything trigger points and overlap windows are derived from."""
    return (tuple(p.time for p in graph),
            tuple(tuple(o for o, v in p.refs.items() if v > 0.0)
                  for p in graph))


def _fp_hash(names_blob: bytes, mask_bytes: bytes,
             trig: np.ndarray, win: np.ndarray) -> str:
    """Constant-size digest of a phase's per-candidate fingerprint stream:
    candidate names (solve order), the resident/non-resident split, and
    the non-resident trigger points and overlap windows.  Collapsing the
    O(candidates) tuple the fingerprint used to carry into 16 bytes keeps
    decision records O(1) at 100k chunks; both the scalar and the array
    path hash the identical byte stream, so fingerprints stay comparable
    across modes."""
    h = hashlib.blake2b(digest_size=16)
    h.update(names_blob)
    h.update(b"\x00\x01")
    h.update(mask_bytes)
    h.update(b"\x00\x02")
    h.update(np.ascontiguousarray(trig, dtype=np.int64).tobytes())
    h.update(b"\x00\x03")
    h.update(np.ascontiguousarray(win, dtype=np.float64).tobytes())
    return h.hexdigest()


class _Evictables:
    """Prefix-summed evictable residents for one phase's candidate loop:
    answers "how many bytes must leave to fit ``deficit``" in O(log n)
    instead of a fresh sort + scan per candidate."""

    def __init__(self, sizes: List[int]):
        # ``sizes`` already in the canonical (size, name) eviction order
        self._cum: List[int] = []
        acc = 0
        for s in sizes:
            acc += s
            self._cum.append(acc)

    def quote(self, deficit: int) -> Optional[int]:
        """Bytes freed by evicting the minimal prefix covering ``deficit``,
        or None when even evicting everything is not enough."""
        i = bisect.bisect_left(self._cum, deficit)
        if i >= len(self._cum):
            return None
        return self._cum[i]


@dataclasses.dataclass(eq=False)
class _PhaseLayout:
    """One phase's candidate extraction, cached across ticks.

    Everything here is a pure function of (the phase's reference keys,
    the registry generation, which of the phase's parents have profiles)
    — candidate names in solve order, their sizes, the scatter positions
    of each profiled parent's chunks, and (keyed separately on the graph
    digest) the per-candidate trigger points and overlap windows.  An
    intensity-only drift changes none of these, so a scoped re-solve of
    the drifted phase skips straight to benefit scatter + pricing."""

    names_key: tuple                 # digest names tuple validity handle
    n_refs: int
    generation: int
    direct_keys: frozenset
    cands: List[str]
    cand_pos: Dict[str, int]
    sizes: np.ndarray                # int64, aligned with cands
    szf: np.ndarray                  # float64 copy for pricing
    parent_groups: List[Tuple[str, np.ndarray, np.ndarray]]
    direct_cands: List[Tuple[int, str]]
    names_blob: bytes
    digest: Optional[tuple] = None   # digest trig/win were computed under
    trig: Optional[np.ndarray] = None
    win: Optional[np.ndarray] = None


@dataclasses.dataclass(eq=False)
class _GlobalLayout:
    """The cross-phase candidate universe, cached per (digest, generation):
    first-reference order over the graph's objects, sizes, scatter
    positions per profiled parent, and each object's first referencing
    phase (the move fence)."""

    digest: tuple
    generation: int
    objs: List[str]
    objs_t: Tuple[str, ...]
    pos: Dict[str, int]
    sizes: np.ndarray                # int64, aligned with objs
    first_ref: Dict[str, int]
    parent_groups: List[Tuple[str, np.ndarray, np.ndarray]]


def _fractional_ub(values: np.ndarray, sizes: np.ndarray,
                   capacity: int) -> float:
    """LP-relaxation upper bound on the 0/1 knapsack optimum: greedy by
    value density with a fractional last item.  Quantization in the exact
    solver only rounds sizes *up* (shrinking the feasible set), so this
    also bounds the quantized optimum — which makes ``baseline - ub`` a
    certified lower bound on the global plan's predicted time."""
    pos = values > 0.0
    v = values[pos]
    if not len(v) or capacity <= 0:
        return 0.0
    s = sizes[pos].astype(np.float64)
    order = np.argsort(-(v / np.maximum(s, 1.0)))
    v = v[order]
    s = s[order]
    cum = np.cumsum(s)
    k = int(np.searchsorted(cum, float(capacity), side="left"))
    ub = float(v[:k].sum())
    if k < len(v):
        prev = float(cum[k - 1]) if k else 0.0
        ub += float(v[k]) * ((capacity - prev) / s[k])
    return ub


class Planner:
    def __init__(self, machine: MachineProfile, registry: ObjectRegistry,
                 cf: Optional[CalibrationConstants] = None,
                 fast_capacity_bytes: Optional[int] = None,
                 vectorized: bool = True,
                 enact_consistent: bool = False):
        self.machine = machine
        self.registry = registry
        self.cf = cf or CalibrationConstants()
        self.capacity = (fast_capacity_bytes if fast_capacity_bytes is not None
                         else machine.fast.capacity_bytes)
        self.vectorized = vectorized
        # Enactment-consistent drop order for the local solve (multi-res
        # mode): when the knapsack declines a referenced resident that
        # enactment can never actually evict, the selection over-commits
        # the budget and the last-enacted chosen objects are dropped.
        # Legacy enacts size-descending — the smallest chosen go last,
        # which under multi-resolution refinement are exactly the fine
        # hot-head chunks — so this flag switches enactment to
        # benefit-density order (shortfall lands on the coldest chosen
        # bytes).  Off by default: legacy plans stay bit-identical.
        self.enact_consistent = enact_consistent
        # cross-tick caches (all invalidated by the exact inputs they
        # derive from; see the class docstrings)
        self._gen_cache: Optional[_GenCache] = None
        self._view: Optional[_ProfileView] = None
        self._digest_state: Optional[tuple] = None
        self._win_state: Optional[Tuple[tuple, _TriggerIndex]] = None
        self._phase_layouts: Dict[int, _PhaseLayout] = {}
        self._global_layout: Optional[_GlobalLayout] = None
        self._global_memo: Optional[Dict] = None
        self._tier_snapshot: Optional[Set[str]] = None

    # ------------------------------------------------------------ move pricing
    def price_fetch(self, size_bytes: int, overlap_window: float) -> float:
        """Eq. (4) unhidden cost of one slow->fast copy given its overlap
        window — the single pricing authority for *both* searches, so the
        best-of-two chooser always compares cost-inclusive numbers priced
        the same way (a cost-free global estimate against a cost-inclusive
        local one is how the original chooser bug crept in)."""
        cost = perfmodel.movement_cost(size_bytes, self.machine,
                                       overlap_window)
        if self.enact_consistent:
            # churn guard (see _solve_phase): an overlappable copy still
            # spends real copy bandwidth and serves slow until it lands
            cost = max(cost, size_bytes / self.machine.copy_bw)
        return cost * self.cf.cf_move

    def price_eviction(self, size_bytes: int) -> float:
        """Space-clearing demotion: the outgoing copy serializes with the
        incoming one, so its full copy time lands on the critical path.
        Scaled — like :meth:`price_fetch` — by the online-calibrated
        movement-price factor (``cf_move`` is 1.0 until the calibration
        feedback folds a measured stall ratio into it)."""
        return size_bytes / self.machine.copy_bw * self.cf.cf_move

    # ------------------------------------------------------------------ util
    def _gen(self) -> _GenCache:
        c = self._gen_cache
        if (c is None or c.generation != self.registry.generation
                or c.count != len(self.registry)):
            c = self._gen_cache = _GenCache(self.registry)
        return c

    def _profile(self, profiler: PhaseProfiler, phase: int, obj: str):
        p = profiler.profile(phase, obj)
        if p is not None:
            return p
        # Chunk of a partitioned object: scale the parent's profile by the
        # chunk's share of the parent's accesses — measured-histogram mass
        # over the chunk's byte span when per-chunk attribution exists, size
        # fraction otherwise (regular 1-D references, paper §3.2).
        gen = self._gen()
        par = gen.parent_of.get(obj)
        if par is not None:
            pp = profiler.profile(phase, par)
            if pp is not None:
                size = gen.sizes[obj]
                bins = pp.bin_weights
                if self.vectorized:
                    total = gen.span_total(self.registry, par)
                    if bins is None:
                        frac = size / total
                    else:
                        spans = gen.spans(self.registry, par)
                        lo = spans[gen.span_idx(self.registry, par)[obj]][1]
                        frac = bin_mass(bins, lo / total,
                                        (lo + size) / total)
                else:
                    # Frozen pre-optimization reference (like
                    # knapsack.solve_reference): spans are recomputed per
                    # candidate, never amortized — the planner-latency
                    # benchmark's baseline must not inherit the caches it
                    # is measured against.  Same float expressions, so the
                    # oracle plans stay bit-identical.
                    spans = chunk_spans(self.registry, par)
                    total = sum(hi - lo for _, lo, hi in spans) or 1
                    if bins is None:
                        frac = size / total
                    else:
                        lo = next(l for c, l, _ in spans if c.name == obj)
                        frac = bin_mass(bins, lo / total,
                                        (lo + size) / total)
                return dataclasses.replace(
                    pp, obj=obj, data_access=pp.data_access * frac,
                    samples_with_access=max(pp.samples_with_access * frac, 1.0))
        return None

    def _benefit_scalar(self, profiler: PhaseProfiler, phase: int,
                        obj: str) -> float:
        p = self._profile(profiler, phase, obj)
        if p is None:
            return 0.0
        return perfmodel.benefit(p, self.machine, self.cf)

    def _gain_class_scalar(self, profiler: PhaseProfiler, phase: int,
                           obj: str) -> str:
        """Benefit class ("bw" | "lat") a (phase, obj) gain is booked
        under — the calibration feedback's attribution key."""
        p = self._profile(profiler, phase, obj)
        if p is None:
            return "bw"
        return perfmodel.gain_class(p, self.machine, self.cf)

    # kept as the public scalar entry point (tests, legacy mode)
    _benefit = _benefit_scalar

    def _initial_residents(self) -> Set[str]:
        return {o.name for o in self.registry if o.tier == "fast"}

    def _fast_tier(self) -> Set[str]:
        """Current fast-tier names — one registry pass per plan build;
        doubles as the default entry residency and as the complement used
        for "originally slow" membership (every queried name is a registry
        member, so ``o not in fast`` is exactly the legacy
        ``tier != "fast"`` set test).  :meth:`plan` shares one snapshot
        between its two searches (tiers cannot move while planning), so
        the best-of-two pays for a single scan."""
        snap = self._tier_snapshot
        if snap is not None:
            return snap
        return {o.name for o in self.registry if o.tier == "fast"}

    def _entry_residents(self, fast_tier: Set[str]) -> Set[str]:
        """Entry residency, honouring per-instance ``_initial_residents``
        overrides (the bandwidth-partition clamp installs one)."""
        f = self.__dict__.get("_initial_residents")
        if f is not None:
            return set(f())
        if type(self)._initial_residents is not Planner._initial_residents:
            return set(self._initial_residents())
        return set(fast_tier)

    def _solve(self, items, capacity):
        if self.vectorized:
            return knapsack.solve(items, capacity)
        return knapsack.solve_reference(items, capacity)

    def _get_view(self, profiler: PhaseProfiler) -> Optional[_ProfileView]:
        if not self.vectorized:
            return None
        v = self._view
        if (v is None or v.profiler is not profiler
                or v.generation != self.registry.generation
                or v.cf is not self.cf):
            v = self._view = _ProfileView(self, profiler)
        else:
            v.refresh()
        return v

    def _make_view(self, profiler: PhaseProfiler) -> Optional[_ProfileView]:
        return self._get_view(profiler)

    def _graph_digest(self, graph: PhaseGraph,
                      profiler: PhaseProfiler) -> tuple:
        """:func:`graph_digest`, with the per-phase positive-name tuples
        cached by (profile version, registry generation) — the pipeline's
        attribute/partition stages derive each phase's refs from exactly
        those inputs, so an unchanged version pins an unchanged tuple.
        Phases the profiler has never observed (version counters still
        zero — hand-built graphs in tests) are never cached."""
        st = self._digest_state
        if st is None or st[0] is not graph or st[1] is not profiler:
            st = self._digest_state = (graph, profiler, {})
        cache = st[2]
        generation = self.registry.generation
        names: List[tuple] = []
        for p in graph:
            ver = profiler.phase_version(p.index)
            ent = cache.get(p.index)
            if (ent is not None and ent[0] == ver and ent[1] == generation
                    and ver[1:] != (0, 0)):
                names.append(ent[2])
            else:
                t = tuple(o for o, v in p.refs.items() if v > 0.0)
                cache[p.index] = (ver, generation, t)
                names.append(t)
        return (tuple(p.time for p in graph), tuple(names))

    def _windex(self, graph: PhaseGraph, digest: tuple) -> _TriggerIndex:
        ws = self._win_state
        if ws is not None and ws[0] == digest:
            return ws[1]
        w = _TriggerIndex(graph)
        self._win_state = (digest, w)
        return w

    # ----------------------------------------------------------- local search
    def _phase_candidates(self, profiler: PhaseProfiler, ph
                          ) -> Tuple[List[str], List[str]]:
        """Registry-present references and knapsack candidates of a phase,
        *without* computing any benefits (a reused phase never pays for
        them).  Matches the view/scalar profile-existence conditions: a
        candidate has a direct profile or a profiled parent."""
        in_reg = [o for o in ph.refs if o in self.registry]
        cands: List[str] = []
        for o in in_reg:
            dob = self.registry[o]
            if dob.pinned:
                continue
            if profiler.profile(ph.index, o) is not None:
                cands.append(o)
            elif (dob.parent is not None
                  and profiler.profile(ph.index, dob.parent) is not None):
                cands.append(o)
        return in_reg, cands

    def _phase_fingerprint(self, profiler: PhaseProfiler, ph,
                           cands: Sequence[str],
                           windows: Dict[str, Tuple[int, float]]) -> tuple:
        """Everything the phase's solve reads besides the entry residency,
        compressed to an exact reuse key ``(profile version, registry
        generation, blake2b over the candidate stream)``:

        * ``profiler.phase_version`` — identifies the phase's accumulated
          profile state, which determines its refs (the attribute stage
          derives them from profiles), its candidates and their benefits;
        * ``registry.generation`` — identifies the chunk registry shape
          (sizes, parents, pinned flags are immutable per name);
        * the hashed stream — candidate names in solve order, the
          resident/non-resident split, and per-candidate trigger points
          and overlap windows (the coupling to *other* phases' measured
          times and reference sets).  Windows are recorded only for the
          candidates the solve actually reads them for (the non-resident
          ones: ``windows`` omits residents) — a reuse check only
          compares fingerprints after the entry residency matched, so the
          resident split is identical on both sides.

        Precondition (the pipeline's attribute/partition stages): the
        graph's refs/times are derived from the profiler state, never
        hand-mutated between builds."""
        names_blob = "\x00".join(cands).encode("utf-8")
        mask = bytes(bytearray(0 if o in windows else 1 for o in cands))
        nr = [o for o in cands if o in windows]
        trig = np.array([windows[o][0] for o in nr], dtype=np.int64)
        win = np.array([windows[o][1] for o in nr], dtype=np.float64)
        return (profiler.phase_version(ph.index), self.registry.generation,
                _fp_hash(names_blob, mask, trig, win))

    def _phase_layout(self, graph: PhaseGraph, ph, gen: _GenCache,
                      view: _ProfileView, digest: tuple,
                      names_key: tuple) -> _PhaseLayout:
        """Cached candidate extraction for one phase (see
        :class:`_PhaseLayout`); rebuilds only when the phase's reference
        keys, the registry generation or the set of profiled parents
        changed, and refreshes the trigger/window arrays only when the
        graph digest moved."""
        direct = view.direct(ph.index)
        dkeys = frozenset(direct)
        lay = self._phase_layouts.get(ph.index)
        if (lay is None or lay.generation != gen.generation
                or lay.n_refs != len(ph.refs)
                or lay.names_key != names_key
                or lay.direct_keys != dkeys):
            reg = self.registry
            sizes_d = gen.sizes
            pinned = gen.pinned
            parent_of = gen.parent_of
            cands: List[str] = []
            cand_pos: Dict[str, int] = {}
            sizes: List[int] = []
            pgroups: Dict[str, Tuple[List[int], List[int]]] = {}
            direct_cands: List[Tuple[int, str]] = []
            for o in ph.refs:
                sz = sizes_d.get(o)
                if sz is None or o in pinned:
                    continue
                if o in direct:
                    par = None
                else:
                    par = parent_of.get(o)
                    if par is None or par not in direct:
                        continue
                i = len(cands)
                if par is None:
                    direct_cands.append((i, o))
                else:
                    g = pgroups.get(par)
                    if g is None:
                        g = pgroups[par] = ([], [])
                    g[0].append(i)
                    g[1].append(gen.span_idx(reg, par)[o])
                cand_pos[o] = i
                cands.append(o)
                sizes.append(sz)
            sz_arr = np.asarray(sizes, dtype=np.int64)
            lay = _PhaseLayout(
                names_key=names_key, n_refs=len(ph.refs),
                generation=gen.generation, direct_keys=dkeys,
                cands=cands, cand_pos=cand_pos, sizes=sz_arr,
                szf=sz_arr.astype(np.float64),
                parent_groups=[(par, np.asarray(ix, dtype=np.int64),
                                np.asarray(si, dtype=np.int64))
                               for par, (ix, si) in pgroups.items()],
                direct_cands=direct_cands,
                names_blob="\x00".join(cands).encode("utf-8"))
            self._phase_layouts[ph.index] = lay
        if lay.digest != digest:
            windex = self._windex(graph, digest)
            refs_of = windex._refs
            trigs: List[int] = []
            last = _MISSING
            last_t = 0
            for o in lay.cands:
                r = refs_of.get(o)
                if r is last and r is not None:
                    t = last_t
                else:
                    t = windex._trig(r, ph.index)
                    last, last_t = r, t
                trigs.append(t)
            wmemo: Dict[int, float] = {}
            wins: List[float] = []
            for t in trigs:
                w = wmemo.get(t)
                if w is None:
                    w = wmemo[t] = windex.window(t, ph.index)
                wins.append(w)
            lay.trig = np.asarray(trigs, dtype=np.int64)
            lay.win = np.asarray(wins, dtype=np.float64)
            lay.digest = digest
        return lay

    def _layout_benefits(self, view: _ProfileView, phase: int,
                         lay: _PhaseLayout) -> np.ndarray:
        """Eq. (1)-(3) benefit of every layout candidate, scattered from
        the view's per-parent blocks (one ``benefit_batch`` per profiled
        parent) plus one batch over the direct-profile candidates —
        elementwise identical to the per-candidate scalar path."""
        bft = np.zeros(len(lay.cands), dtype=np.float64)
        direct = view.direct(phase)
        for par, positions, span_idx in lay.parent_groups:
            blk = view._pblock(phase, par)
            if blk is not None:
                bft[positions] = blk[0][span_idx]
        if lay.direct_cands:
            dpos = [i for i, _ in lay.direct_cands]
            profs = [direct[o] for _, o in lay.direct_cands]
            cols = np.array(
                [(p.data_access, p.n_samples, p.samples_with_access,
                  p.phase_time, p.cacheline_bytes) for p in profs],
                dtype=np.float64)
            bft[dpos] = perfmodel.benefit_batch(
                cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3], cols[:, 4],
                self.machine, self.cf)
        return bft

    def _entry_shed(self, graph: PhaseGraph, residents: Set[str],
                    resident_bytes: int
                    ) -> Tuple[Set[str], int, List[MoveOp]]:
        """Entry-residency reconciliation: when the entry residency
        overshoots the fast-tier budget (a mid-rotation rebuild after the
        capacity shrank, or partially-enacted moves), shed the
        lowest-traffic unpinned residents at phase 0 until the plan starts
        within budget — the aggregate-path mirror of the
        bandwidth-partition entry clamp, priced through the same
        Eq. (4) eviction authority as every other demotion.  Deterministic
        (traffic then name), so scoped and full replans shed
        identically."""
        over = resident_bytes - self.capacity
        if over <= 0:
            return residents, resident_bytes, []
        gen = self._gen()
        traffic: Dict[str, float] = {}
        for o in residents:
            t = 0.0
            for p in graph:
                t += p.refs.get(o, 0.0)
            traffic[o] = t
        moves: List[MoveOp] = []
        for o in sorted(residents, key=lambda o: (traffic[o], o)):
            if resident_bytes <= self.capacity:
                break
            if o in gen.pinned:
                continue
            size = gen.sizes[o]
            residents.discard(o)
            resident_bytes -= size
            moves.append(MoveOp(o, "slow", 0, 0, size,
                                self.price_eviction(size)))
        return residents, resident_bytes, moves

    def _solve_phase(self, ph, cands, bft_of, windows,
                     entry_residents: Set[str], entry_bytes: int):
        """One phase's knapsack + enactment against the entry residency
        (the scalar oracle path).  Returns (exit_residents, exit_bytes,
        moves)."""
        size = lambda o: self.registry[o].size_bytes
        residents = set(entry_residents)
        resident_bytes = entry_bytes
        free = self.capacity - resident_bytes
        # deterministic tie-break by name: hash-order of the residents
        # set must never leak into the plan
        evict_order = sorted(
            (r for r in residents
             if r not in ph.refs and not self.registry[r].pinned),
            key=lambda r: (size(r), r))
        evictables = _Evictables([size(r) for r in evict_order])
        items: List[knapsack.Item] = []
        meta: Dict[str, Dict] = {}
        for o in cands:
            bft = bft_of(o)
            if o in residents:
                # already resident: keeping it costs nothing
                items.append(knapsack.Item(o, bft, size(o)))
                meta[o] = dict(cost=0.0, extra=0.0, resident=True, bft=bft)
                continue
            overlap = windows[o][1]
            cost = self.price_fetch(size(o), overlap)
            extra = 0.0
            deficit = size(o) - free
            if deficit > 0:
                # Space frees only when the evictee is dropped at this
                # phase's start -> the incoming copy cannot overlap
                # earlier phases (paper Fig 6: movement respects the
                # availability of DRAM space).
                cost = self.price_fetch(size(o), 0.0)
                evict_bytes = evictables.quote(deficit)
                if evict_bytes is None:
                    continue   # cannot fit even with evictions
                extra = self.price_eviction(evict_bytes)
            w = perfmodel.weight(bft, cost, extra)
            items.append(knapsack.Item(o, w, size(o)))
            meta[o] = dict(cost=cost, extra=extra, resident=False, bft=bft)

        chosen = set(self._solve(items, self.capacity))
        return self._enact_phase(ph, chosen,
                                 {o: (m["cost"], m["bft"])
                                  for o, m in meta.items()},
                                 lambda o: windows[o][0],
                                 residents, resident_bytes)

    def _solve_phase_arrays(self, ph, lay: _PhaseLayout, bft: np.ndarray,
                            res_mask: np.ndarray,
                            entry_residents: Set[str], entry_bytes: int):
        """The array-program :meth:`_solve_phase`: candidate pricing,
        eviction quoting and feasibility masking as elementwise numpy over
        the cached layout, then the array knapsack.  Bit-identical plans:
        the same float expressions evaluated elementwise, candidates in
        the same order (infeasible ones masked, order preserved), and the
        same enactment loop."""
        gen = self._gen()
        sizes_d = gen.sizes
        residents = set(entry_residents)
        resident_bytes = entry_bytes
        free = self.capacity - resident_bytes
        refs = ph.refs
        evict_order = sorted(
            (r for r in residents
             if r not in refs and r not in gen.pinned),
            key=lambda r: (sizes_d[r], r))
        cum = np.cumsum(np.fromiter((sizes_d[r] for r in evict_order),
                                    dtype=np.int64, count=len(evict_order)))
        copy_bw = self.machine.copy_bw
        cfm = self.cf.cf_move
        base = lay.szf / copy_bw
        cost = perfmodel.movement_cost_batch(lay.szf, self.machine, lay.win)
        # deficit candidates cannot overlap earlier phases (space frees at
        # the phase itself): their cost is the zero-window price
        cost0 = np.maximum(base, 0.0)
        if self.enact_consistent:
            cost = np.maximum(cost, base)
        cost = cost * cfm
        cost0 = cost0 * cfm
        deficit = lay.sizes - free
        needs = (deficit > 0) & ~res_mask
        extra = np.zeros(len(lay.cands), dtype=np.float64)
        feasible = np.ones(len(lay.cands), dtype=bool)
        if needs.any():
            if len(cum):
                idx = np.searchsorted(cum, deficit[needs], side="left")
                ok = idx < len(cum)
                quote = cum[np.minimum(idx, len(cum) - 1)]
                feasible[needs] = ok
                extra[needs] = np.where(ok, quote / copy_bw * cfm, 0.0)
            else:
                feasible[needs] = False
        cost_eff = np.where(needs, cost0, cost)
        value = np.where(res_mask, bft, (bft - cost_eff) - extra)
        cost_eff = np.where(res_mask, 0.0, cost_eff)
        kept = np.flatnonzero(feasible)
        sel = knapsack.solve_arrays(value[kept], lay.sizes[kept],
                                    self.capacity)
        cands = lay.cands
        chosen: Set[str] = set()
        meta: Dict[str, Tuple[float, float]] = {}
        for i in kept[sel]:
            i = int(i)
            o = cands[i]
            chosen.add(o)
            meta[o] = (float(cost_eff[i]), float(bft[i]))
        trig_arr = lay.trig
        cand_pos = lay.cand_pos
        return self._enact_phase(ph, chosen, meta,
                                 lambda o: int(trig_arr[cand_pos[o]]),
                                 residents, resident_bytes)

    def _enact_phase(self, ph, chosen: Set[str],
                     meta: Dict[str, Tuple[float, float]], trig_of,
                     residents: Set[str], resident_bytes: int):
        """Enactment shared by both solve paths.  The order decides which
        chosen objects lose out when the knapsack's selection cannot fully
        materialize (it may decline a referenced resident — e.g. a
        phase's working buffer — that the mover can never actually evict,
        leaving less room than the solve assumed).  The legacy order is
        size-descending, which enacts the *smallest* chosen last — under
        multi-resolution refinement those are exactly the fine hot-head
        chunks, so ``enact_consistent`` switches to benefit-density
        order: any shortfall then drops the coldest chosen bytes instead
        of the hottest."""
        size = lambda o: self.registry[o].size_bytes
        if self.enact_consistent:
            order = sorted(chosen, key=lambda o: (
                -meta[o][1] / max(size(o), 1), o))
        else:
            order = sorted(chosen, key=lambda o: (-size(o), o))
        moves: List[MoveOp] = []
        # Enact: move chosen non-residents in, evicting just enough.
        for o in order:
            if o in residents:
                continue
            needed_evict = False
            deficit = size(o) - (self.capacity - resident_bytes)
            if deficit > 0:
                needed_evict = True
                evictable = sorted(
                    (r for r in residents
                     if r not in ph.refs and r not in chosen
                     and not self.registry[r].pinned),
                    key=lambda r: (size(r), r))
                freed = 0
                for r in evictable:
                    if freed >= deficit:
                        break
                    residents.discard(r)
                    resident_bytes -= size(r)
                    freed += size(r)
                    moves.append(MoveOp(r, "slow", ph.index, ph.index,
                                        size(r),
                                        self.price_eviction(size(r))))
                if freed < deficit:
                    # Cannot fit even after evicting everything allowed:
                    # skip the object but *keep* the evictions — they act
                    # as early space-clearing for the next phases' moves,
                    # and dropping them measurably regresses the chunked
                    # scenario workloads (graph_chase 1.32 -> 1.44
                    # normalized) even though the Eq.(4)/(5) model books
                    # them as pure cost.
                    continue
            # Eviction serializes with the incoming copy: trigger at the
            # phase itself (space is only free then).
            trig = (ph.index if needed_evict else trig_of(o))
            cost, bft = meta[o]
            moves.append(MoveOp(o, "fast", trig, ph.index, size(o),
                                cost, est_benefit=bft))
            residents.add(o)
            resident_bytes += size(o)
        return residents, resident_bytes, tuple(moves)

    def _placement_benefits(self, profiler: PhaseProfiler,
                            view: Optional[_ProfileView], phase_index: int,
                            placement: Set[str]
                            ) -> Tuple[Dict[str, float], Dict[str, str]]:
        """Eq. (1)-(3) benefit (and resolved class, for every non-zero
        benefit) of every placed object, batch-ensured — the
        predicted-time inputs cached on the phase's decision."""
        if view is not None:
            view.ensure(phase_index, list(placement))
            bmap = {o: view.benefit(phase_index, o) for o in placement}
            cmap = {o: view.gain_class(phase_index, o)
                    for o, b in bmap.items() if b != 0.0}
        else:
            bmap = {o: self._benefit_scalar(profiler, phase_index, o)
                    for o in placement}
            cmap = {o: self._gain_class_scalar(profiler, phase_index, o)
                    for o, b in bmap.items() if b != 0.0}
        return bmap, cmap

    def plan_local(self, graph: PhaseGraph, profiler: PhaseProfiler, *,
                   standing: Optional[Sequence[PhaseDecision]] = None,
                   standing_digest: Optional[tuple] = None
                   ) -> PlacementPlan:
        """Phase-local search.  With ``standing`` (the previous plan's
        :class:`PhaseDecision` list), phases whose entry state and input
        fingerprint still match reuse the cached decision without
        re-solving — the scoped replan path (plans are equal to a full
        replan by construction).

        ``standing_digest`` (the previous plan's ``graph_digest``) enables
        the fast path: when the graph's measured times and reference sets
        are unchanged, every trigger point and overlap window is provably
        unchanged too, so reuse checks reduce to (profile version, registry
        generation, entry residency) and skip per-candidate window
        computation entirely."""
        view = self._get_view(profiler)
        gen = self._gen()
        generation = gen.generation
        digest = self._graph_digest(graph, profiler)
        windex: Optional[_TriggerIndex] = None  # built on first slow-path use
        windows_static = standing is not None and standing_digest == digest
        fast_tier = self._fast_tier()
        residents = self._entry_residents(fast_tier)
        resident_bytes = sum(gen.sizes[o] for o in residents)
        residents, resident_bytes, moves = self._entry_shed(
            graph, residents, resident_bytes)
        placements: List[Set[str]] = []
        decisions: List[PhaseDecision] = []
        bmaps: List[Optional[Dict[str, float]]] = []
        cmaps: List[Optional[Dict[str, str]]] = []

        for ph in graph:
            ver = profiler.phase_version(ph.index)
            d: Optional[PhaseDecision] = None
            bmap: Optional[Dict[str, float]] = None
            cmap: Optional[Dict[str, str]] = None
            s = (standing[ph.index]
                 if standing is not None and ph.index < len(standing)
                 else None)
            if (windows_static and s is not None
                    and s.entry_residents == residents
                    and s.entry_bytes == resident_bytes
                    and s.fingerprint[:2] == (ver, generation)):
                # fast path: unchanged graph digest ⇒ unchanged windows ⇒
                # the full fingerprint would match too
                d = dataclasses.replace(s, reused=True)
            if d is None and view is not None:
                lay = self._phase_layout(graph, ph, gen, view, digest,
                                         digest[1][ph.index])
                res_mask = np.zeros(len(lay.cands), dtype=bool)
                cand_pos = lay.cand_pos
                for r in residents:
                    i = cand_pos.get(r)
                    if i is not None:
                        res_mask[i] = True
                nonres = ~res_mask
                fp = (ver, generation,
                      _fp_hash(lay.names_blob,
                               res_mask.astype(np.uint8).tobytes(),
                               lay.trig[nonres], lay.win[nonres]))
                if (s is not None and s.entry_residents == residents
                        and s.entry_bytes == resident_bytes
                        and s.fingerprint == fp):
                    d = dataclasses.replace(s, reused=True)
                else:
                    bft = self._layout_benefits(view, ph.index, lay)
                    exit_res, exit_bytes, ph_moves = self._solve_phase_arrays(
                        ph, lay, bft, res_mask, residents, resident_bytes)
                    bmap, cmap = self._placement_benefits(
                        profiler, view, ph.index, exit_res)
                    d = PhaseDecision(
                        phase_index=ph.index,
                        entry_residents=frozenset(residents),
                        entry_bytes=resident_bytes, fingerprint=fp,
                        moves=ph_moves, exit_residents=frozenset(exit_res),
                        exit_bytes=exit_bytes, benefits=bmap, classes=cmap)
            elif d is None:
                in_reg, cands = self._phase_candidates(profiler, ph)
                if windex is None:
                    windex = self._windex(graph, digest)
                windows = {o: windex.pair(o, ph.index) for o in cands
                           if o not in residents}
                fp = self._phase_fingerprint(profiler, ph, cands, windows)
                if (s is not None and s.entry_residents == residents
                        and s.entry_bytes == resident_bytes
                        and s.fingerprint == fp):
                    d = dataclasses.replace(s, reused=True)
                else:
                    bft_of = lambda o: self._benefit_scalar(
                        profiler, ph.index, o)
                    exit_res, exit_bytes, ph_moves = self._solve_phase(
                        ph, cands, bft_of, windows, residents,
                        resident_bytes)
                    bmap, cmap = self._placement_benefits(
                        profiler, None, ph.index, exit_res)
                    d = PhaseDecision(
                        phase_index=ph.index,
                        entry_residents=frozenset(residents),
                        entry_bytes=resident_bytes, fingerprint=fp,
                        moves=ph_moves, exit_residents=frozenset(exit_res),
                        exit_bytes=exit_bytes, benefits=bmap, classes=cmap)
            if bmap is None:
                bmap = d.benefits
                cmap = d.classes
            moves.extend(d.moves)
            residents = set(d.exit_residents)
            resident_bytes = d.exit_bytes
            placements.append(set(d.exit_residents))
            decisions.append(d)
            bmaps.append(bmap)
            cmaps.append(cmap)

        # Predicted steady-state iteration time: baseline minus the realized
        # per-phase benefits of everything resident (that profiling saw in
        # the slow tier), plus the unhidden movement/eviction costs.
        # Benefit values come from each decision's cache (batch-ensured at
        # solve time; bitwise-reproducible, so reuse cannot change them).
        predicted = graph.iteration_time()
        gain_bw = [0.0] * len(graph)
        gain_lat = [0.0] * len(graph)
        cls_of = ((lambda i, o: view.gain_class(i, o)) if view is not None
                  else (lambda i, o: self._gain_class_scalar(profiler, i, o)))
        for ph in graph:
            bmap = bmaps[ph.index]
            cmap = cmaps[ph.index]
            if bmap is None:    # decision from a pre-cache serialized plan
                bmap, cmap = self._placement_benefits(
                    profiler, view, ph.index, placements[ph.index])
            for o in sorted(placements[ph.index]):   # fixed fp-sum order
                if o not in fast_tier:
                    g = bmap[o]
                    predicted -= g
                    if g != 0.0:
                        c = cmap.get(o) if cmap is not None else None
                        if c is None:
                            c = cls_of(ph.index, o)
                        if c == "lat":
                            gain_lat[ph.index] += g
                        else:
                            gain_bw[ph.index] += g
        predicted += sum(m.est_unhidden_cost for m in moves)
        return PlacementPlan("local", placements, moves,
                             max(predicted, 0.0), graph.iteration_time(),
                             emit_schedule(moves, graph, self.machine.copy_bw),
                             phase_decisions=decisions,
                             graph_digest=digest,
                             phase_baseline=[p.time for p in graph],
                             phase_gain_bw=gain_bw, phase_gain_lat=gain_lat)

    # ---------------------------------------------------------- global search
    def _global_layout_for(self, graph: PhaseGraph, digest: tuple,
                           gen: _GenCache) -> _GlobalLayout:
        gl = self._global_layout
        if (gl is not None and gl.generation == gen.generation
                and gl.digest == digest):
            return gl
        reg = self.registry
        sizes_d = gen.sizes
        pinned = gen.pinned
        parent_of = gen.parent_of
        first_ref: Dict[str, int] = {}
        objs: List[str] = []
        pos: Dict[str, int] = {}
        sizes: List[int] = []
        pgroups: Dict[str, Tuple[List[int], List[int]]] = {}
        for p in graph:
            for o in p.refs:
                if o in first_ref:
                    continue
                first_ref[o] = p.index
                sz = sizes_d.get(o)
                if sz is None or o in pinned:
                    continue
                i = len(objs)
                pos[o] = i
                objs.append(o)
                sizes.append(sz)
                par = parent_of.get(o)
                if par is not None:
                    g = pgroups.get(par)
                    if g is None:
                        g = pgroups[par] = ([], [])
                    g[0].append(i)
                    g[1].append(gen.span_idx(reg, par)[o])
        gl = _GlobalLayout(
            digest=digest, generation=gen.generation, objs=objs,
            objs_t=tuple(objs), pos=pos,
            sizes=np.asarray(sizes, dtype=np.int64), first_ref=first_ref,
            parent_groups=[(par, np.asarray(ix, dtype=np.int64),
                            np.asarray(si, dtype=np.int64))
                           for par, (ix, si) in pgroups.items()])
        self._global_layout = gl
        return gl

    def _global_row(self, view: _ProfileView, phase: int,
                    glay: _GlobalLayout) -> Tuple[np.ndarray, np.ndarray]:
        """One phase's benefit (and class) row over the global candidate
        universe, scattered from the view's per-parent blocks with direct
        profiles overriding (exactly the view's per-object precedence)."""
        nobj = len(glay.objs)
        row = np.zeros(nobj, dtype=np.float64)
        cls = np.zeros(nobj, dtype=np.uint8)
        direct = view.direct(phase)
        for par, positions, span_idx in glay.parent_groups:
            if par not in direct:
                continue
            blk = view._pblock(phase, par)
            row[positions] = blk[0][span_idx]
            cls[positions] = blk[1][span_idx]
        dpos: List[int] = []
        dprof: List = []
        pos = glay.pos
        for o, prof in direct.items():
            i = pos.get(o)
            if i is not None:
                dpos.append(i)
                dprof.append(prof)
        if dprof:
            cols = np.array(
                [(p.data_access, p.n_samples, p.samples_with_access,
                  p.phase_time, p.cacheline_bytes) for p in dprof],
                dtype=np.float64)
            vals, cl = perfmodel.benefit_batch(
                cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3], cols[:, 4],
                self.machine, self.cf, return_class=True)
            row[dpos] = vals
            cls[dpos] = cl
        return row, cls

    def plan_global(self, graph: PhaseGraph, profiler: PhaseProfiler, *,
                    standing_global: Optional[Sequence[GlobalContrib]] = None,
                    prune_above: Optional[float] = None
                    ) -> PlacementPlan:
        """Cross-phase global search.  With ``standing_global`` (the
        previous plan's per-phase benefit contributions), phases whose
        profile version and registry generation still match reuse their
        recorded contributions — the totals are summed in phase order
        either way, so the result is bitwise identical to a full
        recompute.  A zero-drift rebuild (same versions, generation,
        entry residency, capacity and calibration) returns the memoized
        decision outright (``global_mode="reused"``).

        ``prune_above`` (the local plan's predicted time) arms the
        dominance bound: when ``baseline - UB > prune_above`` for a
        fractional-knapsack upper bound UB on the attainable gains, the
        global plan provably cannot win the best-of-two and the solve is
        skipped (``global_mode="pruned"``); the returned plan's predicted
        time is then the certified lower bound ``baseline - UB``, which
        keeps the chooser's pick identical to a full solve (the chooser
        prefers local on ties, and the bound only fires when local wins
        strictly)."""
        view = self._get_view(profiler)
        gen = self._gen()
        generation = gen.generation
        n = len(graph)
        digest = self._graph_digest(graph, profiler)
        glay = self._global_layout_for(graph, digest, gen)
        objs = glay.objs
        objs_t = glay.objs_t
        versions = tuple(profiler.phase_version(p.index) for p in graph)
        fast_tier = self._fast_tier()
        residents0 = self._entry_residents(fast_tier)
        memo_key = (digest, generation, versions, frozenset(residents0),
                    self.capacity,
                    (self.cf.cf_bw, self.cf.cf_lat, self.cf.cf_move),
                    self.vectorized, self.enact_consistent)
        memo = self._global_memo
        if (memo is not None and memo["profiler"] is profiler
                and memo["key"] == memo_key):
            return PlacementPlan(
                "global", [set(memo["chosen"])] * n, list(memo["moves"]),
                memo["predicted"], memo["baseline"], list(memo["schedule"]),
                global_contribs=list(memo["contribs"]),
                phase_baseline=list(memo["phase_baseline"]),
                phase_gain_bw=list(memo["gain_bw"]),
                phase_gain_lat=list(memo["gain_lat"]),
                global_mode="reused", global_rows_reused=n)

        contribs_out: List[GlobalContrib] = []
        rows_reused = 0
        for p in graph:
            version = versions[p.index]
            row: Optional[np.ndarray] = None
            cls_row: Optional[np.ndarray] = None
            if standing_global is not None and p.index < len(standing_global):
                g = standing_global[p.index]
                if (g.version == version and g.generation == generation
                        and (g.objs is objs_t or g.objs == objs_t)):
                    row = g.row
                    cls_row = g.cls_row
                    rows_reused += 1
            if row is None:
                if view is not None:
                    row, cls_row = self._global_row(view, p.index, glay)
                else:
                    row = np.asarray(
                        [self._benefit_scalar(profiler, p.index, o)
                         for o in objs], dtype=np.float64)
            contribs_out.append(GlobalContrib(
                phase_index=p.index, version=version,
                generation=generation, objs=objs_t, row=row,
                cls_row=cls_row))
        if contribs_out and objs:
            totals_vec = np.vstack([g.row for g in contribs_out]).sum(axis=0)
        else:
            totals_vec = np.zeros(len(objs))
        baseline = graph.iteration_time()

        if prune_above is not None and len(objs):
            # Dominance bound: predicted_global >= baseline - V* >= lb for
            # any selection (the knapsack never picks non-positive values;
            # move/eviction costs only add; the final max(.., 0) only
            # raises).  The strict relative margin keeps float noise in
            # the bound from ever flipping a tie — the chooser prefers
            # local on exact ties, so pruning must fire only when local
            # wins outright.
            lb = baseline - _fractional_ub(totals_vec, glay.sizes,
                                           self.capacity)
            if lb > prune_above + 1e-9 * max(1.0, abs(prune_above)):
                return PlacementPlan(
                    "global", [set(residents0)] * n, [], float(lb),
                    baseline, [], global_contribs=contribs_out,
                    phase_baseline=[p.time for p in graph],
                    phase_gain_bw=[0.0] * n, phase_gain_lat=[0.0] * n,
                    global_mode="pruned", global_rows_reused=rows_reused)

        if self.vectorized:
            sel = knapsack.solve_arrays(totals_vec, glay.sizes, self.capacity)
            chosen = {objs[int(i)] for i in sel}
        else:
            items = [knapsack.Item(o, float(totals_vec[i]), gen.sizes[o])
                     for i, o in enumerate(objs)]
            chosen = set(knapsack.solve_reference(items, self.capacity))

        moves: List[MoveOp] = []
        predicted = baseline
        pos = glay.pos
        first_ref = glay.first_ref
        sizes_d = gen.sizes
        for o in sorted(residents0 - chosen):   # deterministic move order
            moves.append(MoveOp(o, "slow", 0, 0, sizes_d[o],
                                self.price_eviction(sizes_d[o])))
        windex = self._windex(graph, digest)
        for o in sorted(chosen, key=lambda o: (first_ref.get(o, 0), o)):
            val = float(totals_vec[pos[o]])
            if o not in fast_tier:
                predicted -= val
            if o not in residents0:
                # One-time move, dispatched at iteration start and fenced at
                # the object's first use so it overlaps the leading phases
                # (this is what makes the paper's Table-4 overlap percentages
                # non-zero for global placements).  Priced through the same
                # Eq. (4) helper as the local search — the overlap window is
                # the compute between dispatch and the fence — so the
                # best-of-two chooser compares cost-inclusive numbers on
                # both sides.
                fence = first_ref.get(o, 0)
                window = windex.window(0, fence)
                moves.append(MoveOp(o, "fast", 0, fence, sizes_d[o],
                                    self.price_fetch(sizes_d[o], window),
                                    est_benefit=val))
        predicted += sum(m.est_unhidden_cost for m in moves)
        # Per-phase gain decomposition for the calibration feedback: the
        # chosen slow objects' per-phase contributions, split by benefit
        # class (the per-object totals the knapsack saw are these same
        # rows summed over phases).
        gain_bw = [0.0] * n
        gain_lat = [0.0] * n
        cls_of = ((lambda i, o: view.gain_class(i, o)) if view is not None
                  else (lambda i, o: self._gain_class_scalar(profiler, i, o)))
        chosen_slow = sorted(pos[o] for o in chosen if o not in fast_tier)
        for g in contribs_out:
            cr = g.cls_row
            for i in chosen_slow:
                v = float(g.row[i])
                if v != 0.0:
                    lat = (bool(cr[i]) if cr is not None
                           else cls_of(g.phase_index, objs[i]) == "lat")
                    if lat:
                        gain_lat[g.phase_index] += v
                    else:
                        gain_bw[g.phase_index] += v
        predicted = max(predicted, 0.0)
        schedule = emit_schedule(moves, graph, self.machine.copy_bw)
        self._global_memo = dict(
            profiler=profiler, key=memo_key, chosen=frozenset(chosen),
            moves=list(moves), predicted=predicted, baseline=baseline,
            schedule=schedule, contribs=contribs_out,
            phase_baseline=[p.time for p in graph],
            gain_bw=gain_bw, gain_lat=gain_lat)
        return PlacementPlan("global", [set(chosen)] * n, moves,
                             predicted, baseline, schedule,
                             global_contribs=contribs_out,
                             phase_baseline=[p.time for p in graph],
                             phase_gain_bw=gain_bw, phase_gain_lat=gain_lat,
                             global_rows_reused=rows_reused)

    # ----------------------------------------------------------- best of two
    def plan(self, graph: PhaseGraph, profiler: PhaseProfiler, *,
             standing: Optional[Sequence[PhaseDecision]] = None,
             standing_global: Optional[Sequence[GlobalContrib]] = None,
             standing_digest: Optional[tuple] = None) -> PlacementPlan:
        self._tier_snapshot = self._fast_tier()
        try:
            local = self.plan_local(graph, profiler, standing=standing,
                                    standing_digest=standing_digest)
            glob = self.plan_global(
                graph, profiler, standing_global=standing_global,
                prune_above=local.predicted_iteration_time)
        finally:
            self._tier_snapshot = None
        chosen = (local
                  if local.predicted_iteration_time
                  < glob.predicted_iteration_time else glob)
        chosen.global_mode = glob.global_mode
        chosen.global_rows_reused = glob.global_rows_reused
        return chosen
