"""Online phase profiling (paper §3.1.1) with per-chunk attribution.

The paper samples last-level-cache-miss events (PEBS/IBS) during the first
iteration and attributes sampled memory addresses to target data objects.
On TPU there is no PEBS; the *true* per-(phase, object) access counts come
from the compiled phase's cost analysis plus analytic per-object reference
counts (see ``repro.launch.dryrun`` / ``repro.sim.workloads``).  To keep the
downstream pipeline identical to the paper's — including its tolerance to
sampling error, which the CF constants compensate — the profiler converts
true counts into *sampled observations*:

* ``n_samples``        : phase_time x sample_rate
* ``samples_with_hit`` : samples that observed >=1 access to the object
* ``data_access``      : access count estimated from the sampled subset

A deterministic seeded RNG injects the sampling noise.

**Per-chunk attribution** extends the sampling model below object
granularity: when the instrumentation reports how an object's accesses
distribute over its byte range (``PhaseTraceEvent.access_bins`` — the
address histogram a PEBS sample stream would produce), each sample that hit
the object also "records an address", i.e. lands in one of the measured
histogram's bins.  The profiler draws those bin hits from a seeded
multinomial over the true distribution, so the measured histogram carries
realistic sampling noise that shrinks as more samples accumulate.
Downstream, the skew-aware partitioner (``partition.skew_boundaries``) and
the planner's chunk fallback read the measured histogram instead of
assuming uniform density.

**Multi-resolution histograms**: the measured histogram is a
:class:`~.histogram.Histogram` — variable-width bins over the object's
byte range under a total bin budget (``hist_bins``; ``None`` keeps the
instrumentation's native uniform resolution, the legacy fixed-width
behavior, bit-identical plans included).  With ``hist_refine``,
:meth:`PhaseProfiler.refine_histograms` adaptively re-bins between
profiling iterations: hot bins split finer, cold bins coarsen to pay for
it, and the *next* iteration's sampled addresses land in the refined bins
— so resolution concentrates where the mass is without growing the
budget.  Every resolution change bumps the phase's profile version and
the profiler-wide ``hist_epoch``, which join the planner's phase
fingerprints / plan provenance so scoped replanning stays provably equal.

**Accumulation** is a running (weighted) mean: observing the same
(phase, object) across ``profile_iterations > 1`` iterations folds each new
observation into the stored profile instead of overwriting it, so
multi-iteration profiling actually reduces sampling noise.  ``decay``
down-weights the accumulated history, letting fresh observations dominate —
the incremental-replan path uses it so a drifted workload re-profiles
without throwing the old plan away.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .histogram import Histogram
from .phase import PhaseGraph, PhaseTraceEvent
from .tiers import MachineProfile

#: cap on multinomial draws per (phase, object) observation — beyond this the
#: histogram is effectively converged and more draws only cost time
MAX_BIN_DRAWS = 1 << 16


@dataclasses.dataclass
class ObjectPhaseProfile:
    """Profiler output for one (phase, object) pair — inputs to Eq. (1).

    Values are running means over every folded observation (``weight``
    observations so far, possibly fractional after :meth:`PhaseProfiler.decay`).
    ``bin_counts`` accumulates sampled address->bin hits across observations
    as a (possibly multi-resolution) :class:`~.histogram.Histogram`;
    ``bin_weights`` exposes the same histogram when it carries mass (None
    when the object was never observed with per-chunk attribution)."""

    phase_index: int
    obj: str
    data_access: float          # #data_access (estimated accesses to memory)
    n_samples: float            # #samples
    samples_with_access: float  # #samples_with_data_accesses
    phase_time: float           # seconds
    cacheline_bytes: float = 64.0   # machine.cacheline_bytes at observation
    bin_counts: Optional[Histogram] = None
    weight: float = 1.0         # observations folded into the running means

    @property
    def accessed_bytes(self) -> float:
        """Bytes this object moved through main memory in the phase
        (Eq. (1)-(2) numerator: #data_access x cacheline)."""
        return self.data_access * self.cacheline_bytes

    @property
    def bin_weights(self) -> Optional[Histogram]:
        """Measured access histogram over the object's byte range
        (mass-carrying), or None when no per-chunk attribution was ever
        observed.  Downstream integrates it with ``partition.bin_mass`` /
        :meth:`Histogram.mass_fraction` — the bins may be variable-width."""
        if self.bin_counts is None or self.bin_counts.total <= 0.0:
            return None
        return self.bin_counts


class PhaseProfiler:
    """Builds per-(phase, object) profiles from raw phase trace events."""

    def __init__(self, machine: MachineProfile, *, seed: int = 0,
                 noise: float = 0.05, hist_bins: Optional[int] = None,
                 hist_refine: bool = False):
        self.machine = machine
        self.noise = noise
        #: measured-histogram bin budget: None accumulates at the
        #: instrumentation's native uniform resolution (legacy behavior);
        #: an int projects every observation onto that many bins
        self.hist_bins = hist_bins
        #: whether refine_histograms should adapt bin edges (the session
        #: calls it between profiling iterations when enabled)
        self.hist_refine = hist_refine
        #: profile epoch: bumped whenever accumulated history is decayed or
        #: cleared — plan provenance records which epoch produced a decision
        self.epoch = 0
        #: histogram resolution epoch: bumped whenever any measured
        #: histogram's bin edges change (plan provenance)
        self.hist_epoch = 0
        self._rng = np.random.default_rng(seed)
        # accumulated observations: (phase, obj) -> running-mean profile
        self._acc: Dict[int, Dict[str, ObjectPhaseProfile]] = {}
        # phase -> (running mean time, accumulated weight)
        self._times: Dict[int, List[float]] = {}
        # phase -> observation counter: bumped on every mutation of that
        # phase's accumulated state.  (epoch, phase_version, resolution)
        # identifies a phase's profile state exactly, so the scoped
        # replanner can prove "this phase's solve inputs did not change"
        # without recomputing benefits (see planner.PhaseDecision).
        self._versions: Dict[int, int] = {}
        # phase -> histogram resolution counter: bumped when any of the
        # phase's measured histograms is re-binned
        self._hist_res: Dict[int, int] = {}

    # -- ingestion -----------------------------------------------------------
    def observe(self, ev: PhaseTraceEvent) -> None:
        """Ingest one dynamic phase execution (one loop iteration's phase).

        Repeat observations of the same (phase, object) fold into a running
        mean (weighted by prior accumulation) rather than clobbering the
        stored profile."""
        n_samples = max(ev.time * self.machine.sample_rate_hz, 1.0)
        self._versions[ev.phase_index] = \
            self._versions.get(ev.phase_index, 0) + 1
        prof_map = self._acc.setdefault(ev.phase_index, {})
        tm = self._times.get(ev.phase_index)
        if tm is None:
            self._times[ev.phase_index] = [ev.time, 1.0]
        else:
            tm[1] += 1.0
            tm[0] += (ev.time - tm[0]) / tm[1]
        total_access = sum(ev.accesses.values())
        for obj, true_access in ev.accesses.items():
            if true_access <= 0:
                continue
            # Sampling model: a sample observes this object iff it lands in a
            # window where the object's accesses are in flight, i.e. with
            # probability = the object's share of phase *time* (PEBS
            # semantics).  Falls back to access-count share when the caller
            # cannot attribute time.  Multiplicative noise models PEBS skid
            # and uncounted events (evictions/prefetches), which the paper
            # compensates with CF constants.
            if ev.time_shares is not None and obj in ev.time_shares:
                share = ev.time_shares[obj]
            else:
                share = true_access / max(total_access, 1.0)
            jitter = 1.0 + self.noise * self._rng.standard_normal()
            jitter = float(np.clip(jitter, 0.5, 1.5))
            observed = true_access * jitter
            hit_frac = min(1.0, share * jitter)
            swa = max(hit_frac * n_samples, 1.0)
            prev = prof_map.get(obj)
            counts: Optional[Histogram] = None
            if ev.access_bins is not None and obj in ev.access_bins:
                counts = self._sample_bins(
                    ev.access_bins[obj], swa,
                    prev.bin_counts if prev is not None else None)
            if prev is None:
                prof_map[obj] = ObjectPhaseProfile(
                    phase_index=ev.phase_index, obj=obj,
                    data_access=observed,
                    n_samples=n_samples,
                    samples_with_access=swa,
                    phase_time=ev.time,
                    cacheline_bytes=float(self.machine.cacheline_bytes),
                    bin_counts=counts)
            else:
                w = prev.weight + 1.0
                prev.data_access += (observed - prev.data_access) / w
                prev.n_samples += (n_samples - prev.n_samples) / w
                prev.samples_with_access += (swa - prev.samples_with_access) / w
                prev.phase_time += (ev.time - prev.phase_time) / w
                prev.weight = w
                if counts is not None:
                    if prev.bin_counts is None:
                        prev.bin_counts = counts
                    elif prev.bin_counts.same_edges(counts):
                        prev.bin_counts = prev.bin_counts.add(counts)
                    else:       # instrumentation changed its bin resolution
                        prev.bin_counts = counts
        # An execution where a previously-profiled object had *no* accesses
        # is a real observation of zero — fold it in, so objects that go
        # cold actually fade from the profile (without this, a drifted
        # workload's stale hot set would survive re-profiling forever).
        for obj, prev in prof_map.items():
            if ev.accesses.get(obj, 0.0) > 0:
                continue
            w = prev.weight + 1.0
            prev.data_access += (0.0 - prev.data_access) / w
            prev.n_samples += (n_samples - prev.n_samples) / w
            prev.samples_with_access += (0.0 - prev.samples_with_access) / w
            prev.phase_time += (ev.time - prev.phase_time) / w
            prev.weight = w

    def _native_hist(self, truth) -> Histogram:
        """Empty histogram at the truth's native resolution."""
        if isinstance(truth, Histogram):
            return Histogram(truth.edges, np.zeros(truth.n_bins))
        n = int(np.asarray(truth, dtype=np.float64).size) or 1
        return Histogram.uniform(n)

    def _target_hist(self, truth, prev: Optional[Histogram]) -> Histogram:
        """The edge set this observation's sampled addresses land in: the
        accumulated histogram's (possibly refined) edges when one exists,
        else the bin budget's uniform grid, else the truth's native
        resolution.

        Legacy native mode (no bin budget) with an un-refined (uniform)
        accumulated histogram: a source that changes its native resolution
        mid-run re-targets to the new resolution, which resets the
        accumulation (the pre-multi-res behavior — stale coarse edges must
        not quantize a newly finer truth forever).  Refined histograms
        keep their adapted edges regardless."""
        if prev is not None:
            if self.hist_bins is None and prev.is_uniform:
                native = self._native_hist(truth)
                if not prev.same_edges(native):
                    return native
            return prev
        if self.hist_bins is not None:
            return Histogram.uniform(int(self.hist_bins))
        return self._native_hist(truth)

    def _sample_bins(self, true_weights, swa: float,
                     prev: Optional[Histogram]) -> Optional[Histogram]:
        """Sampled address->bin histogram: each sample that hit the object
        records an address; addresses land in the target histogram's bins
        proportionally to the true access distribution (the PEBS event
        stream, with multinomial noise).  The target edges are the
        accumulated histogram's — refined edges keep receiving samples at
        their own resolution."""
        target = self._target_hist(true_weights, prev)
        p = target.project(true_weights)
        if p is None:
            return None
        draws = int(min(max(swa, 8.0), MAX_BIN_DRAWS))
        counts = self._rng.multinomial(draws, p).astype(np.float64)
        return Histogram(target.edges, counts)

    def observe_iteration(self, events: Iterable[PhaseTraceEvent]) -> None:
        for ev in events:
            self.observe(ev)

    # -- outputs --------------------------------------------------------------
    def profile(self, phase_index: int, obj: str) -> Optional[ObjectPhaseProfile]:
        return self._acc.get(phase_index, {}).get(obj)

    def profiles_for_phase(self, phase_index: int) -> Dict[str, ObjectPhaseProfile]:
        return dict(self._acc.get(phase_index, {}))

    def phase_time(self, phase_index: int) -> float:
        tm = self._times.get(phase_index)
        return float(tm[0]) if tm else 0.0

    def phase_version(self, phase_index: int) -> Tuple[int, int, int]:
        """(epoch, observation counter, histogram resolution counter) —
        identifies this phase's accumulated profile state, including its
        measured histograms' bin edges, exactly (scoped-replan reuse
        key)."""
        return (self.epoch, self._versions.get(phase_index, 0),
                self._hist_res.get(phase_index, 0))

    def object_bins(self, obj: str) -> Dict[int, Histogram]:
        """Measured per-phase access histograms for ``obj`` (phases where the
        object was observed with per-chunk attribution only)."""
        out: Dict[int, Histogram] = {}
        for phase_index, prof_map in self._acc.items():
            p = prof_map.get(obj)
            if p is not None:
                w = p.bin_weights
                if w is not None:
                    out[phase_index] = w
        return out

    def annotate_graph(self, graph: PhaseGraph,
                       phases: Optional[Sequence[int]] = None) -> None:
        """Write measured times + access counts back into the phase graph.

        An object whose folded mean has faded below one access is treated as
        *unreferenced* by the phase (its ref entry is dropped): a lingering
        epsilon ref would still count as a reference and e.g. shield a
        gone-cold object from eviction forever.

        ``phases`` scopes the rewrite to the listed phase indices (a
        serving-tick replan annotates only the drifted phases — an
        unchanged profile version rewrites identical values, so skipping
        it cannot change the graph)."""
        scope = None if phases is None else set(phases)
        for p in graph:
            if scope is not None and p.index not in scope:
                continue
            t = self.phase_time(p.index)
            if t > 0:
                p.time = t
            for obj, prof in self.profiles_for_phase(p.index).items():
                if prof.data_access >= 1.0:
                    p.refs[obj] = prof.data_access
                else:
                    p.refs.pop(obj, None)

    def decay(self, factor: float = 0.25,
              phases: Optional[Union[int, Sequence[int]]] = None) -> None:
        """Down-weight accumulated history so subsequent observations dominate
        the running means (incremental replanning: reuse the old profiles as a
        prior instead of throwing them away).

        ``phases`` restricts the decay to the given phase indices (a bare
        int is accepted as a single phase) — the scoped drift response:
        only the drifted phases' histories are down-weighted and
        re-observed, so every other phase's profile state stays bitwise
        identical and its standing plan decision remains provably reusable.
        A phase that was observed zero times (no accumulated state) is a
        documented **no-op**: there is nothing to decay, nothing raises,
        and no version advances."""
        if not 0.0 <= factor <= 1.0:
            raise ValueError("decay factor must be in [0, 1]")
        if phases is not None and isinstance(phases, int):
            phases = [phases]
        scope = None if phases is None else set(phases)
        if scope is None:
            self.epoch += 1
        for phase_index, prof_map in self._acc.items():
            if scope is not None:
                if phase_index not in scope:
                    continue
                self._versions[phase_index] = \
                    self._versions.get(phase_index, 0) + 1
            for p in prof_map.values():
                p.weight *= factor
                if p.bin_counts is not None:
                    p.bin_counts = p.bin_counts.scaled(factor)
        for phase_index, tm in self._times.items():
            if scope is not None and phase_index not in scope:
                continue
            tm[1] *= factor

    def refine_histograms(self, budget: Optional[int] = None,
                          phases: Optional[Sequence[int]] = None,
                          *, min_width: Optional[float] = None,
                          decay: float = 0.25) -> List[int]:
        """Adaptively re-bin the accumulated measured histograms: hot bins
        split finer, cold regions coarsen, total bins stay within
        ``budget`` (default: the profiler's ``hist_bins``, else 64).  The
        session calls this *between* profiling iterations so the next
        iteration's sampled addresses land in the refined bins.

        A split bin hands each half exactly half its mass — the best
        piecewise-constant guess, but *no information* about the true
        sub-structure — so a re-binned histogram's accumulated counts are
        additionally scaled by ``decay``: the next iteration's sampled
        addresses (drawn at the refined resolution) dominate the running
        histogram instead of being averaged into the flat-prior residue
        (which would bias fine-bin masses toward uniform for ~1/weight
        iterations and mis-rank the hot head's chunks).

        ``phases`` scopes the refinement (the scoped drift response: a
        phase outside the scope keeps its bin edges — and therefore its
        profile version — bitwise intact, so its standing plan decision
        stays reusable).  Phases observed zero times are no-ops.  Returns
        the phase indices whose resolution changed; any change bumps the
        profiler-wide ``hist_epoch`` (plan provenance)."""
        budget = int(budget if budget is not None
                     else (self.hist_bins or 64))
        min_width = (min_width if min_width is not None
                     else 1.0 / (16 * budget))
        scope = None if phases is None else set(phases)
        changed: List[int] = []
        for phase_index in sorted(self._acc):
            if scope is not None and phase_index not in scope:
                continue
            ph_changed = False
            for p in self._acc[phase_index].values():
                h = p.bin_counts
                if h is None or h.total <= 0.0:
                    continue
                h2 = h.refined(budget, min_width=min_width)
                if h2 is not h:     # refined() returns self when unchanged
                    p.bin_counts = h2.scaled(decay)
                    ph_changed = True
            if ph_changed:
                self._hist_res[phase_index] = \
                    self._hist_res.get(phase_index, 0) + 1
                self._versions[phase_index] = \
                    self._versions.get(phase_index, 0) + 1
                changed.append(phase_index)
        if changed:
            self.hist_epoch += 1
        return changed

    def clear(self) -> None:
        self.epoch += 1
        self.hist_epoch += 1
        self._versions.clear()
        self._hist_res.clear()
        self._acc.clear()
        self._times.clear()
