"""Discrete-event simulation of phase execution on a two-tier memory.

Stands in for the Quartz emulator (paper §4).  The physics live in
:class:`SimSource` — an :class:`~..core.instrumentation.
InstrumentationSource` that derives each phase's execution time and its
instrumentation (true access counts, per-object time shares, per-chunk
access densities) from the workload spec and the *current* registry tier
state:

* ``stream``-type accesses are bandwidth-bound: ``bytes / tier.bw`` (memory
  level parallelism hides latency);
* ``chase``-type accesses are latency-bound: ``accesses x tier.lat``
  (dependent pointer chasing exposes full latency, bandwidth irrelevant).

An object's pattern mixes the two with ``stream_fraction`` — this reproduces
the paper's Observation 3 (objects can be bandwidth-sensitive,
latency-sensitive, or both).  Phase time = scalar compute + the serialized
memory time of its objects.

:class:`SimulationEngine` is then just a virtual clock around the v2
session API: each iteration is ``with rt.iteration():``, each phase a
``with rt.phase(name):`` whose instrumentation the attached
:class:`SimSource` supplies — the exact pipeline through which a driver on
real hardware feeds its own instrumentation source.
Migration copies run on the simulated copy engine from the backend
registry (``make_backend("sim", ...)``) matched to the runtime's
configured mover — the FIFO baseline (``SimTierBackend``, one serial
queue) or the slack-aware scheduler's multi-channel engine
(``ChannelSimBackend``, concurrent copies with bandwidth contention, tier
flips only on landing).  Fence stalls land on the critical path only when
slack is exhausted; every phase execution is recorded in a virtual-time
trace (``PhaseExec``) for invariant checks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.backends import make_backend
from ..core.data_objects import ObjectRegistry
from ..core.instrumentation import PhaseSample
from ..core.partition import bin_mass, chunk_spans
from ..core.session import Session
from ..core.tiers import MachineProfile


@dataclasses.dataclass
class SimObjectAccess:
    """How one phase touches one object."""

    accesses: float              # main-memory accesses (cachelines)
    stream_fraction: float = 1.0  # 1.0 = pure streaming, 0.0 = pure chasing
    # Optional access distribution over the object's byte range: relative
    # weights over equal-width bins (skewed workloads — power-law adjacency,
    # sliding KV hot windows).  None = uniform.  Drives both the simulated
    # physics (per-chunk service times) and, via ``PhaseTraceEvent.
    # access_bins``, the runtime's per-chunk attribution.
    density: Optional[Sequence[float]] = None


@dataclasses.dataclass
class SimPhaseSpec:
    name: str
    compute_s: float                       # non-memory compute time
    touches: Dict[str, SimObjectAccess]    # obj -> access descriptor

    def true_accesses(self) -> Dict[str, float]:
        return {o: a.accesses for o, a in self.touches.items()}


@dataclasses.dataclass
class SimWorkload:
    name: str
    phases: List[SimPhaseSpec]
    objects: Dict[str, int]                # obj -> size bytes
    chunkable: Dict[str, bool] = dataclasses.field(default_factory=dict)

    def static_ref_counts(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for ph in self.phases:
            for o, a in ph.touches.items():
                out[o] = out.get(o, 0.0) + a.accesses
        return out


@dataclasses.dataclass
class PhaseExec:
    """One dynamic phase execution in virtual time (trace for tests)."""

    iteration: int
    phase_index: int
    start: float                 # virtual time phase_begin was entered
    stall_s: float               # fence stall absorbed before compute
    duration_s: float            # phase execution time (post-stall)

    @property
    def compute_start(self) -> float:
        return self.start + self.stall_s

    @property
    def end(self) -> float:
        return self.start + self.stall_s + self.duration_s


@dataclasses.dataclass
class SimResult:
    iteration_times: List[float]
    total_time: float
    stats: Dict[str, object]
    phase_trace: List[PhaseExec] = dataclasses.field(default_factory=list)

    @property
    def steady_iteration_time(self) -> float:
        tail = self.iteration_times[len(self.iteration_times) // 2:]
        return sum(tail) / len(tail)

    @property
    def total_stall_s(self) -> float:
        return sum(p.stall_s for p in self.phase_trace)


class SimSource:
    """Density-driven simulated instrumentation (the physics, migrated out
    of the engine so any driver — or the parity tests — can consume the
    exact event stream the simulator produces).

    ``collect`` returns the phase's true access counts, PEBS-like per-object
    time shares, each skewed object's true address histogram, and the
    simulated phase duration as ``elapsed`` (virtual time)."""

    #: fraction of the smaller of (compute, memory) that cannot be hidden —
    #: out-of-order cores overlap most memory stalls with compute (MLP); 1.0
    #: would be fully serialized, 0.0 perfectly overlapped.
    serialization = 0.25

    def __init__(self, machine: MachineProfile, workload: SimWorkload,
                 registry: ObjectRegistry):
        self.machine = machine
        self.workload = workload
        self.registry = registry
        self._specs = {ph.name: ph for ph in workload.phases}
        if len(self._specs) != len(workload.phases):
            # phases are name-keyed through the session API; a duplicate
            # would silently collapse onto the last spec's physics
            dupes = sorted({ph.name for i, ph in enumerate(workload.phases)
                            if any(q.name == ph.name
                                   for q in workload.phases[:i])})
            raise ValueError(
                f"workload {workload.name!r} has duplicate phase names "
                f"{dupes}; phase names must be unique")

    def phase_time(self, ph: SimPhaseSpec) -> Tuple[float, Dict[str, float]]:
        """Returns (total_time, {logical_obj_name: memory_time})."""
        mem = 0.0
        obj_times: Dict[str, float] = {}
        line = self.machine.cacheline_bytes
        for name, acc in ph.touches.items():
            parts: List[tuple] = []
            if name in self.registry:
                parts.append((self.registry[name], acc.accesses))
            else:
                # partitioned: distribute accesses over chunks by the true
                # access density (uniform = by size) — the simulated ground
                # truth the profiler's sampled attribution approximates
                spans = chunk_spans(self.registry, name)
                total = sum(c.size_bytes for c, _, _ in spans) or 1
                if acc.density is None:
                    for c, _, _ in spans:
                        parts.append((c, acc.accesses * c.size_bytes / total))
                else:
                    masses = [bin_mass(acc.density, lo / total, hi / total)
                              for _, lo, hi in spans]
                    norm = sum(masses) or 1.0
                    for (c, _, _), m in zip(spans, masses):
                        parts.append((c, acc.accesses * m / norm))
            for obj, n_acc in parts:
                tier = (self.machine.fast if obj.tier == "fast"
                        else self.machine.slow)
                stream_t = (n_acc * acc.stream_fraction * line) / tier.bw
                chase_t = n_acc * (1.0 - acc.stream_fraction) * tier.lat
                obj_times[obj.name] = obj_times.get(obj.name, 0.0) \
                    + stream_t + chase_t
                mem += stream_t + chase_t
        t = max(ph.compute_s, mem) \
            + self.serialization * min(ph.compute_s, mem)
        return t, obj_times

    def collect(self, phase_name: str) -> PhaseSample:
        ph = self._specs[phase_name]
        t_phase, obj_times = self.phase_time(ph)
        # PEBS-like attribution: per-object share of phase time, plus each
        # skewed object's true address histogram (the profiler resamples it
        # with multinomial noise).
        shares: Dict[str, float] = {}
        for name in ph.touches:
            tt = sum(v for k, v in obj_times.items()
                     if k == name or k.startswith(name + "#"))
            shares[name] = tt / t_phase if t_phase > 0 else 0.0
        bins = {name: acc.density for name, acc in ph.touches.items()
                if acc.density is not None}
        return PhaseSample(accesses=ph.true_accesses(), time_shares=shares,
                           access_bins=bins or None, elapsed=t_phase)


class SimulationEngine:
    """Runs a SimWorkload for N iterations under a placement policy.

    ``runtime=None`` simulates a *static* placement (whatever tiers the
    registry currently holds) — used for DRAM-only / NVM-only / offline-
    profiling baselines.  With a runtime (a v2 :class:`Session` or the
    ``UnimemRuntime`` facade), iteration 1 profiles and later iterations
    follow the Unimem plan with proactive movement.
    """

    def __init__(self, machine: MachineProfile, workload: SimWorkload,
                 runtime: Optional[Session] = None,
                 registry: Optional[ObjectRegistry] = None):
        self.machine = machine
        self.workload = workload
        self.clock = 0.0
        if runtime is not None:
            self.runtime = runtime
            self.registry = runtime.registry
            # swap in a simulated copy engine wired to our clock, resolved
            # from the backend registry and matched to the runtime's
            # configured migration engine
            backend = make_backend(
                "sim", machine, now_fn=lambda: self.clock,
                mover=runtime.config.mover,
                channels=runtime.config.copy_channels,
                priorities=getattr(runtime.config,
                                   "copy_channel_priorities", None))
            fault_spec = getattr(runtime.config, "fault_spec", None)
            if fault_spec is not None:
                # chaos rides the clock-wired sim engine: the configured
                # fault profile is re-applied to the swapped-in backend
                from ..core.faults import ChaosBackend
                backend = ChaosBackend(backend, fault_spec,
                                       host=getattr(runtime.config, "host",
                                                    None))
            self.runtime.backend = backend
            if self.runtime.mover is not None:
                self.runtime.mover.backend = backend
        else:
            self.runtime = None
            self.registry = registry if registry is not None else ObjectRegistry()
            if registry is None:
                for name, size in workload.objects.items():
                    self.registry.alloc(name, size)
        self.source = SimSource(machine, workload, self.registry)
        if self.runtime is not None:
            self.runtime.attach_source(self.source)

    # ------------------------------------------------------------------
    def object_tier(self, name: str):
        # chunked objects: registry holds name#k chunks
        if name in self.registry:
            return self.registry[name].tier
        return None

    def phase_time(self, ph: SimPhaseSpec) -> tuple:
        return self.source.phase_time(ph)

    # ------------------------------------------------------------------
    def run(self, n_iterations: int) -> SimResult:
        iter_times: List[float] = []
        trace: List[PhaseExec] = []
        for it in range(n_iterations):
            t_iter = 0.0
            if self.runtime is not None:
                with self.runtime.iteration():
                    for i, ph in enumerate(self.workload.phases):
                        t_enter = self.clock
                        with self.runtime.phase(ph.name) as pc:
                            pass        # the SimSource supplies the physics
                        trace.append(PhaseExec(it, i, t_enter, pc.stall_s,
                                               pc.elapsed))
                        self.clock += pc.stall_s + pc.elapsed
                        t_iter += pc.stall_s + pc.elapsed
            else:
                for i, ph in enumerate(self.workload.phases):
                    t_enter = self.clock
                    t_phase, _ = self.source.phase_time(ph)
                    trace.append(PhaseExec(it, i, t_enter, 0.0, t_phase))
                    self.clock += t_phase
                    t_iter += t_phase
            iter_times.append(t_iter)
        stats = self.runtime.stats() if self.runtime is not None else {}
        return SimResult(iter_times, sum(iter_times), stats, trace)


# ---------------------------------------------------------------------------
# calibration micro-workloads (STREAM / pointer-chasing analogues, §3.1.2)
# ---------------------------------------------------------------------------
def simulate_stream_time(machine: MachineProfile, n_bytes: int,
                         tier: str = "fast") -> float:
    t = machine.fast if tier == "fast" else machine.slow
    return n_bytes / t.bw


def simulate_chase_time(machine: MachineProfile, n_accesses: int,
                        tier: str = "fast") -> float:
    t = machine.fast if tier == "fast" else machine.slow
    return n_accesses * t.lat
