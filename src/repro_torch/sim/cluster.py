"""N-virtual-host cluster simulation over the two-tier engine.

Extends the single-machine simulator (``sim/engine.py``) to a cluster of
N virtual hosts, each with its own DRAM/NVM pair, virtual clock, session
and registry — tier-1 speed, no hardware.  A :class:`ShardedWorkload`
describes the global job (movable shard objects with a home assignment,
plus per-host replicated ``shared`` objects like the dense trunk and the
router) and materializes each host's :class:`~.engine.SimWorkload` by
filtering phase touches to the objects the host holds; per-object
compute follows the object, so re-homing a hot expert moves both its
memory traffic and its FLOPs to the new host.

:class:`ClusterSimulation` then runs the cluster two ways:

* ``run_local_only`` — every host manages its own shard with the full
  session pipeline, no coordination (the baseline);
* ``run_coordinated`` — a short probe stage profiles each host, the
  :class:`~..distributed.ClusterCoordinator` plans a rebalance
  (local NVM->DRAM promotion vs. peer pull per surplus hot shard),
  migrations execute in virtual time on the registered ``"cross_host"``
  backend over the modeled interconnect links, and a steady stage re-runs
  the cluster under the new shard assignment.

Hosts run with *independent* virtual clocks, so the engine may execute
them in any order (sequentially, or interleaved iteration-by-iteration)
without changing any host's trace — per-host chaos RNG sub-streams
(:func:`~..core.faults.host_sub_seed`) keep fault injection
deterministic per host regardless of scheduling order.

``moe_churn_multihost`` is the gated scenario: one host's expert shard
goes hot past its DRAM capacity after router churn while peers sit on
spare capacity; coordinator rebalance must beat host-local-only
management by >= 1.10x steady time on the hot host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.perfmodel import (CalibrationConstants, InterconnectModel,
                              LinkSpec, calibrate)
from ..core.policy import PlanProgram
from ..core.runtime import UnimemRuntime
from ..core.session import RuntimeConfig
from ..core.tiers import PAPER_DRAM_NVM, MachineProfile
from ..distributed.coordinator import (ClusterCoordinator, HostTierManager,
                                       ShardMigration)
from .engine import (SimObjectAccess, SimPhaseSpec, SimResult, SimWorkload,
                     SimulationEngine)

MB = 1024 ** 2
LINE = 64


# ---------------------------------------------------------------------------
# sharded workload description
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardPhaseSpec:
    """A global phase template: base compute plus per-object touches whose
    compute contribution travels with the object when it is re-homed."""

    name: str
    base_compute_s: float
    touches: Dict[str, SimObjectAccess]
    obj_compute_s: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ShardedWorkload:
    """The global job: movable shards with a home assignment plus per-host
    replicated objects (every host holds its own copy of each ``shared``
    object — they are never migration candidates)."""

    name: str
    phases: List[ShardPhaseSpec]
    objects: Dict[str, int]            # movable shard -> size bytes
    shared: Dict[str, int]             # replicated per host -> size bytes
    assignment: Dict[str, str]         # shard -> home host
    chunkable: Dict[str, bool] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        missing = sorted(set(self.objects) - set(self.assignment))
        if missing:
            raise ValueError(f"shards with no home host: {missing}")
        overlap = sorted(set(self.objects) & set(self.shared))
        if overlap:
            raise ValueError(f"objects both movable and shared: {overlap}")

    def hosts(self) -> List[str]:
        return sorted(set(self.assignment.values()))

    def host_workload(self, host: str,
                      assignment: Optional[Dict[str, str]] = None
                      ) -> SimWorkload:
        """This host's SimWorkload under ``assignment`` (default: the home
        assignment): its shards plus its replicas of the shared objects,
        phases filtered to present objects, per-object compute included
        for the objects the host actually holds."""
        asg = assignment if assignment is not None else self.assignment
        objs = {o: s for o, s in self.objects.items() if asg.get(o) == host}
        objs.update(self.shared)
        phases = []
        for ph in self.phases:
            touches = {o: a for o, a in ph.touches.items() if o in objs}
            compute = ph.base_compute_s + sum(
                c for o, c in ph.obj_compute_s.items() if o in objs)
            phases.append(SimPhaseSpec(ph.name, compute, touches))
        return SimWorkload(f"{self.name}@{host}", phases, objs,
                           {o: self.chunkable.get(o, False) for o in objs})


# ---------------------------------------------------------------------------
# cluster runner
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClusterResult:
    """One cluster run: per-host simulation results plus (for coordinated
    runs) the migration record and the aggregated global plan."""

    host_results: Dict[str, SimResult]
    assignment: Dict[str, str]
    migrations: List[ShardMigration] = dataclasses.field(default_factory=list)
    migration_s: float = 0.0
    program: Optional[PlanProgram] = None
    probe_results: Dict[str, SimResult] = dataclasses.field(
        default_factory=dict)

    def steady_time(self, host: str) -> float:
        return self.host_results[host].steady_iteration_time

    @property
    def cluster_steady_time(self) -> float:
        """Cluster iteration time = the slowest host (hosts run in
        parallel on independent clocks)."""
        return max(r.steady_iteration_time
                   for r in self.host_results.values())


class ClusterSimulation:
    """Two-stage cluster runner over per-host sessions (module docstring).

    Each host's session is constructed exactly as the single-machine
    harness builds one (same ``RuntimeConfig`` knobs, same registration
    order) plus the ``host=`` provenance tag — a one-host cluster is
    therefore bit-identical to the unclustered path."""

    def __init__(self, machine: MachineProfile, workload: ShardedWorkload,
                 links: Optional[InterconnectModel] = None,
                 fast_capacity_bytes: Optional[int] = None,
                 config: Optional[RuntimeConfig] = None,
                 cf: Optional[CalibrationConstants] = None,
                 mover: str = "slack", amortize_iters: float = 5.0,
                 min_heat_s: float = 0.0, **config_kw):
        self.machine = machine
        self.workload = workload
        self.links = links or InterconnectModel()
        self.cf = cf or calibrate(machine)
        self.amortize_iters = amortize_iters
        self.min_heat_s = min_heat_s
        if config is not None:
            if mover != "slack" or config_kw or fast_capacity_bytes is not None:
                raise ValueError("pass knobs either via config= or as "
                                 "keyword arguments, not both")
            self._config = config
        else:
            self._config = RuntimeConfig(
                fast_capacity_bytes=fast_capacity_bytes, mover=mover,
                **config_kw)

    # ------------------------------------------------------------------
    def _build(self, assignment: Dict[str, str]
               ) -> Tuple[ClusterCoordinator, Dict[str, SimulationEngine]]:
        """One manager + engine per host, mirroring the single-machine
        harness construction object-for-object."""
        managers: List[HostTierManager] = []
        engines: Dict[str, SimulationEngine] = {}
        for host in self.workload.hosts():
            cfg = dataclasses.replace(self._config, host=host)
            rt = UnimemRuntime(self.machine, cfg, cf=self.cf)
            wl = self.workload.host_workload(host, assignment)
            statics = wl.static_ref_counts()
            for n, s in wl.objects.items():
                rt.register(n, s, chunkable=wl.chunkable.get(n, False),
                            static_refs=statics.get(n))
            managers.append(HostTierManager(host, self.machine, session=rt))
            engines[host] = SimulationEngine(self.machine, wl, runtime=rt)
        coord = ClusterCoordinator(managers, self.links,
                                   amortize_iters=self.amortize_iters,
                                   min_heat_s=self.min_heat_s)
        return coord, engines

    @staticmethod
    def run_hosts(engines: Dict[str, SimulationEngine], n: int,
                  interleave: bool = False) -> Dict[str, SimResult]:
        """Run every host for ``n`` iterations.  Hosts have independent
        virtual clocks, so host-major and iteration-major (interleaved)
        scheduling must produce identical per-host results — the
        determinism property the chaos sub-seed test pins."""
        if not interleave:
            return {h: engines[h].run(n) for h in sorted(engines)}
        partial: Dict[str, List[SimResult]] = {h: [] for h in engines}
        for _ in range(n):
            for h in sorted(engines):
                partial[h].append(engines[h].run(1))
        out: Dict[str, SimResult] = {}
        for h, parts in partial.items():
            iter_times = [t for p in parts for t in p.iteration_times]
            # each run(1) restarts its local iteration counter; renumber
            # so the stitched trace matches a host-major run exactly
            trace = [dataclasses.replace(e, iteration=j)
                     for j, p in enumerate(parts) for e in p.phase_trace]
            out[h] = SimResult(iter_times, sum(iter_times),
                               parts[-1].stats, trace)
        return out

    # ------------------------------------------------------------------
    def run_local_only(self, n_iterations: int,
                       interleave: bool = False) -> ClusterResult:
        """Baseline: every host manages its shard alone, no coordinator."""
        _, engines = self._build(self.workload.assignment)
        results = self.run_hosts(engines, n_iterations, interleave)
        return ClusterResult(results, dict(self.workload.assignment))

    def run_coordinated(self, n_iterations: int, profile_iters: int = 4,
                        interleave: bool = False) -> ClusterResult:
        """Probe -> rebalance -> migrate (virtual time) -> steady stage
        under the new assignment."""
        coord, engines = self._build(self.workload.assignment)
        probe = self.run_hosts(engines, profile_iters, interleave)
        migrations = coord.plan_rebalance()
        clock = [max(e.clock for e in engines.values())]
        backend = coord.make_backend(now_fn=lambda: clock[0])
        migration_s, _ = coord.execute_migrations(
            migrations, backend, now=clock[0])
        assignment = dict(self.workload.assignment)
        for mig in migrations:
            if mig.mode == "cross_host":
                assignment[mig.obj] = mig.dst_host
        coord2, engines2 = self._build(assignment)
        results = self.run_hosts(engines2, n_iterations, interleave)
        return ClusterResult(results, assignment, migrations, migration_s,
                             coord2.aggregate_program(migrations), probe)


# ---------------------------------------------------------------------------
# gated scenario: MoE expert churn across hosts
# ---------------------------------------------------------------------------
def _acc(size_bytes: int, passes: float, stream: float) -> SimObjectAccess:
    return SimObjectAccess(accesses=passes * size_bytes / LINE,
                           stream_fraction=stream)


def moe_churn_multihost(n_hosts: int = 4, experts_per_host: int = 4,
                        expert_mb: int = 40, trunk_mb: int = 64,
                        router_mb: int = 4, hot_host: str = "h0",
                        hot_passes: float = 3.0):
    """MoE serving after router churn: every host owns ``experts_per_host``
    expert shards plus a replicated dense trunk and router, and the
    router's traffic has collapsed onto ``hot_host``'s experts — its whole
    shard is hot past DRAM capacity while peers' experts go idle, leaving
    them spare capacity.  The hot host can keep only part of its shard
    fast; the coordinator should pull the surplus hot experts to peers.

    Returns ``(machine, workload, links, knobs)`` where ``knobs`` are the
    :class:`ClusterSimulation` keyword arguments the scenario was tuned
    for (fast capacity below the hot shard's demand, >= one expert of
    spare per peer; link pricing that amortizes within a few iterations).
    """
    machine = PAPER_DRAM_NVM
    hosts = [f"h{i}" for i in range(n_hosts)]
    expert_b, trunk_b, router_b = (expert_mb * MB, trunk_mb * MB,
                                   router_mb * MB)
    objects: Dict[str, int] = {}
    assignment: Dict[str, str] = {}
    expert_touch: Dict[str, SimObjectAccess] = {}
    expert_compute: Dict[str, float] = {}
    for h in hosts:
        for k in range(experts_per_host):
            name = f"{h}/expert{k}"
            objects[name] = expert_b
            assignment[name] = h
            if h == hot_host:
                # all router traffic lands here after the churn
                expert_touch[name] = _acc(expert_b, hot_passes, 0.9)
                expert_compute[name] = 0.004
    shared = {"trunk": trunk_b, "router": router_b}
    phases = [
        ShardPhaseSpec("route", 0.002,
                       {"router": _acc(router_b, 2.0, 0.1),
                        "trunk": _acc(trunk_b, 1.5, 0.9)}),
        ShardPhaseSpec("experts", 0.002, dict(expert_touch),
                       obj_compute_s=dict(expert_compute)),
    ]
    wl = ShardedWorkload("moe_churn_multihost", phases, objects, shared,
                         assignment)
    links = InterconnectModel(
        default=LinkSpec("icl", bandwidth=3e9, latency=10e-6,
                         channel_pairs=2))
    knobs = dict(fast_capacity_bytes=120 * MB, amortize_iters=5.0,
                 min_heat_s=2e-3)
    return machine, wl, links, knobs
