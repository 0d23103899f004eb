"""Multi-host tier management: per-shard tier managers + cluster coordinator.

Unimem runs one runtime instance per MPI rank and keeps data-management
decisions coordinated so migration never introduces load imbalance
(paper §3.3); production models are sharded across hosts, so
the reproduction's single DRAM/NVM session becomes the *per-host shard
manager* and this module adds the layer above it:

* :class:`HostTierManager` — one existing :class:`~..core.Session`
  (the full pipeline: profile -> plan -> slack-aware movement ->
  monitor) managing one host's shard over its own DRAM/NVM pair, with
  host provenance threaded through its plan stage records, fault log and
  ``stats()`` (``RuntimeConfig.host``).
* :class:`ClusterCoordinator` — aggregates the per-shard profiles into a
  global :class:`~..core.PlanProgram` with per-host residency
  sections, and decides *shard re-homing*: when one host's shard goes
  hot past its fast-tier capacity, the coordinator compares **local
  NVM->DRAM promotion** (Eq. (4) against the host's copy engine, only
  feasible while local fast capacity remains) against **pulling the hot
  shard to a peer host** (priced per interconnect link by
  :func:`~..core.perfmodel.cross_host_cost`), and emits the chosen
  :class:`ShardMigration` list.  Cross-host pulls execute on the
  registered ``"cross_host"`` backend (send/recv channel pairs per
  link); when several destinations contend for one source host's egress
  the link's channel pairs are split by bytes-demand with the shared
  largest-remainder :func:`~..core.tenancy.apportion` helper.

A one-host cluster degenerates exactly to the unclustered session: no
peers means no migration candidates, and the per-host manager *is* the
single-host runtime — plans and virtual-time traces are bit-identical.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from ..core import backends as backends_mod
from ..core.perfmodel import (CalibrationConstants, InterconnectModel,
                              benefit, cross_host_cost, movement_cost)
from ..core.policy import PlanProgram, StageProvenance
from ..core.session import RuntimeConfig, Session
from ..core.tenancy import apportion
from ..core.tiers import MachineProfile


@dataclasses.dataclass(frozen=True)
class ShardMigration:
    """One coordinator decision for a surplus hot shard.

    ``mode`` records which side of the promotion-vs-pull choice won:
    ``"cross_host"`` re-homes the shard to ``dst_host`` over ``link``
    (``est_cost_s`` = the Eq. (4)-style unhidden link cost),
    ``"local_promote"`` keeps it on ``src_host`` and defers to the local
    planner's NVM->DRAM promotion (recorded so the global program shows
    the choice was *made*, not skipped)."""

    obj: str
    src_host: str
    dst_host: str
    size_bytes: int
    mode: str                   # "cross_host" | "local_promote"
    est_cost_s: float           # one-time migration cost (unhidden)
    est_benefit_s: float        # per-iteration benefit once re-homed
    link: str = ""              # pricing link name ("" for local)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class HostTierManager:
    """One host's shard manager: an ordinary session over the host's own
    DRAM/NVM pair, tagged with the host id so every plan stage record,
    fault event and stats() row carries host provenance."""

    def __init__(self, host: str, machine: MachineProfile,
                 config: Optional[RuntimeConfig] = None,
                 cf: Optional[CalibrationConstants] = None,
                 session: Optional[Session] = None):
        self.host = host
        self.machine = machine
        if session is not None:
            if session.config.host != host:
                raise ValueError(
                    f"manager for {host!r} got a session tagged "
                    f"{session.config.host!r}; set RuntimeConfig.host so "
                    "provenance matches")
            self.session = session
        else:
            cfg = (dataclasses.replace(config, host=host)
                   if config is not None else RuntimeConfig(host=host))
            self.session = Session(machine, cfg, cf=cf)

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.session.capacity

    def fast_demand_bytes(self) -> int:
        """Bytes the host's trafficked shards want resident."""
        return sum(self.session.registry[o].size_bytes
                   for o in self.shard_heat()
                   if o in self.session.registry)

    def shard_heat(self) -> Dict[str, float]:
        """Per-shard Eq. (1)-(3) benefit (seconds/iteration if served
        from fast instead of slow), summed over the profiled phases —
        the coordinator's common currency for cross-host comparison."""
        s = self.session
        heat: Dict[str, float] = {}
        if s.graph is None:
            return heat
        for ph in s.graph:
            for o, v in ph.refs.items():
                if v <= 0.0 or o not in s.registry:
                    continue
                p = s.profiler.profile(ph.index, o)
                if p is None:
                    continue
                heat[o] = heat.get(o, 0.0) + max(
                    0.0, benefit(p, s.machine, s.cf))
        return heat

    def stats(self) -> Dict[str, Any]:
        return self.session.stats()

    def __repr__(self) -> str:
        return f"HostTierManager({self.host!r}, {len(self.session.registry)} objects)"


class ClusterCoordinator:
    """Aggregates per-host tier managers into one global plan and decides
    cross-host shard migration (see module docstring).

    ``amortize_iters`` is the pull threshold: a cross-host migration is
    worth it when its one-time link cost is recovered within that many
    iterations of per-iteration benefit (the coordinator analogue of the
    planner's Eq. (5) weight staying positive over a plan epoch)."""

    def __init__(self, hosts: List[HostTierManager],
                 links: Optional[InterconnectModel] = None,
                 amortize_iters: float = 5.0, min_heat_s: float = 0.0):
        if not hosts:
            raise ValueError("a cluster needs at least one host manager")
        names = [m.host for m in hosts]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate host ids in cluster: {names}")
        self.hosts = list(hosts)
        self.links = links or InterconnectModel()
        self.amortize_iters = amortize_iters
        # shards below this per-iteration benefit are background noise:
        # they neither count as fast-tier demand nor become migration
        # candidates (Unimem's negligible-benefit cutoff, cluster level)
        self.min_heat_s = min_heat_s

    def _replicated(self) -> set:
        """Object names present in more than one host's registry — per-host
        replicas (trunk/router); they occupy capacity everywhere but are
        never migration candidates."""
        seen: Dict[str, int] = {}
        for m in self.hosts:
            for name in m.session.registry.names():
                seen[name] = seen.get(name, 0) + 1
        return {n for n, c in seen.items() if c > 1}

    # ------------------------------------------------------------------
    def manager(self, host: str) -> HostTierManager:
        for m in self.hosts:
            if m.host == host:
                return m
        raise KeyError(f"unknown host {host!r}")

    # ----------------------------------------------------- rebalance decision
    def plan_rebalance(self, *, overlap_window: float = 0.0
                       ) -> List[ShardMigration]:
        """The promotion-vs-pull chooser.

        Per overloaded host (hot-shard demand above fast capacity), keep
        the locally densest shards (benefit per byte) up to capacity;
        for each surplus shard compare the two feasible options —
        promote locally into remaining spare fast bytes (Eq. (4) against
        the host's copy engine) vs. pull to the peer with the most spare
        capacity (per-link :func:`cross_host_cost`) — and take the
        cheaper feasible one.  A pull must also amortize: one-time link
        cost below ``amortize_iters x`` the shard's per-iteration
        benefit.  One host (no peers) trivially yields no migrations."""
        replicated = self._replicated()
        # demand = non-pinned shards worth managing (above the heat cutoff);
        # pinned bytes are pre-paid capacity, handled separately
        heat = {m.host: {o: g for o, g in m.shard_heat().items()
                         if g > self.min_heat_s
                         and not m.session.registry[o].pinned}
                for m in self.hosts}
        sizes = {m.host: {o: m.session.registry[o].size_bytes
                          for o in heat[m.host]}
                 for m in self.hosts}
        pinned = {m.host: sum(
            obj.size_bytes for obj in m.session.registry if obj.pinned)
            for m in self.hosts}
        # spare fast bytes a peer can lend = capacity - its own hot demand
        spare = {m.host: m.capacity - pinned[m.host]
                 - sum(sizes[m.host].values()) for m in self.hosts}
        migrations: List[ShardMigration] = []
        for m in sorted(self.hosts, key=lambda m: spare[m.host]):
            host = m.host
            if spare[host] >= 0:
                continue                    # everything hot fits locally
            # keep the densest shards up to capacity; the rest is surplus
            budget = m.capacity - pinned[host]
            ranked = sorted(heat[host],
                            key=lambda o: (-heat[host][o]
                                           / max(1, sizes[host][o]), o))
            surplus: List[str] = []
            for o in ranked:
                if sizes[host][o] <= budget:
                    budget -= sizes[host][o]
                else:
                    surplus.append(o)
            local_spare = max(0, budget)
            for o in sorted(surplus, key=lambda o: (-heat[host][o], o)):
                size, gain = sizes[host][o], heat[host][o]
                if gain <= 0.0 or o in replicated:
                    continue    # replicas live on every host; never re-homed
                # option A: local NVM->DRAM promotion (needs spare bytes)
                local_cost = (movement_cost(size, m.machine, overlap_window)
                              if size <= local_spare else None)
                # option B: pull to the peer with the most spare capacity
                peers = [p for p in self.hosts
                         if p.host != host and spare[p.host] >= size]
                pull_cost = pull_to = link_name = None
                if peers:
                    peer = max(peers, key=lambda p: (spare[p.host], p.host))
                    link = self.links.link(host, peer.host)
                    pull_cost = cross_host_cost(size, link, overlap_window)
                    pull_to, link_name = peer.host, link.name
                if local_cost is not None and (pull_cost is None
                                               or local_cost <= pull_cost):
                    migrations.append(ShardMigration(
                        o, host, host, size, "local_promote",
                        local_cost, gain))
                    local_spare -= size
                elif (pull_cost is not None
                      and pull_cost <= self.amortize_iters * gain):
                    migrations.append(ShardMigration(
                        o, host, pull_to, size, "cross_host",
                        pull_cost, gain, link=link_name))
                    spare[pull_to] -= size
        return migrations

    # ------------------------------------------------------------- execution
    def make_backend(self, now_fn=None, on_land=None):
        """The registered ``"cross_host"`` engine wired to this cluster's
        link table (``on_land`` defaults to the registry re-homing hook)."""
        machine = self.hosts[0].machine
        return backends_mod.make_backend(
            "cross_host", machine, links=self.links, now_fn=now_fn,
            on_land=on_land if on_land is not None else self.rehome)

    def rehome(self, copy: Any) -> None:
        """Land-time handoff for a cross-host copy: the shard leaves the
        source host's registry and joins the destination's in the copy's
        destination tier."""
        src = self.manager(copy.src_host).session.registry
        dst = self.manager(copy.dst_host).session.registry
        name = copy.obj.name
        if name in src:
            src.remove(name)
        if name not in dst:
            dst.alloc(name, copy.obj.size_bytes, tier=copy.dst)
        else:
            dst[name].tier = copy.dst

    def execute_migrations(self, migrations: List[ShardMigration],
                           backend: Any, now: float = 0.0
                           ) -> Tuple[float, List[Any]]:
        """Issue the cross-host pulls on the send/recv engine and settle.

        Each source host's egress link pairs are **apportioned across the
        destination hosts by bytes demand** (the shared largest-remainder
        helper's third call site): a destination granted ``k`` pairs runs
        at most ``k`` of its transfers concurrently, later ones chain
        behind earlier handles — several pulls to one peer cannot starve
        the others.  Returns (wall seconds until the last landing,
        handles)."""
        by_src: Dict[str, List[ShardMigration]] = defaultdict(list)
        for mig in migrations:
            if mig.mode == "cross_host":
                by_src[mig.src_host].append(mig)
        handles: List[Any] = []
        for src in sorted(by_src):
            migs = by_src[src]
            pairs = min(self.links.link(src, mig.dst_host).channel_pairs
                        for mig in migs)
            demand = defaultdict(int)
            for mig in migs:
                demand[mig.dst_host] += mig.size_bytes
            total = sum(demand.values()) or 1
            quota = {d: pairs * b / total for d, b in demand.items()}
            shares = apportion(pairs, quota)
            tails: Dict[Tuple[str, int], Any] = {}
            slot_rr: Dict[str, int] = defaultdict(int)
            for mig in sorted(migs, key=lambda g: (g.dst_host, g.obj)):
                slots = max(1, shares.get(mig.dst_host, 0))
                slot = slot_rr[mig.dst_host] % slots
                slot_rr[mig.dst_host] += 1
                obj = self.manager(src).session.registry[mig.obj]
                h = backend.start_move(
                    obj, "fast", src_host=src, dst_host=mig.dst_host,
                    after=tails.get((mig.dst_host, slot)))
                tails[(mig.dst_host, slot)] = h
                handles.append(h)
        if not handles:
            return 0.0, []
        done = max(h.done for h in handles)
        backend.settle(done)
        return max(0.0, done - now), handles

    # ------------------------------------------------------------ aggregation
    def aggregate_program(self, migrations: Optional[List[ShardMigration]]
                          = None) -> PlanProgram:
        """The global plan: per-host residency sections + the migration
        list, with every host's stage provenance (already host-stamped by
        the per-host pipelines) concatenated.  Cluster iteration time is
        the slowest host's (hosts run in parallel), so predicted/baseline
        are maxes, not sums."""
        sections: Dict[str, Any] = {}
        provenance: List[StageProvenance] = []
        predicted = baseline = 0.0
        capacity = 0
        for m in self.hosts:
            plan, s = m.session.plan, m.session
            sec: Dict[str, Any] = dict(
                capacity_bytes=s.capacity,
                n_objects=len(s.registry),
                fast_resident_bytes=s.registry.bytes_in_tier("fast"))
            if plan is not None:
                sec.update(
                    strategy=plan.strategy,
                    predicted_iteration_time=plan.predicted_iteration_time,
                    baseline_iteration_time=plan.baseline_iteration_time,
                    residents=[sorted(r) for r in plan.residents],
                    n_moves=len(plan.moves))
                predicted = max(predicted, plan.predicted_iteration_time)
                baseline = max(baseline, plan.baseline_iteration_time)
                if isinstance(plan, PlanProgram):
                    provenance.extend(plan.provenance)
            sections[m.host] = sec
            capacity += s.capacity
        return PlanProgram(
            strategy="cluster", residents=[], moves=[],
            predicted_iteration_time=predicted,
            baseline_iteration_time=baseline,
            policy="cluster", provenance=provenance,
            capacity_bytes=capacity, host_sections=sections,
            migrations=[mig.to_dict() for mig in (migrations or [])])

    def stats(self) -> Dict[str, Any]:
        """Cluster rollup: per-host sections plus cross-host counters."""
        per_host = {m.host: m.stats() for m in self.hosts}
        return dict(
            n_hosts=len(self.hosts),
            hosts=per_host,
            n_moves=sum(s["n_moves"] for s in per_host.values()),
            moved_bytes=sum(s["moved_bytes"] for s in per_host.values()),
            n_degraded_serves=sum(s["n_degraded_serves"]
                                  for s in per_host.values()),
            n_replans=sum(s["n_replans"] for s in per_host.values()),
        )
