"""Multi-tenant serving layer: namespaces, QoS weights, resource shares.

The runtime plans placement for one workload; production serving
multiplexes many concurrent request streams — tenants — with different
hot sets over one fast tier and one set of copy channels.  This module
is the shared vocabulary that threads tenancy through every layer:

* :class:`TenantSpec` / :class:`TenantHandle` — a tenant's QoS contract
  (priority, SLO) and the session-scoped registration namespace
  (``rt.tenant("a").register("kv", ...)`` registers ``"a/kv"``; the
  registry's duplicate check then rejects same-tenant duplicates while
  cross-tenant name collisions resolve to distinct qualified names).
* :func:`tenant_of` — ownership attribution for any object or phase
  name, chunk-suffix aware (``"a/kv#3"`` belongs to tenant ``"a"``).
* :func:`apportion` — the shared largest-remainder integerization
  kernel (optionally demand-capped) behind both share functions and the
  cluster coordinator's link-share splits.
* :func:`capacity_shares` — work-conserving weighted water-filling of
  fast-tier bytes across tenants: each tenant's share is proportional
  to its QoS weight but capped at its demand, and capacity a sated
  tenant cannot use is redistributed to the still-hungry ones, so the
  shares always sum to ``min(capacity, total demand)``.
* :func:`channel_shares` — largest-remainder apportionment of the copy
  channels by the same weights (every channel is owned by exactly one
  tenant; tenants borrow idle foreign channels work-conservingly at the
  backend, see ``ChannelSimBackend.start_move(prefer=...)``).
* :func:`admission_control` — demote cold or hopelessly over-quota
  tenants to serve-from-slow before the per-tenant solves run, so a
  whale cannot thrash the long tail's hot set (the ``DegradedServe``
  provenance records every demotion).
* :func:`per_tenant_p99` — the serving metric: per-tenant p99 of the
  per-iteration time attributed to the tenant's phases.

Everything here is pure bookkeeping over names and numbers — no
session, planner, or backend state — so the policy, mover, benchmarks
and tests can all consume one implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

#: separator between a tenant namespace and the object/phase name it owns
TENANT_SEP = "/"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS contract.

    ``priority`` scales the tenant's claim on contested resources
    linearly; ``slo`` is its relative latency budget (1.0 = baseline,
    0.5 = twice as strict).  The partitioning weight is
    ``priority / slo`` — a stricter SLO buys a larger share at equal
    priority."""

    name: str
    priority: float = 1.0
    slo: float = 1.0

    def __post_init__(self):
        if not self.name or TENANT_SEP in self.name or "#" in self.name:
            raise ValueError(
                f"invalid tenant name {self.name!r}: must be non-empty and "
                f"contain neither {TENANT_SEP!r} nor '#'")
        if self.priority <= 0 or self.slo <= 0:
            raise ValueError(
                f"tenant {self.name!r}: priority and slo must be positive")

    @property
    def weight(self) -> float:
        return self.priority / self.slo


def qualify(tenant: str, name: str) -> str:
    """The tenant-qualified registry/phase name."""
    return f"{tenant}{TENANT_SEP}{name}"


def tenant_of(name: str,
              tenants: Optional[Mapping[str, Any]] = None) -> Optional[str]:
    """The tenant owning ``name``, or None for an unqualified name.

    Chunk names inherit their parent's tenant (``"a/kv#3"`` -> ``"a"``).
    With ``tenants`` given, only prefixes naming a registered tenant
    count — an object that merely contains the separator stays unowned.
    """
    base = name.split("#", 1)[0]
    if TENANT_SEP not in base:
        return None
    t = base.split(TENANT_SEP, 1)[0]
    if tenants is not None and t not in tenants:
        return None
    return t or None


class TenantHandle:
    """Session-scoped tenant namespace: ``register``/``phase`` qualify
    their names with the tenant prefix, everything else passes through.
    Obtained from :meth:`~.session.Session.tenant`."""

    def __init__(self, session: Any, spec: TenantSpec):
        self.session = session
        self.spec = spec

    @property
    def name(self) -> str:
        return self.spec.name

    def register(self, name: str, spec: Any = None, **kw: Any):
        return self.session.register(qualify(self.spec.name, name), spec,
                                     **kw)

    def phase(self, name: str, **kw: Any):
        return self.session.phase(qualify(self.spec.name, name), **kw)

    def iteration(self):
        return self.session.iteration()

    def __repr__(self) -> str:
        return (f"TenantHandle({self.spec.name!r}, "
                f"priority={self.spec.priority:g}, slo={self.spec.slo:g})")


# ---------------------------------------------------------------------------
# resource partitioning
# ---------------------------------------------------------------------------
def apportion(total: int, quotas: Mapping[str, float],
              caps: Optional[Mapping[str, int]] = None) -> Dict[str, int]:
    """Largest-remainder integerization of fractional quotas.

    Floors every quota, then hands the leftover units one at a time to
    the largest fractional remainders (ties break by name, so the result
    is deterministic).  With ``caps`` given, no key is floored or topped
    up past its cap and the leftover is distributed round-robin over the
    remainder ordering until either the total is reached or every key is
    capped — so conservation holds exactly whenever the caps admit it:
    ``sum(out) == min(total, sum(caps))``, and without caps
    ``sum(out) == total`` (for ``total >= 0``).

    This is the one shared apportionment kernel behind
    :func:`capacity_shares` (byte shares capped at demand),
    :func:`channel_shares` (copy-channel counts, uncapped) and the
    cluster coordinator's link-share splits
    (:meth:`~repro.distributed.coordinator.ClusterCoordinator`).
    """
    keys = list(quotas)
    out = {k: int(quotas[k]) for k in keys}
    if caps is not None:
        out = {k: min(max(0, int(caps.get(k, 0))), out[k]) for k in keys}
    leftover = int(total) - sum(out.values())
    by_frac = sorted(keys, key=lambda k: (-(quotas[k] - out[k]), k))
    if caps is None:
        for k in by_frac:
            if leftover <= 0:
                break
            out[k] += 1
            leftover -= 1
        return out
    i = 0
    while leftover > 0 and by_frac:
        k = by_frac[i % len(by_frac)]
        if out[k] < caps.get(k, 0):
            out[k] += 1
            leftover -= 1
        i += 1
        if i > 2 * len(by_frac) and all(
                out[k] >= caps.get(k, 0) for k in by_frac):
            break
    return out


def capacity_shares(capacity_bytes: int,
                    tenants: Mapping[str, TenantSpec],
                    demand: Mapping[str, int]) -> Dict[str, int]:
    """Work-conserving weighted water-filling of the fast tier.

    Each round distributes the remaining capacity across the still-hungry
    tenants proportionally to weight, capped at each tenant's remaining
    demand; sated tenants leave the pool and their surplus is
    redistributed.  Terminates in <= len(tenants)+1 rounds (every round
    either sates a tenant or exhausts the capacity).  The integerized
    shares satisfy ``sum(shares) == min(capacity, sum(demand))`` exactly
    (largest-remainder rounding), and no share exceeds its demand."""
    need = {t: max(0, int(demand.get(t, 0))) for t in tenants}
    shares = {t: 0.0 for t in tenants}
    remaining = float(max(0, capacity_bytes))
    active = {t for t in tenants if need[t] > 0}
    while remaining > 1e-9 and active:
        wsum = sum(tenants[t].weight for t in active)
        alloc = {t: remaining * tenants[t].weight / wsum for t in active}
        spent = 0.0
        sated = set()
        for t in sorted(active):
            give = min(alloc[t], need[t] - shares[t])
            shares[t] += give
            spent += give
            if shares[t] >= need[t] - 1e-6:
                sated.add(t)
        remaining -= spent
        active -= sated
        if spent <= 1e-12:
            break
    # integerize exactly: floor, then hand the leftover bytes to the
    # largest fractional remainders (never past a tenant's demand)
    target = min(max(0, int(capacity_bytes)), sum(need.values()))
    return apportion(target, shares, caps=need)


def channel_shares(n_channels: int,
                   tenants: Mapping[str, TenantSpec]) -> Dict[str, List[int]]:
    """Largest-remainder apportionment of the copy channels by weight.

    Every channel is owned by exactly one tenant (the lists partition
    ``range(n_channels)``); a tenant whose quota rounds to zero owns no
    channel and simply uses whatever is idle (the backend's
    work-conserving borrow rule).  Deterministic: ties break by name."""
    if not tenants or n_channels <= 0:
        return {t: [] for t in tenants}
    wsum = sum(s.weight for s in tenants.values())
    quota = {t: n_channels * s.weight / wsum for t, s in tenants.items()}
    counts = apportion(n_channels, quota)
    out: Dict[str, List[int]] = {t: [] for t in tenants}
    ch = 0
    for t in sorted(tenants, key=lambda t: (-counts[t], t)):
        for _ in range(counts[t]):
            out[t].append(ch)
            ch += 1
    return out


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def admission_control(tenants: Mapping[str, TenantSpec],
                      traffic: Mapping[str, float],
                      footprint: Mapping[str, int],
                      capacity_bytes: int, *,
                      heat_floor: float = 0.0,
                      churn_guard: Optional[float] = None,
                      hot_bytes: Optional[Mapping[str, int]] = None
                      ) -> Dict[str, str]:
    """Decide which tenants are demoted to serve-from-slow this epoch.

    Returns ``{tenant: reason}`` for every demoted tenant.  Two tests:

    * **cold**: a tenant whose access density (traffic per footprint
      byte) is below ``heat_floor`` times the mean density of the
      trafficked tenants — its bytes would occupy fast capacity that
      hot tenants can convert into far more slack.
    * **over-quota churn**: with ``churn_guard`` set, a tenant whose
      per-phase hot set exceeds ``churn_guard`` times the share it
      would get even owning the whole remaining pool alone is demoted —
      its share could never hold a useful fraction of any phase's
      working set, so serving it from fast would be pure thrash.

    Both knobs default off (no demotion); the session exposes them as
    ``RuntimeConfig.tenant_admission_heat`` / ``tenant_churn_guard``."""
    demoted: Dict[str, str] = {}
    dens = {t: traffic.get(t, 0.0) / max(1, footprint.get(t, 0))
            for t in tenants}
    trafficked = [d for d in dens.values() if d > 0.0]
    mean_dens = sum(trafficked) / len(trafficked) if trafficked else 0.0
    if heat_floor > 0.0 and mean_dens > 0.0:
        for t in sorted(tenants):
            if dens[t] < heat_floor * mean_dens:
                demoted[t] = (f"cold: density {dens[t]:.3g} < "
                              f"{heat_floor:g} x mean {mean_dens:.3g}")
    if churn_guard is not None and hot_bytes:
        survivors = {t: s for t, s in tenants.items() if t not in demoted}
        if survivors:
            shares = capacity_shares(
                capacity_bytes, survivors,
                {t: footprint.get(t, 0) for t in survivors})
            for t in sorted(survivors):
                hot = hot_bytes.get(t, 0)
                if shares.get(t, 0) > 0 and hot > churn_guard * shares[t]:
                    demoted[t] = (f"over-quota: hot set {hot} > "
                                  f"{churn_guard:g} x share {shares[t]}")
    return demoted


# ---------------------------------------------------------------------------
# the serving metric
# ---------------------------------------------------------------------------
def per_tenant_p99(trace: Iterable[Any], phase_names: List[str],
                   tenants: Mapping[str, Any], *,
                   steady_frac: float = 0.5,
                   q: float = 0.99) -> Dict[str, float]:
    """Per-tenant p99 of per-iteration serving time.

    ``trace`` holds phase executions with ``iteration`` / ``phase_index``
    / ``stall_s`` / ``duration_s`` (the simulator's ``PhaseExec``).  A
    tenant's per-iteration time is the sum of stall+compute over the
    phases its namespace owns; the quantile is taken over the steady
    tail (the last ``steady_frac`` of iterations, skipping profiling and
    enactment warm-up)."""
    per: Dict[str, Dict[int, float]] = {}
    for ev in trace:
        if ev.phase_index >= len(phase_names):
            continue
        t = tenant_of(phase_names[ev.phase_index], tenants)
        if t is None:
            continue
        per.setdefault(t, {})[ev.iteration] = (
            per.get(t, {}).get(ev.iteration, 0.0)
            + ev.stall_s + ev.duration_s)
    out: Dict[str, float] = {}
    for t, by_iter in per.items():
        times = [by_iter[i] for i in sorted(by_iter)]
        tail = times[int(len(times) * (1.0 - steady_frac)):] or times
        s = sorted(tail)
        idx = min(len(s) - 1, int(round(q * (len(s) - 1))))
        out[t] = s[idx]
    return out


def split_by_tenant(names: Iterable[str],
                    tenants: Mapping[str, Any]
                    ) -> Tuple[Dict[str, List[str]], List[str]]:
    """Partition ``names`` into per-tenant lists plus the unowned rest."""
    owned: Dict[str, List[str]] = {t: [] for t in tenants}
    rest: List[str] = []
    for n in names:
        t = tenant_of(n, tenants)
        if t is None:
            rest.append(n)
        else:
            owned[t].append(n)
    return owned, rest
