"""The port's cluster simulation and coordinator (``repro_torch.sim.cluster``,
``repro_torch.distributed``) against the reference's, run live in the same
process: ``moe_churn_multihost`` local-only and coordinated (12 iterations,
as ``tests/test_multihost.py`` runs it), a one-host cluster against the
unclustered session on ``kv_serving``, and a two-host cluster under chaos.
Per-host iteration times and phase traces, each host's plan and stats, the
rebalance decisions, the migration time and the global plan must be equal
with ``==``.  Every phase's time is virtual (``SimSource``); no host-clock
field enters the comparison.

The reference's pinned golden digests are not used: two of
``tests/test_multihost.py``'s do not reproduce on every numpy/jax version
(ROADMAP.md, queue 3, R3).
"""

import json

import pytest

pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.sim as ref_sim  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.sim as port_sim  # noqa: E402
import repro.distributed as ref_dist  # noqa: E402
import repro_torch.distributed as port_dist  # noqa: E402

MB = 1024 ** 2
PACKAGES = {"ref": (ref_core, ref_sim), "port": (port_core, port_sim)}


def _host_result(res) -> dict:
    return dict(
        iteration_times=res.iteration_times, total_time=res.total_time,
        trace=[(p.iteration, p.phase_index, p.start, p.stall_s, p.duration_s)
               for p in res.phase_trace],
        stats=json.dumps(res.stats, sort_keys=True, default=str))


def _cluster_result(res) -> dict:
    return dict(
        hosts={h: _host_result(r) for h, r in res.host_results.items()},
        probe={h: _host_result(r) for h, r in res.probe_results.items()},
        assignment=res.assignment,
        migrations=[m.to_dict() for m in res.migrations],
        migration_s=res.migration_s,
        program=res.program.to_json() if res.program is not None else None,
        cluster_steady_time=res.cluster_steady_time)


def _churn(pkg: str, coordinated: bool, interleave: bool) -> dict:
    _, sim = PACKAGES[pkg]
    machine, wl, links, knobs = sim.moe_churn_multihost()
    cs = sim.ClusterSimulation(machine, wl, links=links, **knobs)
    res = (cs.run_coordinated(12, interleave=interleave) if coordinated
           else cs.run_local_only(12, interleave=interleave))
    return _cluster_result(res)


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("coordinated", [False, True],
                         ids=["local_only", "coordinated"])
def test_moe_churn_multihost_matches_reference(coordinated, interleave):
    ref = _churn("ref", coordinated, interleave)
    port = _churn("port", coordinated, interleave)
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key] == ref[key], key
    if coordinated:      # the comparison covers real rebalance decisions
        assert port["migrations"] and port["migration_s"] > 0.0
        assert json.loads(port["program"])["host_sections"]


def _coordinator_state(pkg: str) -> dict:
    """The coordinator's own outputs after a 4-iteration probe: each host's
    shard heat, the rebalance, and the cluster rollup."""
    core, sim = PACKAGES[pkg]
    machine, wl, links, knobs = sim.moe_churn_multihost()
    cs = sim.ClusterSimulation(machine, wl, links=links, **knobs)
    coord, engines = cs._build(wl.assignment)
    cs.run_hosts(engines, 4)
    migs = coord.plan_rebalance()
    backend = coord.make_backend(now_fn=lambda: 0.0)
    wall, handles = coord.execute_migrations(migs, backend, now=0.0)
    return dict(
        heat={m.host: m.shard_heat() for m in coord.hosts},
        demand={m.host: m.fast_demand_bytes() for m in coord.hosts},
        migrations=[m.to_dict() for m in migs], wall=wall,
        landings=[h.done for h in handles],
        registries={m.host: sorted((o.name, o.tier)
                                   for o in m.session.registry)
                    for m in coord.hosts},
        stats=json.dumps(coord.stats(), sort_keys=True, default=str),
        program=coord.aggregate_program(migs).to_json())


def test_coordinator_decisions_and_rehoming_match_reference():
    ref, port = _coordinator_state("ref"), _coordinator_state("port")
    for key in ref:
        assert port[key] == ref[key], key
    assert port["migrations"] and port["wall"] > 0.0


def _as_sharded(sim, wl, host="h0"):
    return sim.ShardedWorkload(
        wl.name,
        [sim.ShardPhaseSpec(p.name, p.compute_s, p.touches)
         for p in wl.phases],
        dict(wl.objects), shared={},
        assignment={o: host for o in wl.objects},
        chunkable=dict(wl.chunkable))


@pytest.mark.parametrize("mover", ["slack", "fifo"])
def test_one_host_cluster_matches_reference_and_the_unclustered_run(mover):
    """``kv_serving`` as a one-host cluster (256 MB, 8 iterations) in both
    packages, and in the port against its own unclustered session."""
    out = {}
    for pkg, (core, sim) in PACKAGES.items():
        machine = core.PAPER_DRAM_NVM.scaled(bw_scale=0.5, lat_scale=2.0)
        cf = core.calibrate(machine)
        wl = sim.kv_serving()
        cs = sim.ClusterSimulation(machine, _as_sharded(sim, wl), cf=cf,
                                   fast_capacity_bytes=256 * MB, mover=mover)
        out[pkg] = _cluster_result(cs.run_local_only(8))
        if pkg == "port":
            rt = core.UnimemRuntime(machine, core.RuntimeConfig(
                fast_capacity_bytes=256 * MB, mover=mover), cf=cf)
            statics = wl.static_ref_counts()
            for n, s in wl.objects.items():
                rt.register(n, s, chunkable=wl.chunkable.get(n, False),
                            static_refs=statics.get(n))
            plain = sim.SimulationEngine(machine, wl, runtime=rt).run(8)
    assert out["port"] == out["ref"]
    host = out["port"]["hosts"]["h0"]
    assert host["iteration_times"] == plain.iteration_times
    assert host["trace"] == _host_result(plain)["trace"]


def _chaos_pair(pkg: str, interleave: bool) -> dict:
    """Two symmetric hosts under a transient-fault profile: per-host fault
    streams come from host sub-seeds, so they must match the reference's
    host by host whatever the scheduling order."""
    core, sim = PACKAGES[pkg]
    ex = 40 * MB
    objects, assignment, phases = {}, {}, []
    for h in ("h0", "h1"):
        for k in range(3):
            objects[f"{h}/e{k}"] = ex
            assignment[f"{h}/e{k}"] = h
    for p in range(2):
        touches = {}
        for h in ("h0", "h1"):
            for k in (p, p + 1):
                touches[f"{h}/e{k}"] = sim.SimObjectAccess(2.0 * ex / 64, 0.9)
        phases.append(sim.ShardPhaseSpec(f"p{p}", 0.002, touches))
    wl = sim.ShardedWorkload("sym_churn", phases, objects, {}, assignment)
    machine = core.PAPER_DRAM_NVM.scaled(bw_scale=0.5, lat_scale=2.0)
    cs = sim.ClusterSimulation(
        machine, wl, fast_capacity_bytes=80 * MB,
        fault_spec=core.FaultSpec(seed=7, transient_rate=0.3))
    coord, engines = cs._build(wl.assignment)
    results = cs.run_hosts(engines, 8, interleave=interleave)
    return dict(
        hosts={h: _host_result(r) for h, r in results.items()},
        faults={h: json.dumps(e.runtime.backend.fault_log, default=str)
                for h, e in engines.items()})


@pytest.mark.parametrize("interleave", [False, True])
def test_two_host_chaos_matches_reference(interleave):
    ref, port = _chaos_pair("ref", interleave), _chaos_pair("port",
                                                            interleave)
    assert port == ref
    assert all(json.loads(f) for f in port["faults"].values())


def _refusals(pkg: str) -> list:
    """What the coordinator refuses: no host, a duplicate host id, and a
    session tagged with another host."""
    core, _ = PACKAGES[pkg]
    dist = ref_dist if pkg == "ref" else port_dist
    machine = core.PAPER_DRAM_NVM
    cases = [
        lambda: dist.ClusterCoordinator([]),
        lambda: dist.ClusterCoordinator([dist.HostTierManager("h0", machine),
                                         dist.HostTierManager("h0", machine)]),
        lambda: dist.HostTierManager("h0", machine, session=core.UnimemRuntime(
            machine, core.RuntimeConfig(host="h1")))]
    out = []
    for case in cases:
        with pytest.raises(ValueError) as err:
            case()
        out.append(str(err.value))
    return out


def test_coordinator_refuses_what_the_reference_refuses():
    assert _refusals("port") == _refusals("ref")
