"""Multi-host tier management end to end: per-host shard managers, the
cluster coordinator's rebalance, and cross-host migration over modeled
interconnect links, on the ``moe_churn_multihost`` scenario.

Four virtual hosts each own four MoE expert shards plus a replicated
dense trunk and router.  After router churn collapses all traffic onto
host h0's experts, its hot shard exceeds DRAM capacity while the peers'
experts sit idle — host-local management can only shuffle h0's own
DRAM/NVM pair, so two surplus hot experts serve from NVM every
iteration.  The :class:`~repro_torch.distributed.ClusterCoordinator` compares
local NVM->DRAM promotion against pulling each surplus shard to a peer
with spare capacity (priced per link via ``cross_host_cost``), executes
the pulls on the registered ``"cross_host"`` backend (send/recv channel
pairs, link shares apportioned by bytes demand), and re-homes the shards
— the steady cluster iteration time is the slowest host's, and the
rebalance flattens it.

The PyTorch port's copy of ``examples/multihost_demo.py``: numpy only, on
the host, with the same numbers as the reference package's example.

  PYTHONPATH=src python examples/multihost_demo_torch.py
"""

import sys
sys.path.insert(0, "src")

from repro_torch.sim import ClusterSimulation, moe_churn_multihost

ITERS = 12


def main() -> None:
    machine, wl, links, knobs = moe_churn_multihost()
    sim = ClusterSimulation(machine, wl, links=links, **knobs)

    local = sim.run_local_only(ITERS)
    coord = sim.run_coordinated(ITERS)

    print(f"scenario: {wl.name} ({len(wl.hosts())} hosts, "
          f"{len(wl.objects)} expert shards + {len(wl.shared)} replicated)")
    print(f"link: {links.link('h0', 'h1').name} "
          f"{links.link('h0', 'h1').bandwidth / 1e9:.0f} GB/s x "
          f"{links.link('h0', 'h1').channel_pairs} send/recv pairs\n")

    print("coordinator rebalance:")
    for m in coord.migrations:
        print(f"  {m.obj:12s} {m.mode:13s} {m.src_host} -> {m.dst_host}  "
              f"cost {m.est_cost_s * 1e3:6.2f} ms   "
              f"benefit {m.est_benefit_s * 1e3:6.2f} ms/iter  "
              f"link {m.link or '-'}")
    print(f"  one-time migration wall time: {coord.migration_s * 1e3:.2f} ms\n")

    print(f"{'host':6s} {'local-only':>12s} {'coordinated':>12s} {'gain':>7s}")
    for h in wl.hosts():
        lo, co = local.steady_time(h), coord.steady_time(h)
        print(f"{h:6s} {lo * 1e3:10.2f}ms {co * 1e3:10.2f}ms {lo / co:6.2f}x")
    print(f"{'max':6s} {local.cluster_steady_time * 1e3:10.2f}ms "
          f"{coord.cluster_steady_time * 1e3:10.2f}ms "
          f"{local.cluster_steady_time / coord.cluster_steady_time:6.2f}x")

    prog = coord.program
    print(f"\nglobal plan: strategy={prog.strategy} "
          f"predicted={prog.predicted_iteration_time * 1e3:.2f}ms "
          f"(max over hosts), {len(prog.migrations)} migrations, "
          f"host sections: {', '.join(sorted(prog.host_sections))}")
    hot = local.cluster_steady_time / coord.cluster_steady_time
    assert hot >= 1.10, f"coordinator gain collapsed: {hot:.2f}x"


if __name__ == "__main__":
    main()
