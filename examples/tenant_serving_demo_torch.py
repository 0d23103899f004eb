"""Multi-tenant serving end to end: tenant namespaces, QoS-weighted
bandwidth partitioning, and admission control on the ``tenant_serving``
scenario (one whale, three mid tenants, one cold archive).

Each tenant is declared with its (priority, slo) contract via
``rt.tenant(name, ...)`` and registers its objects through the returned
handle — names land in the registry as ``tenant/object``, so attribution,
fault provenance, and the per-tenant p99 metric all key off the namespace.
The ``bandwidth_partition`` policy splits the fast tier and the copy
channels across tenants by QoS weight (priority/slo), demotes the cold
tenant to serve-from-slow, and solves placement per tenant inside its
share; the demo compares its per-tenant p99 slack against the aggregate
unimem solve.

The PyTorch port's copy of ``examples/tenant_serving_demo.py``: numpy only,
on the host, with the same numbers as the reference package's example.

  PYTHONPATH=src python examples/tenant_serving_demo_torch.py
"""

import sys
sys.path.insert(0, "src")

from repro_torch.core import PAPER_DRAM_NVM, RuntimeConfig, UnimemRuntime, calibrate
from repro_torch.core.tenancy import per_tenant_p99
from repro_torch.sim import SimulationEngine
from repro_torch.sim.workloads import TENANT_SERVING_QOS, tenant_serving

MB = 1024 ** 2
ITERS = 16


def run(policy: str):
    machine = PAPER_DRAM_NVM.scaled(bw_scale=0.5, lat_scale=2.0)
    wl = tenant_serving()
    rt = UnimemRuntime(
        machine,
        RuntimeConfig(fast_capacity_bytes=192 * MB, copy_channels=7,
                      drift_threshold=10.0, policy=policy),
        cf=calibrate(machine))
    handles = {t: rt.tenant(t, priority=p, slo=s)
               for t, (p, s) in TENANT_SERVING_QOS.items()}
    statics = wl.static_ref_counts()
    for name, size in wl.objects.items():
        tenant, _, rest = name.partition("/")
        handles[tenant].register(rest, size, static_refs=statics.get(name))
    res = SimulationEngine(machine, wl, runtime=rt).run(ITERS)
    return res, rt, wl


def main() -> None:
    uni, _, wl = run("unimem")
    part, rt, _ = run("bandwidth_partition")
    names = [ph.name for ph in wl.phases]
    p_uni = per_tenant_p99(uni.phase_trace, names, TENANT_SERVING_QOS)
    p_bp = per_tenant_p99(part.phase_trace, names, TENANT_SERVING_QOS)

    shares = dict(getattr(rt.plan, "tenant_shares", {}) or {})
    channels = dict(getattr(rt.plan, "tenant_channels", {}) or {})
    admission = dict(getattr(rt.plan, "tenant_admission", {}) or {})
    print(f"{'tenant':8s} {'weight':>6s} {'share':>8s} {'chans':>6s} "
          f"{'p99 unimem':>11s} {'p99 part':>9s} {'gain':>6s}")
    for t, (prio, slo) in TENANT_SERVING_QOS.items():
        gain = p_uni[t] / p_bp[t]
        print(f"{t:8s} {prio / slo:6.2f} {shares.get(t, 0) / MB:6.0f}MB "
              f"{len(channels.get(t, [])):6d} {p_uni[t] * 1e3:9.1f}ms "
              f"{p_bp[t] * 1e3:7.1f}ms {gain:5.2f}x")
    for t, why in sorted(admission.items()):
        print(f"admission: {t!r} demoted to serve-from-slow ({why})")
    s = rt.stats()
    print(f"stats: n_tenants={s['n_tenants']} "
          f"n_admission_demotions={s['n_admission_demotions']} "
          f"strategy={s['strategy']}")


if __name__ == "__main__":
    main()
