"""Quickstart, the PyTorch port's copy of ``examples/quickstart.py``: the
Unimem runtime managing a CG-like workload on simulated DRAM+NVM,
reproducing the paper's headline result in a few seconds — written
against the v2 session API: pytree-native ``register`` (here size-only
objects), no upfront phase list (phases auto-register as the simulator's
driver enters them), and the simulator supplying instrumentation through
its ``SimSource``.

The simulator is numpy only; it runs on the host, with or without a card,
and prints the same numbers as the reference package's example.

  PYTHONPATH=src python examples/quickstart_torch.py
"""

import sys
sys.path.insert(0, "src")

from repro_torch.core import (PAPER_DRAM_NVM, RuntimeConfig, UnimemRuntime,
                        calibrate)
from repro_torch.core.data_objects import ObjectRegistry
from repro_torch.sim import NPB_WORKLOADS, SimulationEngine

MB = 1024 ** 2


def main() -> None:
    machine = PAPER_DRAM_NVM.scaled(bw_scale=0.5)    # NVM = 1/2 DRAM bw
    wl = NPB_WORKLOADS["cg"]()

    def static(tier):
        reg = ObjectRegistry()
        for n, s in wl.objects.items():
            reg.alloc(n, s, tier=tier)
        return SimulationEngine(machine, wl, registry=reg).run(10)

    dram = static("fast")
    nvm = static("slow")

    # unimem_init + unimem_malloc: register each target object (size or
    # pytree); static_refs feed the initial-placement compiler analysis
    rt = UnimemRuntime(machine, RuntimeConfig(fast_capacity_bytes=256 * MB),
                       cf=calibrate(machine))
    statics = wl.static_ref_counts()
    for n, s in wl.objects.items():
        rt.register(n, s, static_refs=statics.get(n))
    # the engine drives `with rt.iteration(): with rt.phase(name): ...`
    # itself; its SimSource supplies accesses/time_shares/access_bins
    uni = SimulationEngine(machine, wl, runtime=rt).run(12)

    d = dram.steady_iteration_time
    print(f"DRAM-only        : {d * 1e3:8.2f} ms/iter (1.00x)")
    print(f"NVM-only         : {nvm.steady_iteration_time * 1e3:8.2f} ms/iter"
          f" ({nvm.steady_iteration_time / d:.2f}x)")
    print(f"Unimem (256MB)   : {uni.steady_iteration_time * 1e3:8.2f} ms/iter"
          f" ({uni.steady_iteration_time / d:.2f}x)")
    print("runtime:", rt.stats())


if __name__ == "__main__":
    main()
