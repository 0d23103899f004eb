"""A planner workload of many chunks, for timing and checking plan builds.

:func:`build_chunk_fixture` is the reference package's planner-latency
fixture (its tests' ``build_chunk_fixture``), copied: ``n_objs`` chunks of
1-4 MiB over 10 partitioned parents, with parent-level profiles over
``n_phases`` phases, drawn from ``random.Random(seed)``.  At 2,000 chunks
and a 256 MiB fast tier every knapsack the planner solves is thousands of
items over a 16,384-cell grid, above the DP's device threshold
(``core/knapsack.py`` ``_DEVICE_MIN_WORK``).  :func:`plan_program` builds
one plan of it, both searches, as a :class:`PlanProgram`.
"""

from __future__ import annotations

import random

from ..core import (CalibrationConstants, PAPER_DRAM_NVM, PhaseProfiler,
                    Planner, PlanProgram, build_phase_graph)
from ..core.data_objects import DataObject, ObjectRegistry
from ..core.partition import resplit_refs
from ..core.phase import PhaseTraceEvent

MB = 1024 ** 2
#: the machine the reference's policy tests plan for
MACHINE = PAPER_DRAM_NVM.scaled(bw_scale=0.5, lat_scale=2.0)


def build_chunk_fixture(n_objs, n_phases=12, seed=0, machine=MACHINE):
    """(registry, phase graph, profiler, refs, times): N chunks over 10
    partitioned parents with parent-level profiles (the chunk-attribution
    hot path)."""
    rng = random.Random(seed)
    reg = ObjectRegistry()
    per = n_objs // 10
    for p in range(10):
        for k in range(per):
            reg.register(DataObject(
                name=f"par{p}#{k}", size_bytes=rng.randint(1, 4) * MB,
                parent=f"par{p}", chunk_index=k))
    refs, times = [], []
    for _ in range(n_phases):
        r = {f"par{p}": rng.uniform(1e5, 1e7) for p in range(10)
             if rng.random() < 0.7}
        refs.append(r)
        times.append(rng.uniform(0.01, 0.2))
    graph = build_phase_graph(
        [(f"ph{i}", rr) for i, rr in enumerate(refs)], times=times)
    prof = PhaseProfiler(machine, seed=seed)
    for i, rr in enumerate(refs):
        prof.observe(PhaseTraceEvent(i, times[i], dict(rr)))
    prof.annotate_graph(graph)
    resplit_refs(graph, reg)
    return reg, graph, prof, refs, times


def plan_program(reg, graph, prof, capacity_bytes: int,
                 machine=MACHINE) -> PlanProgram:
    """One plan of the fixture: the local and the global search, as the
    reference's policy tests build it."""
    planner = Planner(machine, reg, CalibrationConstants(), capacity_bytes)
    local = planner.plan_local(graph, prof)
    glob = planner.plan_global(graph, prof)
    return PlanProgram.from_plan(
        local, policy="unimem", provenance=[], profile_epoch=prof.epoch,
        chunk_generation=reg.generation, capacity_bytes=capacity_bytes,
        phase_decisions=local.phase_decisions,
        global_contribs=glob.global_contribs,
        graph_digest=local.graph_digest)
