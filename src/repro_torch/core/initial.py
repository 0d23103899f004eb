"""Initial data placement (paper §3.2 "Initial data placement").

By default every object starts in the slow tier.  The paper improves on this
with *compiler analysis*: a symbolic count of memory references per object,
available before the main loop, places the most-referenced objects in the
fast tier up front (ignoring caching effects — which in their evaluation
matches the runtime's cross-phase global decision anyway).

Here the "compiler analysis" is the analytic reference-count model that every
workload/model definition exposes (``static_ref_counts``): for an LM step the
counts come from the model graph (each weight is read once per microbatch,
optimizer state read+written once per step, KV blocks read per token, ...).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .data_objects import ObjectRegistry


def initial_placement(registry: ObjectRegistry,
                      static_ref_counts: Dict[str, float],
                      fast_capacity_bytes: int,
                      *, reserve_bytes: int = 0) -> List[str]:
    """Greedy fill of the fast tier by descending static reference count.

    Mutates ``obj.tier`` for the chosen objects and returns their names.
    Unknown objects (no static estimate) are left in the slow tier.
    """
    budget = fast_capacity_bytes - reserve_bytes
    # tie-break by name so the placement is a pure function of the counts —
    # not of the dict insertion order the driver happened to use (old-API
    # start_loop(static_refs=...) vs v2 per-register static_refs must be
    # bit-identical)
    order = sorted(
        (name for name in static_ref_counts if name in registry),
        key=lambda n: (-static_ref_counts[n], n))
    placed: List[str] = []
    for name in order:
        obj = registry[name]
        if obj.pinned:
            continue
        if obj.size_bytes <= budget and static_ref_counts[name] > 0:
            obj.tier = "fast"
            budget -= obj.size_bytes
            placed.append(name)
    return placed


def static_ref_counts_from_graph(phase_refs: Dict[int, Dict[str, float]]
                                 ) -> Dict[str, float]:
    """Aggregate per-phase analytic reference counts into per-object totals."""
    totals: Dict[str, float] = {}
    for refs in phase_refs.values():
        for obj, cnt in refs.items():
            totals[obj] = totals.get(obj, 0.0) + cnt
    return totals
