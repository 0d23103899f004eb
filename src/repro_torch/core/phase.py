"""Phases and the phase graph.

Paper §2.1: an iterative application decomposes into *phases* delimited by
MPI operations (here: collectives / jit-step boundaries).  Non-blocking
communication is merged into the following phase; the completion op is a
phase.  Each phase references a known set of target data objects.

The phase graph supplies the two facts the performance model needs:

* per-(phase, object) access counts (filled by the profiler), and
* the *earliest dependency-safe trigger point* for moving an object needed by
  phase ``i``: walking backwards from ``i``, the first phase that references
  the object is ``j-1``; the move may start at the beginning of phase ``j``
  (paper Fig 5).  The overlap window is the execution time of phases
  ``j .. i-1``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple


class PhaseKind(enum.Enum):
    COMPUTE = "compute"
    COMM = "comm"


@dataclasses.dataclass
class Phase:
    """One phase of the iteration.

    ``refs`` maps object name -> number of main-memory accesses in this phase
    (the profiler's ``#data_access``).  ``time`` is the measured (or
    simulated) phase execution time in seconds.
    """

    index: int
    name: str
    kind: PhaseKind = PhaseKind.COMPUTE
    refs: Dict[str, float] = dataclasses.field(default_factory=dict)
    time: float = 0.0

    def references(self, obj: str) -> bool:
        return self.refs.get(obj, 0.0) > 0.0


class PhaseGraph:
    """Ordered phases of one iteration of the main loop."""

    def __init__(self, phases: Sequence[Phase]):
        self.phases: List[Phase] = list(phases)
        for i, p in enumerate(self.phases):
            if p.index != i:
                raise ValueError(f"phase {p.name} has index {p.index} != {i}")

    def __len__(self) -> int:
        return len(self.phases)

    def __iter__(self):
        return iter(self.phases)

    def __getitem__(self, i: int) -> Phase:
        return self.phases[i]

    def objects(self) -> List[str]:
        names: List[str] = []
        seen = set()
        for p in self.phases:
            for o in p.refs:
                if o not in seen:
                    seen.add(o)
                    names.append(o)
        return names

    def iteration_time(self) -> float:
        return sum(p.time for p in self.phases)

    # ---- dependency-safe trigger points (paper Fig 5) ----------------------
    def trigger_point(self, obj: str, phase_index: int) -> int:
        """Earliest phase at whose *start* a move of ``obj`` (needed by phase
        ``phase_index``) may be triggered.

        Walk backwards (wrapping around the iteration, since the loop is
        iterative) until a phase referencing ``obj`` is found; the trigger is
        the phase right after it.  If no other phase references the object,
        the move can be triggered a full iteration ahead — we cap the window
        at one iteration and return the phase after ``phase_index`` of the
        previous iteration, expressed as ``phase_index - (n-1)`` steps back
        (may be negative == previous iteration).
        """
        n = len(self.phases)
        for back in range(1, n):
            j = phase_index - back
            if self.phases[j % n].references(obj):
                return j + 1  # may be negative: previous iteration
        return phase_index - (n - 1)

    def overlap_window(self, obj: str, phase_index: int) -> float:
        """``mem_comp_overlap`` of Eq. (4): time between the trigger point and
        the start of ``phase_index``."""
        return self.window_between(self.trigger_point(obj, phase_index),
                                   phase_index)

    def window_between(self, trigger_phase: int, needed_by: int) -> float:
        """Execution time between the start of ``trigger_phase`` and the start
        of ``needed_by`` (``trigger_phase`` may be negative: previous
        iteration).  This is the copy window a scheduled move can overlap."""
        n = len(self.phases)
        total = 0.0
        for k in range(trigger_phase, needed_by):
            total += self.phases[k % n].time
        return total

    def phases_referencing(self, obj: str) -> List[int]:
        return [p.index for p in self.phases if p.references(obj)]


@dataclasses.dataclass
class PhaseTraceEvent:
    """Raw instrumentation for one dynamic phase execution (profiler input)."""

    phase_index: int
    time: float                      # seconds
    # true access counts per object for this execution (pre-sampling)
    accesses: Dict[str, float] = dataclasses.field(default_factory=dict)
    # fraction of the phase's time attributable to each object's memory
    # accesses (what PEBS's per-object sample fraction measures); optional —
    # the profiler falls back to access-count shares.
    time_shares: Optional[Dict[str, float]] = None
    # true access distribution over each object's byte range (relative
    # weights over equal-width bins — the address histogram a PEBS sample
    # stream would bin); optional — objects without an entry are profiled at
    # object granularity only.  The profiler resamples these with seeded
    # multinomial noise (per-chunk attribution, paper §3.2 extended).
    access_bins: Optional[Dict[str, Sequence[float]]] = None


def build_phase_graph(
    names_and_refs: Sequence[Tuple[str, Dict[str, float]]],
    kinds: Optional[Sequence[PhaseKind]] = None,
    times: Optional[Sequence[float]] = None,
) -> PhaseGraph:
    """Convenience constructor from (name, refs) pairs."""
    phases = []
    for i, (name, refs) in enumerate(names_and_refs):
        phases.append(Phase(
            index=i, name=name,
            kind=kinds[i] if kinds else PhaseKind.COMPUTE,
            refs=dict(refs),
            time=times[i] if times else 0.0))
    return PhaseGraph(phases)
