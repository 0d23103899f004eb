"""Workload variation monitoring (paper §3.2) — doubles as the straggler
watchdog at scale.

Unimem re-activates profiling when a phase's execution time drifts more than
10% from the time the current plan was built on.  In the distributed setting
the same signal flags stragglers: a phase that is suddenly slow on some step
(hardware fault, preemption, contended host) triggers re-profiling and a new
placement plan instead of silently degrading every subsequent step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class DriftEvent:
    phase_index: int
    baseline: float
    observed: float

    @property
    def ratio(self) -> float:
        """Observed-over-baseline slowdown.  A zero/negative baseline means
        the phase was never meaningfully observed — there is no slowdown to
        report, so the ratio is a neutral 1.0 (an infinite ratio here would
        poison any threshold comparison built on it)."""
        return self.observed / self.baseline if self.baseline > 0 else 1.0


class VariationMonitor:
    def __init__(self, threshold: float = 0.10, patience: int = 2):
        """``patience``: consecutive drifting executions before firing (debounce
        so a single straggler step does not thrash the planner)."""
        self.threshold = threshold
        self.patience = patience
        self._baseline: Dict[int, float] = {}
        self._strikes: Dict[int, int] = {}
        self.events: List[DriftEvent] = []

    def set_baseline(self, phase_index: int, time_s: float) -> None:
        self._baseline[phase_index] = time_s
        self._strikes[phase_index] = 0

    def observe(self, phase_index: int, time_s: float,
                faulted: bool = False) -> Optional[DriftEvent]:
        """Returns a DriftEvent when re-profiling should be triggered.

        ``faulted`` marks an execution slowed by a *confirmed* fault (a
        degraded slow-tier serve) rather than by noise: the debounce is
        bypassed, so a threshold-exceeding slowdown fires immediately and
        the next replan re-prices the undeliverable move."""
        base = self._baseline.get(phase_index)
        if base is None or base <= 0:
            self._baseline[phase_index] = time_s
            return None
        drift = abs(time_s - base) / base
        if drift > self.threshold:
            self._strikes[phase_index] = (self._strikes.get(phase_index, 0)
                                          + (self.patience if faulted else 1))
            if self._strikes[phase_index] >= self.patience:
                ev = DriftEvent(phase_index, base, time_s)
                self.events.append(ev)
                self._strikes[phase_index] = 0
                return ev
        else:
            self._strikes[phase_index] = 0
        return None

    def drifted_phases(self) -> List[int]:
        """Phases with a pending (not-yet-consumed) drift event — a
        diagnostic for tests and operators inspecting what triggered a
        replan before ``consume_events`` clears it."""
        return sorted({ev.phase_index for ev in self.events})

    def consume_events(self) -> List[DriftEvent]:
        """Return and clear the pending drift events (called when a replan
        has been enacted, so stale events don't re-trigger it)."""
        out = list(self.events)
        self.events.clear()
        return out
