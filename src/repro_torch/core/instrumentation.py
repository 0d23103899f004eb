"""Pluggable instrumentation sources (runtime API v2).

The paper gets per-phase access counts from PEBS sampling; this repo has
grown three other ways to learn how a phase touches the registered objects
(explicit driver dicts, the simulator's density physics, XLA cost analysis
on hardware dry-runs).  Each used to hand-roll its own
``phase_end(accesses=..., access_bins=...)`` plumbing; the
:class:`InstrumentationSource` protocol makes them interchangeable
providers that a :class:`~.session.Session` consults at every phase exit:

* :class:`ManualSource` — the Table-2 style: the driver states each phase's
  per-object access counts explicitly (what the old imperative API passed
  to ``phase_end``).
* :class:`~..sim.SimSource` — the discrete-event simulator's density-driven
  physics (stream/chase service times, per-chunk densities), so that the
  simulation engine is just a clock around it.
* an attribution source from compiled programs (the reference package's
  ``XlaCostAnalysisSource``); its counterpart here is still to be written
  (ROADMAP.md, queue 1: "XlaCostAnalysisSource's counterpart").

A source returns a :class:`PhaseSample`; fields left ``None`` fall back to
the session's own measurement (wall-clock timing, access-count shares).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Sequence, Union

from .histogram import Histogram


@dataclasses.dataclass
class PhaseSample:
    """One phase execution's instrumentation (profiler input, pre-sampling).

    ``access_bins`` values are either legacy fixed-width weight sequences
    (relative weights over equal-width bins) or multi-resolution
    :class:`~.histogram.Histogram`\\ s (variable-width bins, e.g. one bin
    per pytree leaf) — the profiler re-samples either onto its own
    (budgeted, adaptively refined) bin edges.

    ``elapsed`` is the phase's execution time in seconds when the source
    defines virtual time (the simulator) or an analytic estimate; ``None``
    means the session should use the wall-clock time its phase context
    measured."""

    accesses: Dict[str, float] = dataclasses.field(default_factory=dict)
    time_shares: Optional[Dict[str, float]] = None
    access_bins: Optional[Dict[str, Union[Sequence[float], Histogram]]] = None
    elapsed: Optional[float] = None


class InstrumentationSource(Protocol):
    """Provider of per-phase instrumentation, consulted at phase exit."""

    def collect(self, phase_name: str) -> PhaseSample: ...


# ---------------------------------------------------------------------------
class ManualSource:
    """Explicit per-phase instrumentation dicts.

    The driver states (once, or per iteration via :meth:`set`) what each
    phase touches — the information the old imperative API passed to every
    ``phase_end`` call."""

    def __init__(self, phases: Optional[Dict[str, PhaseSample]] = None):
        self._phases: Dict[str, PhaseSample] = dict(phases or {})

    def set(self, phase_name: str, *,
            accesses: Optional[Dict[str, float]] = None,
            time_shares: Optional[Dict[str, float]] = None,
            access_bins: Optional[Dict[str, Sequence[float]]] = None,
            elapsed: Optional[float] = None) -> None:
        self._phases[phase_name] = PhaseSample(
            accesses=dict(accesses or {}), time_shares=time_shares,
            access_bins=access_bins, elapsed=elapsed)

    def collect(self, phase_name: str) -> PhaseSample:
        return self._phases.get(phase_name, PhaseSample())
