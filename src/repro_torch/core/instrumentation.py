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
* :class:`OperandAttributionSource` — the counterpart of the reference's
  ``XlaCostAnalysisSource``.  There is no compiled program to read, so it
  records the operands of a real run of a phase: every aten op's tensor
  arguments (a ``TorchDispatchMode``) and, once a call, the tensors each
  hand-written kernel's wrapper reads and writes
  (:mod:`..record`), mapped onto the registered objects' leaf byte
  spans by storage and byte range.

A source returns a :class:`PhaseSample`; fields left ``None`` fall back to
the session's own measurement (wall-clock timing, access-count shares).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import _tree
from .. import record as _record
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


# ---------------------------------------------------------------------------
# Operand attribution of a recorded run
# ---------------------------------------------------------------------------
def _runs(t: torch.Tensor) -> Tuple[np.ndarray, int, int]:
    """The bytes a strided tensor covers, as runs: (start offsets in bytes
    from its first element, each run's bytes, times each run is covered).
    Dimensions are merged innermost first while they are contiguous; a
    stride-0 dimension covers the same bytes again (the count)."""
    es = t.element_size()
    repeat, dims = 1, []
    for n, st in zip(t.shape, t.stride()):
        if n == 1:
            continue
        if st == 0:
            repeat *= n
        else:
            dims.append((st, n))
    dims.sort()
    run, i = 1, 0
    while i < len(dims) and dims[i][0] == run:
        run *= dims[i][1]
        i += 1
    starts = np.zeros(1, np.int64)
    for st, n in dims[i:]:
        starts = (starts[:, None]
                  + np.arange(n, dtype=np.int64)[None, :] * st).ravel()
    return starts * es, run * es, repeat


def _spread(hist: np.ndarray, off: float, nbytes: float, mass: float,
            size: int) -> None:
    """``mass`` spread over the equal-width bins that the byte span [off,
    off + nbytes) of an object of ``size`` bytes covers, by overlap: the
    reference's ``XlaCostAnalysisSource`` arithmetic, step for step."""
    n_bins = len(hist)
    width = size / n_bins
    lo_b = off / width
    hi_b = (off + nbytes) / width
    lo_i = int(np.floor(lo_b))
    hi_i = min(int(np.ceil(hi_b)), n_bins)
    for b in range(lo_i, max(hi_i, lo_i + 1)):
        if b >= n_bins:
            break
        overlap = min(hi_b, b + 1) - max(lo_b, b)
        if overlap > 0:
            hist[b] += mass * overlap / max(hi_b - lo_b, 1e-12)


class _Recorder(TorchDispatchMode):
    """Charges every non-view aten op's tensor arguments, and each kernel
    wrapper's reported operands once a call (the ops inside the wrapper
    not), to ``uses``: object name -> {(offset, bytes): uses}."""

    def __init__(self, spans: Dict[int, List[Tuple[int, int, str, int]]]):
        super().__init__()
        self.spans = spans
        self.uses: Dict[str, Dict[Tuple[int, int], int]] = {}
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth == 0 and not func.is_view:
            for t in _tree.leaves([list(args), kwargs]):
                self.charge(t)
        return func(*args, **kwargs)

    def kernel_call(self, operands, fn, args, kwargs):
        self.depth += 1
        try:
            out = fn(*args, **kwargs)
            if self.depth == 1:
                reads, writes = operands(*args, out=out, **kwargs)
                for t in (*reads, *writes):
                    self.charge(t)
        finally:
            self.depth -= 1
        return out

    def charge(self, t: Any) -> None:
        """One use of the bytes ``t`` covers, on the registered leaves that
        share its storage."""
        if not isinstance(t, torch.Tensor) or t.numel() == 0:
            return
        entries = self.spans.get(t.untyped_storage().data_ptr())
        if not entries:
            return
        starts, run, repeat = _runs(t)
        starts = starts + t.storage_offset() * t.element_size()
        for lo, hi, name, off in entries:
            a = np.clip(starts, lo, hi)
            b = np.clip(starts + run, lo, hi)
            keep = b > a
            uses = self.uses.setdefault(name, {})
            for s, e in zip(a[keep].tolist(), b[keep].tolist()):
                key = (off + s - lo, e - s)
                uses[key] = uses.get(key, 0) + repeat

    def __enter__(self):
        self._outer = _record.recorder
        _record.recorder = self
        return super().__enter__()

    def __exit__(self, *exc):
        _record.recorder = self._outer
        return super().__exit__(*exc)


class OperandAttributionSource:
    """Per-op operand footprints of a recorded run, mapped onto the
    registered objects' leaf byte spans: the counterpart of the reference's
    ``XlaCostAnalysisSource`` (its interface and arithmetic), for a program
    that runs eagerly.

    :meth:`record` runs a phase's code under a ``TorchDispatchMode``: each
    aten op charges the bytes of every tensor argument it takes, reads and
    writes alike (views, which move no bytes, charge nothing).  A
    hand-written kernel's wrapper charges, once a call, the tensors it
    reports reading and writing (:mod:`..record`), and the ops it
    runs inside the call charge nothing: on the CPU those are its plain
    version, on the card a ctypes launch the dispatcher never sees, so both
    devices charge a step the same bytes.

    Each operand is mapped onto the registered objects by its storage and
    byte range; the payloads are looked up in the registry when the
    recording starts (the async mover swaps them, P3).  An operand charges
    its own bytes to the byte range it covers: a view of one layer's
    weights, or the cache rows 0..length that ``decode_attention`` reads.
    A whole-leaf operand then gets exactly the reference's charge, its
    bytes once a use (ROADMAP P13: per-op uses of a run, where the
    reference counts XLA's textual uses after fusion).

    ``edges="uniform"`` (default) spreads each charged span over ``n_bins``
    equal-width bins; ``edges="leaf"`` gives a :class:`Histogram` with one
    variable-width bin per registered leaf span.  ``accesses`` are bytes
    over the machine's cache line."""

    def __init__(self, session: Any, *, n_bins: int = 64,
                 edges: str = "uniform"):
        if edges not in ("uniform", "leaf"):
            raise ValueError(f"edges must be 'uniform' or 'leaf', "
                             f"got {edges!r}")
        self.registry = session.registry
        self.machine = session.machine
        self.n_bins = int(n_bins)
        self.edges = edges
        self._samples: Dict[str, PhaseSample] = {}

    def _storage_spans(self) -> Dict[int, List[Tuple[int, int, str, int]]]:
        """storage address -> [(first byte, end byte) in the storage, object
        name, the leaf's offset in the object] of every registered leaf."""
        spans: Dict[int, List[Tuple[int, int, str, int]]] = {}
        for obj in self.registry:
            if obj.payload is None or not obj.leaf_spans:
                continue
            for leaf, (_, off, nbytes) in zip(_tree.leaves(obj.payload),
                                              obj.leaf_spans):
                if not isinstance(leaf, torch.Tensor) or leaf.is_meta:
                    continue
                lo = leaf.storage_offset() * leaf.element_size()
                spans.setdefault(leaf.untyped_storage().data_ptr(), []).append(
                    (lo, lo + nbytes, obj.name, off))
        return spans

    @contextlib.contextmanager
    def record(self, phase_name: str, *, elapsed: Optional[float] = None):
        """Record the code run inside as one execution of ``phase_name``;
        its sample is stored when the block ends (:meth:`collect`)."""
        rec = _Recorder(self._storage_spans())
        with rec:
            yield
        self._samples[phase_name] = self._sample(rec.uses, elapsed)

    def _sample(self, uses: Dict[str, Dict[Tuple[int, int], int]],
                elapsed: Optional[float]) -> PhaseSample:
        footprint: Dict[str, float] = {}
        access_bins: Dict[str, Any] = {}
        for name, spans in uses.items():
            obj = self.registry[name]
            size = max(obj.size_bytes, 1)
            leaves = obj.leaf_spans or [("", 0, obj.size_bytes)]
            starts = [off for _, off, _ in leaves]
            hist = np.zeros(self.n_bins)
            leaf_mass: Dict[int, float] = {}
            for (off, nbytes), n in sorted(spans.items()):
                mass = float(nbytes) * n
                footprint[name] = footprint.get(name, 0.0) + mass
                if self.edges == "leaf":
                    leaf = starts[bisect.bisect_right(starts, off) - 1]
                    leaf_mass[leaf] = leaf_mass.get(leaf, 0.0) + mass
                else:
                    _spread(hist, off, nbytes, mass, size)
            if self.edges == "leaf":
                h = _leaf_histogram(obj, leaf_mass)
                if h is not None:
                    access_bins[name] = h
            elif float(hist.sum()) > 0.0:
                access_bins[name] = hist.tolist()
        line = float(getattr(self.machine, "cacheline_bytes", 64))
        return PhaseSample(
            accesses={n: fp / line for n, fp in footprint.items()},
            access_bins=access_bins or None, elapsed=elapsed)

    def collect(self, phase_name: str) -> PhaseSample:
        return self._samples.get(phase_name, PhaseSample())


def _leaf_histogram(obj: Any, leaf_mass: Dict[int, float]
                    ) -> Optional[Histogram]:
    """One variable-width bin per registered leaf span, each leaf's charge
    in its own bin (the reference's ``_leaf_histogram``)."""
    size = max(obj.size_bytes, 1)
    spans = obj.leaf_spans or [("", 0, obj.size_bytes)]
    edges, counts = [0.0], []
    for _, off, nbytes in spans:
        if nbytes <= 0:
            continue
        counts.append(leaf_mass.get(off, 0.0))
        edges.append(min((off + nbytes) / size, 1.0))
    if not counts or sum(counts) <= 0.0:
        return None
    edges[-1] = 1.0
    return Histogram(edges, counts)
