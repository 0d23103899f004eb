"""Multi-resolution access histograms (variable-width-bin span trees).

The profiler's per-(phase, object) address histograms used to be fixed-width
numpy arrays frozen at the instrumentation's bin count: the partitioner's
min-chunk floor was one instrumentation bin wide, and a coalesced chunk
could never re-split below that ceiling.  :class:`Histogram` replaces the
raw array with an explicit *variable-width* binning of the object's byte
range (fractional ``edges`` over [0, 1] plus per-bin ``counts``), so the
measured resolution can differ across the range — fine bins over the hot
head, coarse bins over the cold tail — under a bounded total bin budget.

**Adaptive refinement** (:meth:`refined`) re-bins the accumulated mass by
greedy equi-mass bisection: the heaviest span is split first, repeatedly,
until the bin budget is exhausted (or spans reach ``min_width``).  Hot
regions therefore gain resolution while cold regions implicitly coarsen to
pay for it — the rebuilt edge set *forgets* cold fine edges.  A freshly
split bin carries half its parent's mass (the piecewise-constant
assumption); the *next* profiling iteration's sampled observations then
fill the finer bins with true sub-structure, which is why refinement runs
between profiling iterations, not after the last one.

**Exact mass conservation** is the representation's contract: refinement,
coarsening and decay never create or destroy accumulated mass (the
property tests pin round-trips).  Splits assign exact binary halves;
re-binning redistributes by piecewise-constant integrals over a partition
of [0, 1].

**Legacy parity**: a histogram whose edges are the canonical uniform grid
takes the bitwise-identical arithmetic path of the pre-multi-res
fixed-width code (:func:`uniform_mass`), so disabling refinement
reproduces the old pipeline's plans exactly (the parity goldens in
``tests/test_histogram.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np


def uniform_mass(weights: Sequence[float], lo_frac: float,
                 hi_frac: float) -> float:
    """Integral of the piecewise-constant density described by ``weights``
    (relative weights over equal-width bins spanning [0, 1]) over the
    fractional range [lo_frac, hi_frac) — the legacy fixed-width-bin
    arithmetic, kept bit-identical (plans with refinement off must match
    the pre-multi-res pipeline exactly)."""
    w = np.asarray(weights, dtype=np.float64)
    total = w.sum()
    if total <= 0.0 or w.size == 0:
        return max(0.0, hi_frac - lo_frac)      # uniform fallback
    b = w.size
    lo = min(max(lo_frac, 0.0), 1.0) * b
    hi = min(max(hi_frac, 0.0), 1.0) * b
    if hi <= lo:
        return 0.0
    lo_i, hi_i = int(math.floor(lo)), int(math.ceil(hi))
    mass = w[lo_i:hi_i].sum()
    mass -= (lo - lo_i) * w[lo_i]                       # clip partial head
    if hi_i > hi:
        mass -= (hi_i - hi) * w[min(hi_i, b) - 1]       # clip partial tail
    return float(max(mass, 0.0) / total)


def _uniform_edges(n: int) -> np.ndarray:
    return np.arange(n + 1, dtype=np.float64) / n


class Histogram:
    """Variable-width-bin access histogram over an object's byte range.

    ``edges`` are strictly-increasing byte *fractions* with ``edges[0] == 0``
    and ``edges[-1] == 1``; ``counts[k]`` is the accumulated mass observed
    in ``[edges[k], edges[k+1])``.  Immutable by convention: every mutation
    returns a new instance (accumulation and decay in the profiler swap the
    stored reference)."""

    __slots__ = ("edges", "counts", "_uniform")

    def __init__(self, edges: Sequence[float], counts: Sequence[float]):
        e = np.asarray(edges, dtype=np.float64)
        c = np.asarray(counts, dtype=np.float64)
        if e.ndim != 1 or c.ndim != 1 or e.size != c.size + 1 or c.size == 0:
            raise ValueError("need n+1 edges for n >= 1 counts")
        if e[0] != 0.0 or e[-1] != 1.0 or np.any(np.diff(e) <= 0.0):
            raise ValueError("edges must increase strictly from 0.0 to 1.0")
        self.edges = e
        self.counts = c
        # canonical uniform grids take the legacy bitwise arithmetic path
        self._uniform = bool(np.array_equal(e, _uniform_edges(c.size)))

    # ------------------------------------------------------------ constructors
    @classmethod
    def uniform(cls, n_bins: int,
                counts: Optional[Sequence[float]] = None) -> "Histogram":
        """Equal-width histogram (the legacy representation's shape)."""
        if counts is None:
            counts = np.zeros(n_bins, dtype=np.float64)
        return cls(_uniform_edges(n_bins), counts)

    @classmethod
    def from_weights(cls, weights: Sequence[float]) -> "Histogram":
        """Wrap a legacy fixed-width weight array (instrumentation-native
        uniform bins) as a histogram."""
        w = np.clip(np.asarray(weights, dtype=np.float64), 0.0, None)
        return cls.uniform(w.size, w)

    # ------------------------------------------------------------------ basics
    @property
    def n_bins(self) -> int:
        return int(self.counts.size)

    def __len__(self) -> int:
        return self.n_bins

    @property
    def is_uniform(self) -> bool:
        return self._uniform

    @property
    def total(self) -> float:
        return float(self.counts.sum())

    @property
    def widths(self) -> np.ndarray:
        return np.diff(self.edges)

    @property
    def weights(self) -> np.ndarray:
        """Normalized per-bin mass (sums to 1; zeros when empty)."""
        t = self.counts.sum()
        return self.counts / t if t > 0.0 else np.zeros_like(self.counts)

    def same_edges(self, other: "Histogram") -> bool:
        return np.array_equal(self.edges, other.edges)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Histogram(n_bins={self.n_bins}, total={self.total:.3g}, "
                f"uniform={self._uniform})")

    # -------------------------------------------------------------------- mass
    def mass_fraction(self, lo_frac: float, hi_frac: float) -> float:
        """Fraction of total accumulated mass in [lo_frac, hi_frac) under
        the piecewise-constant density (uniform fallback when empty)."""
        if self._uniform:
            # bitwise-identical to the legacy flow, which normalized the
            # accumulated counts (the old ``bin_weights`` array) before
            # integrating — parity goldens depend on the exact arithmetic
            t = float(self.counts.sum())
            w = self.counts / t if t > 0.0 else self.counts
            return uniform_mass(w, lo_frac, hi_frac)
        lo = min(max(lo_frac, 0.0), 1.0)
        hi = min(max(hi_frac, 0.0), 1.0)
        total = self.counts.sum()
        if total <= 0.0:
            return max(0.0, hi - lo)
        if hi <= lo:
            return 0.0
        e = self.edges
        overlap = np.minimum(hi, e[1:]) - np.maximum(lo, e[:-1])
        frac = np.clip(overlap, 0.0, None) / np.diff(e)
        return float(max((self.counts * frac).sum(), 0.0) / total)

    def mass(self, lo_frac: float, hi_frac: float) -> float:
        """Absolute accumulated mass in [lo_frac, hi_frac)."""
        return self.mass_fraction(lo_frac, hi_frac) * self.total

    def finest_width(self, lo_frac: float = 0.0,
                     hi_frac: float = 1.0) -> float:
        """Width (byte fraction) of the narrowest bin overlapping
        [lo_frac, hi_frac) — the local measurement resolution, which bounds
        how finely the partitioner may meaningfully cut there."""
        lo = min(max(lo_frac, 0.0), 1.0)
        hi = min(max(hi_frac, 0.0), 1.0)
        if hi <= lo:
            return 1.0
        e = self.edges
        i = int(np.searchsorted(e, lo, side="right")) - 1
        j = int(np.searchsorted(e, hi, side="left"))
        i = max(i, 0)
        j = min(max(j, i + 1), e.size - 1)
        return float(np.diff(e[i:j + 1]).min())

    # ------------------------------------------------------------ accumulation
    def add(self, other: "Histogram") -> "Histogram":
        """Sum of two same-edged histograms (observation accumulation)."""
        if not self.same_edges(other):
            raise ValueError("cannot add histograms with different edges")
        return Histogram(self.edges, self.counts + other.counts)

    def scaled(self, factor: float) -> "Histogram":
        """Decay: every bin's mass scaled by ``factor`` (shape preserved —
        mass conservation holds trivially per bin)."""
        return Histogram(self.edges, self.counts * factor)

    def project(self, truth: Union["Histogram", Sequence[float]]
                ) -> Optional[np.ndarray]:
        """Probability, per bin of *this* histogram's edges, that an
        observed address falls in the bin, given the true access density
        ``truth`` (a legacy uniform weight array or another histogram at
        the instrumentation's native resolution) — the multinomial
        p-vector the profiler's sampling model draws from.

        When the truth is a plain array matching this histogram's uniform
        grid, the p-vector is the legacy ``w / w.sum()`` bitwise (so the
        seeded RNG stream — and therefore every sampled count — is
        identical to the fixed-width code)."""
        if not isinstance(truth, Histogram):
            w = np.asarray(truth, dtype=np.float64)
            if w.ndim != 1 or w.size == 0:
                return None
            w = np.clip(w, 0.0, None)
            total = w.sum()
            if total <= 0.0:
                return None
            if self._uniform and w.size == self.n_bins:
                return w / total            # legacy bitwise path
            truth = Histogram.uniform(w.size, w)
        if truth.total <= 0.0:
            return None
        # vectorized piecewise-constant integration: the cumulative mass is
        # piecewise linear in the truth's edges, so one np.interp at the
        # target edges replaces a per-bin mass_fraction loop (the sampling
        # hot path runs once per observation)
        cum = np.concatenate([[0.0], np.cumsum(truth.counts)])
        p = np.diff(np.interp(self.edges, truth.edges, cum))
        p = np.clip(p, 0.0, None)
        s = p.sum()
        if s <= 0.0:
            return None
        return p / s

    # -------------------------------------------------------------- refinement
    def rebinned(self, edges: Sequence[float]) -> "Histogram":
        """Redistribute the accumulated mass onto a new edge set by
        piecewise-constant integration (exact conservation: the new bins
        partition [0, 1], so the masses sum to the old total)."""
        e = np.asarray(edges, dtype=np.float64)
        total = self.total
        counts = np.array([self.mass_fraction(lo, hi) * total
                           for lo, hi in zip(e[:-1], e[1:])])
        return Histogram(e, counts)

    def refined(self, budget: int, *, min_width: float = 1.0 / 4096,
                hot_ratio: float = 2.0) -> "Histogram":
        """One adaptive refinement pass over the current bins (span-tree
        split/merge — the existing edges are *evolved*, never rebuilt, so
        repeated refinement converges instead of diffusing accumulated
        mass):

        * every *hot* bin — mass above ``hot_ratio`` x the budget-average —
          splits at its midpoint, each half keeping exactly half the mass
          (information-neutral: the next profiling iteration's sampled
          addresses fill in the true sub-structure);
        * while over ``budget``, the adjacent pair with the least combined
          mass merges (cold regions coarsen to pay for hot refinement;
          freshly split halves are exempt, so a split cannot be undone in
          the same pass).

        Mass is conserved exactly (binary halves, pairwise sums).  Returns
        ``self`` unchanged when no bin qualifies — callers use edge
        equality to decide whether the resolution epoch advances.  Once
        every bin's mass sits below the hot threshold (or hot bins reach
        ``min_width``), the edge set is a fixed point."""
        total = self.total
        if total <= 0.0 or budget < 1:
            return self
        thresh = hot_ratio * total / budget
        edges: List[float] = list(self.edges)
        counts: List[float] = list(self.counts)
        fresh: List[bool] = [False] * len(counts)

        def merge_coldest(exclude: Optional[int] = None) -> Optional[int]:
            cands = [k for k in range(len(counts) - 1)
                     if not (fresh[k] or fresh[k + 1])
                     and k != exclude and k + 1 != exclude]
            if not cands:
                return None
            k = min(cands, key=lambda k: (counts[k] + counts[k + 1],
                                          edges[k]))
            counts[k:k + 2] = [counts[k] + counts[k + 1]]
            fresh[k:k + 2] = [False]
            del edges[k + 1]
            return k

        # 1) coarsen into budget (instrumentation finer than the budget)
        while len(counts) > budget:
            if merge_coldest() is None:
                break
        # 2) split hot bins hottest-first, paying for each split with a
        #    cold merge once at budget — the bin count never exceeds it
        while True:
            best = None
            for k in range(len(counts)):
                if fresh[k] or counts[k] <= thresh:
                    continue
                if edges[k + 1] - edges[k] <= 2.0 * min_width:
                    continue
                if best is None or counts[k] > counts[best]:
                    best = k
            if best is None:
                break
            if len(counts) >= budget:
                m = merge_coldest(exclude=best)
                if m is None:
                    break
                if m < best:
                    best -= 1
            mid = (edges[best] + edges[best + 1]) / 2.0
            half = counts[best] / 2.0
            edges.insert(best + 1, mid)
            counts[best:best + 1] = [half, half]
            fresh[best:best + 1] = [True, True]
        e = np.asarray(edges)
        if np.array_equal(e, self.edges):
            return self
        return Histogram(e, counts)
