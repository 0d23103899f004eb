"""Unimem performance models — Eq. (1)-(5) of the paper, verbatim.

* Eq. (1) consumed-bandwidth estimate for a (phase, object) pair
* classification: bandwidth-sensitive (>= t1% of BW_peak), latency-sensitive
  (< t2%), mixed otherwise (benefit = max of the two models)
* Eq. (2) benefit for bandwidth-sensitive objects, with CF_bw
* Eq. (3) benefit for latency-sensitive objects, with CF_lat
* Eq. (4) movement cost with proactive overlap
* Eq. (5) knapsack weight w = BFT - COST - extra_COST

CF_bw / CF_lat are measured once per machine by running a STREAM-like and a
pointer-chasing-like calibration workload (paper §3.1.2) — see
:func:`calibrate` which runs them through the discrete-event simulator (the
platform stand-in on a CPU-only container).
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Dict, Mapping, Optional, Tuple

from .profiler import ObjectPhaseProfile
from .tiers import MachineProfile

T1_BANDWIDTH = 0.80   # paper: t1 = 80 (% of BW_peak)
T2_LATENCY = 0.10     # paper: t2 = 10 (% of BW_peak)


class Sensitivity(enum.Enum):
    BANDWIDTH = "bandwidth"
    LATENCY = "latency"
    MIXED = "mixed"


@dataclasses.dataclass(frozen=True)
class CalibrationConstants:
    """CF_bw / CF_lat (paper §3.1.2) plus the online-feedback state.

    The calibration feedback loop folds live predicted-vs-measured
    corrections *into the same constants* the static microbenchmarks
    produce: per-phase realized gains regress multiplicative corrections
    onto ``cf_bw`` / ``cf_lat`` (the two benefit classes can be
    mis-calibrated in opposite directions, and only a per-class fold can
    change the knapsack's ranking), while measured fence stalls calibrate
    ``cf_move`` — a movement-price scale applied to the Eq. (4)/eviction
    costs.  All folds are multiplicative, so at the defaults every benefit
    and cost value is bitwise identical to the pre-feedback model
    (``x * 1.0 == x`` for float64).  ``provenance`` records where each
    constant came from — a measured microbenchmark, a
    degenerate-denominator fallback, or an online fold — so a fallback or
    fold can never masquerade as a measured calibration."""

    cf_bw: float = 1.0
    cf_lat: float = 1.0
    cf_move: float = 1.0
    provenance: Tuple[str, ...] = ()


# --------------------------------------------------------------------------
# Eq. (1): BW_data_obj = (#data_access * cacheline) /
#          ((#samples_with_access / #samples) * phase_time)
# --------------------------------------------------------------------------
def consumed_bandwidth(p: ObjectPhaseProfile, machine: MachineProfile) -> float:
    frac = p.samples_with_access / max(p.n_samples, 1.0)
    denom = frac * p.phase_time
    if denom <= 0.0:
        return 0.0
    return p.accessed_bytes / denom


def classify(p: ObjectPhaseProfile, machine: MachineProfile,
             *, t1: float = T1_BANDWIDTH, t2: float = T2_LATENCY) -> Sensitivity:
    bw = consumed_bandwidth(p, machine)
    peak = machine.bw_peak
    if bw >= t1 * peak:
        return Sensitivity.BANDWIDTH
    if bw < t2 * peak:
        return Sensitivity.LATENCY
    return Sensitivity.MIXED


# --------------------------------------------------------------------------
# Eq. (2): BFT_bw = (#acc*line/NVM_bw - #acc*line/DRAM_bw) * CF_bw
# Eq. (3): BFT_lat = (#acc*NVM_lat - #acc*DRAM_lat) * CF_lat
# --------------------------------------------------------------------------
def benefit_bw(p: ObjectPhaseProfile, machine: MachineProfile,
               cf: CalibrationConstants) -> float:
    accessed = p.accessed_bytes
    return (accessed / machine.slow.bw - accessed / machine.fast.bw) * cf.cf_bw


def benefit_lat(p: ObjectPhaseProfile, machine: MachineProfile,
                cf: CalibrationConstants) -> float:
    return (p.data_access * machine.slow.lat
            - p.data_access * machine.fast.lat) * cf.cf_lat


def benefit(p: ObjectPhaseProfile, machine: MachineProfile,
            cf: CalibrationConstants,
            sensitivity: Optional[Sensitivity] = None) -> float:
    """BFT_data_obj for moving the object slow->fast for this phase."""
    s = sensitivity or classify(p, machine)
    if s is Sensitivity.BANDWIDTH:
        return benefit_bw(p, machine, cf)
    if s is Sensitivity.LATENCY:
        return benefit_lat(p, machine, cf)
    return max(benefit_bw(p, machine, cf), benefit_lat(p, machine, cf))


def gain_class(p: ObjectPhaseProfile, machine: MachineProfile,
               cf: CalibrationConstants) -> str:
    """Which benefit model a (phase, object) pair's gain is booked under:
    ``"bw"`` (Eq. 2) or ``"lat"`` (Eq. 3).  MIXED resolves to the model
    :func:`benefit` actually took the max from (ties go to bandwidth,
    matching the vectorized path) — the attribution key the calibration
    feedback uses to regress per-class realization factors."""
    s = classify(p, machine)
    if s is Sensitivity.BANDWIDTH:
        return "bw"
    if s is Sensitivity.LATENCY:
        return "lat"
    return ("bw" if benefit_bw(p, machine, cf) >= benefit_lat(p, machine, cf)
            else "lat")


def benefit_batch(data_access, n_samples, samples_with_access, phase_time,
                  cacheline_bytes, machine: MachineProfile,
                  cf: CalibrationConstants, return_class: bool = False):
    """Vectorized Eq. (1)-(3): classification + benefit for N profiles at
    once (the planner's hot path at chunk counts in the thousands).

    Element-for-element this performs the same float64 operations as the
    scalar :func:`benefit` path, so the two agree bitwise.  With
    ``return_class`` the resolved benefit class per element (0 = bw,
    1 = lat, mirroring :func:`gain_class`) is returned alongside the
    values — the calibration feedback's attribution key.
    """
    import numpy as np

    da = np.asarray(data_access, dtype=np.float64)
    ns = np.asarray(n_samples, dtype=np.float64)
    swa = np.asarray(samples_with_access, dtype=np.float64)
    pt = np.asarray(phase_time, dtype=np.float64)
    line = np.asarray(cacheline_bytes, dtype=np.float64)

    accessed = da * line
    denom = (swa / np.maximum(ns, 1.0)) * pt
    with np.errstate(divide="ignore", invalid="ignore"):
        bw = np.where(denom > 0.0, accessed / denom, 0.0)
    bft_bw = ((accessed / machine.slow.bw - accessed / machine.fast.bw)
              * cf.cf_bw)
    bft_lat = ((da * machine.slow.lat - da * machine.fast.lat)
               * cf.cf_lat)
    peak = machine.bw_peak
    vals = np.where(bw >= T1_BANDWIDTH * peak, bft_bw,
                    np.where(bw < T2_LATENCY * peak, bft_lat,
                             np.maximum(bft_bw, bft_lat)))
    if not return_class:
        return vals
    # class attribution mirroring :func:`gain_class`: MIXED resolves to
    # the winning model, ties to bandwidth
    cls = np.where(bw >= T1_BANDWIDTH * peak, 0,
                   np.where(bw < T2_LATENCY * peak, 1,
                            np.where(bft_lat > bft_bw, 1, 0)))
    return vals, cls


# --------------------------------------------------------------------------
# Eq. (4): COST = max(size/copy_bw - mem_comp_overlap, 0)
# --------------------------------------------------------------------------
def movement_cost(size_bytes: float, machine: MachineProfile,
                  overlap_window: float) -> float:
    return max(size_bytes / machine.copy_bw - overlap_window, 0.0)


def movement_cost_batch(size_bytes, machine: MachineProfile,
                        overlap_windows) -> np.ndarray:
    """Elementwise :func:`movement_cost` over aligned arrays — the same
    IEEE float64 expression (divide, subtract, clamp), so each element is
    bitwise equal to the scalar call."""
    import numpy as np
    return np.maximum(
        np.asarray(size_bytes, dtype=np.float64) / machine.copy_bw
        - np.asarray(overlap_windows, dtype=np.float64), 0.0)


# --------------------------------------------------------------------------
# Eq. (5): w = BFT - COST - extra_COST
# --------------------------------------------------------------------------
def weight(bft: float, cost: float, extra_cost: float = 0.0) -> float:
    return bft - cost - extra_cost


# --------------------------------------------------------------------------
# cross-host extension: per-link interconnect pricing.  Eq. (4) prices an
# intra-host tier move against the DRAM<->NVM copy engine; a shard pulled
# from a peer host instead crosses a modeled interconnect link with its
# own bandwidth, per-transfer setup latency, and a bounded number of
# concurrent send/recv channel pairs.  The coordinator compares the two
# prices when choosing between local NVM->DRAM promotion and a peer pull.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One directed interconnect link between two hosts.

    ``bandwidth`` is the sustained point-to-point rate in bytes/s (e.g.
    ``tiers.V5E_ICI_BW`` for on-pod ICI, ~25-50x less for DCN);
    ``latency`` the per-transfer setup cost in seconds (rendezvous +
    first-byte); ``channel_pairs`` how many concurrent send/recv pairs
    the link sustains at full rate (transfers beyond that queue)."""

    name: str
    bandwidth: float
    latency: float = 0.0
    channel_pairs: int = 1

    def __post_init__(self):
        if self.bandwidth <= 0:
            raise ValueError(f"link {self.name!r}: bandwidth must be > 0")
        if self.latency < 0 or self.channel_pairs < 1:
            raise ValueError(
                f"link {self.name!r}: latency must be >= 0 and "
                f"channel_pairs >= 1")


def link_transfer_time(size_bytes: float, link: LinkSpec) -> float:
    """Wire time for one shard over one send/recv pair: setup + stream."""
    return link.latency + size_bytes / link.bandwidth


def cross_host_cost(size_bytes: float, link: LinkSpec,
                    overlap_window: float = 0.0) -> float:
    """Eq. (4) analogue for a peer-host pull: the unhidden remainder of
    the link transfer after overlapping ``overlap_window`` seconds of
    compute.  The setup latency overlaps too — the rendezvous happens
    while compute runs, exactly like the copy engine's ramp."""
    return max(link_transfer_time(size_bytes, link) - overlap_window, 0.0)


class InterconnectModel:
    """The cluster's link table: host-pair -> :class:`LinkSpec`.

    Lookup is direction-aware with a symmetric fallback (most fabrics
    are full-duplex and symmetric; an asymmetric pair can still be
    registered per direction), and an optional ``default`` link prices
    pairs the table does not name — the "flat fabric" shorthand the sim
    uses for N virtual hosts on one switch."""

    def __init__(self, links: Optional[Mapping[Tuple[str, str],
                                               LinkSpec]] = None,
                 default: Optional[LinkSpec] = None):
        self._links: Dict[Tuple[str, str], LinkSpec] = dict(links or {})
        self.default = default

    def link(self, src: str, dst: str) -> LinkSpec:
        spec = self._links.get((src, dst)) or self._links.get((dst, src))
        if spec is None:
            spec = self.default
        if spec is None:
            raise KeyError(f"no interconnect link registered for "
                           f"{src!r} -> {dst!r} and no default")
        return spec

    def pairs(self) -> Dict[Tuple[str, str], LinkSpec]:
        return dict(self._links)

    def __repr__(self) -> str:
        return (f"InterconnectModel({len(self._links)} links, "
                f"default={self.default!r})")


# --------------------------------------------------------------------------
# CF calibration (paper §3.1.2): run a bandwidth-bound (STREAM-like) and a
# latency-bound (pointer-chasing-like) workload; CF = measured / predicted.
# --------------------------------------------------------------------------
def _cf_ratio(measured: float, predicted: float, name: str
              ) -> Tuple[float, str]:
    """measured/predicted with an *audited* fallback: a degenerate
    denominator yields CF=1.0, warns, and is recorded in provenance so it
    can never masquerade as a measured calibration."""
    if predicted <= 0.0:
        warnings.warn(
            f"calibrate: degenerate predicted time for {name} "
            f"(predicted={predicted!r}); falling back to CF=1.0",
            RuntimeWarning, stacklevel=3)
        return 1.0, f"{name}:fallback(predicted={predicted:g})"
    return measured / predicted, f"{name}:measured"


def solve_gain_folds(rows, *, ridge: float = 0.05, lo: float = 0.05,
                     hi: float = 20.0) -> Tuple[float, float]:
    """Per-class benefit realization factors from one measured iteration.

    ``rows`` holds one ``(booked_bw, booked_lat, realized)`` triple per
    phase: the plan's Eq. (2)/Eq. (3) gain booked for that phase, split by
    benefit class, and the gain the measurement realized (profiled
    baseline phase time minus measured phase time).  Because Eq. (2)/(3)
    are linear in the CFs, the multiplicative corrections ``(a, b)`` that
    would have made the prediction match solve the least-squares system
    ``a*booked_bw + b*booked_lat ≈ realized`` over the phases.

    A single scalar correction cannot do this: scaling both classes by
    the same factor preserves the knapsack's ranking, and the two classes
    are routinely mis-calibrated in *opposite* directions (a strict
    rotation's latency gains over-credit while its bandwidth gains are
    honest).  Phases with only one class booked pin that class's factor;
    the ridge term (scaled to the problem, pulling toward the neutral
    1.0) keeps a class nobody booked — or a degenerate, collinear system
    — at its current calibration instead of letting the solve invent a
    correction for it.  Results are clipped to ``[lo, hi]``."""
    s_bb = s_bl = s_ll = y_b = y_l = 0.0
    for g_bw, g_lat, realized in rows:
        s_bb += g_bw * g_bw
        s_bl += g_bw * g_lat
        s_ll += g_lat * g_lat
        y_b += g_bw * realized
        y_l += g_lat * realized
    lam = ridge * max(s_bb, s_ll)
    if lam <= 0.0:
        return 1.0, 1.0
    a11, a12, a22 = s_bb + lam, s_bl, s_ll + lam
    b1, b2 = y_b + lam, y_l + lam        # the prior pulls toward 1.0
    det = a11 * a22 - a12 * a12
    if det <= 0.0:
        return 1.0, 1.0
    a = (b1 * a22 - b2 * a12) / det
    b = (b2 * a11 - b1 * a12) / det
    clip = lambda x: min(max(x, lo), hi)
    return clip(a), clip(b)


def fold_online(cf: CalibrationConstants, *, gain_bw: float = 1.0,
                gain_lat: float = 1.0, move: float = 1.0,
                blend: float = 1.0, lo: float = 0.05, hi: float = 20.0,
                note: str = "") -> CalibrationConstants:
    """Fold one iteration's multiplicative corrections into the constants.

    ``gain_bw`` / ``gain_lat`` come from :func:`solve_gain_folds`;
    ``move`` is the measured-stall over booked-unhidden-cost ratio (the
    movement-price realization).  Each factor is EMA-blended toward 1.0
    (``blend`` = 1.0 applies it fully) and clipped to ``[lo, hi]`` so one
    noisy iteration can neither zero nor explode the model; ``cf_move``
    is additionally clipped cumulatively (its neutral point is an
    absolute 1.0, unlike the measured ``cf_bw``/``cf_lat``).  Returns
    ``cf`` unchanged (the same object) when every fold is a no-op."""
    def damp(m: float) -> float:
        m = 1.0 + blend * (m - 1.0)
        return min(max(m, lo), hi)

    f_bw, f_lat, f_move = damp(gain_bw), damp(gain_lat), damp(move)
    new_bw = cf.cf_bw * f_bw
    new_lat = cf.cf_lat * f_lat
    new_move = min(max(cf.cf_move * f_move, lo), hi)
    if (new_bw, new_lat, new_move) == (cf.cf_bw, cf.cf_lat, cf.cf_move):
        return cf
    tag = (f"online(bw*{f_bw:.3g},lat*{f_lat:.3g},move*{f_move:.3g}"
           f"{';' + note if note else ''})")
    return dataclasses.replace(
        cf, cf_bw=float(new_bw), cf_lat=float(new_lat),
        cf_move=float(new_move), provenance=cf.provenance + (tag,))


def calibrate(machine: MachineProfile, *, seed: int = 0) -> CalibrationConstants:
    """Measure CF_bw / CF_lat against the discrete-event simulator.

    Predicted time uses the same formulas the runtime will use online
    (accessed_bytes / fast_bw and accesses x fast_lat, per the paper); the
    "measured" time is the simulator executing the same access stream on the
    fast tier.  The ratio absorbs sampling loss and overlap effects.
    """
    from ..sim.engine import simulate_stream_time, simulate_chase_time
    from .profiler import PhaseProfiler
    from .phase import PhaseTraceEvent

    # ---- STREAM-like: touch 64 MiB sequentially on the fast tier ----------
    n_bytes = 64 * 1024 * 1024
    accesses = n_bytes / machine.cacheline_bytes
    measured_bw_time = simulate_stream_time(machine, n_bytes, tier="fast")
    prof = PhaseProfiler(machine, seed=seed)
    prof.observe(PhaseTraceEvent(phase_index=0, time=measured_bw_time,
                                 accesses={"stream": accesses}))
    p = prof.profile(0, "stream")
    predicted = (p.data_access * machine.cacheline_bytes) / machine.fast.bw
    cf_bw, prov_bw = _cf_ratio(measured_bw_time, predicted, "cf_bw")

    # ---- pChase-like: dependent accesses, single chain ---------------------
    n_chase = 1_000_000
    measured_lat_time = simulate_chase_time(machine, n_chase, tier="fast")
    prof2 = PhaseProfiler(machine, seed=seed + 1)
    prof2.observe(PhaseTraceEvent(phase_index=0, time=measured_lat_time,
                                  accesses={"chase": float(n_chase)}))
    p2 = prof2.profile(0, "chase")
    predicted_lat = p2.data_access * machine.fast.lat
    cf_lat, prov_lat = _cf_ratio(measured_lat_time, predicted_lat, "cf_lat")

    return CalibrationConstants(cf_bw=float(cf_bw), cf_lat=float(cf_lat),
                                provenance=(prov_bw, prov_lat))
