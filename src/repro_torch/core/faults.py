"""Fault injection and fault-tolerance primitives for the migration stack.

Real tiered hardware breaks the assumptions the copy path was built on:
NVM effective bandwidth collapses by an order of magnitude under
contention (Peng et al., arXiv 2002.06499), device transfers fail
transiently, and a wedged DMA engine can leave a handle that never
completes.  This module gives every layer a shared vocabulary for those
failures:

* **Typed copy errors** — :class:`CopyError` and its refinements
  (:class:`TransientCopyError`, :class:`CopyFailedError`,
  :class:`CopyTimeoutError`) — raised by backends, handled by the movers.
* :class:`FaultSpec` — a *seeded* description of an injected fault
  profile (deterministic: the same spec against the same issue sequence
  produces the same faults — chaos rows are as reproducible as the
  fault-free golden traces).
* :class:`ChaosBackend` — a decorator over any registered
  :class:`~.mover.TierBackend` (sim, channel-sim, jax_async, cpu_pool)
  that injects the spec's faults at the backend boundary, registered as
  ``"chaos"`` in :mod:`.backends`.
* :class:`ChannelHealth` — the per-channel health state machine
  (healthy -> degraded -> quarantined, with probation re-admittance) the
  slack mover feeds from observed faults and consults when choosing
  channels for fetches.
* :class:`DegradedServe` / :class:`EvictionRollback` — the fault events
  the mover emits and the session logs with provenance (iteration,
  phase, reason, channel).

With no :class:`FaultSpec` configured nothing in this module runs on the
hot path: the retry loop executes ``start_move`` exactly once, the
health machine has no faults to record, and every plan/trace stays
bitwise identical to the fault-free pipeline.
"""

from __future__ import annotations

import dataclasses
import random
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# typed copy errors (the bounded-wait / failure contract of TierBackend)
# ---------------------------------------------------------------------------
class CopyError(RuntimeError):
    """Base class for copy-path failures a mover can handle."""


class TransientCopyError(CopyError):
    """``start_move`` failed but a retry may succeed (driver hiccup,
    momentary channel exhaustion).  The mover retries with exponential
    backoff bounded by the move's slack deadline."""


class CopyFailedError(CopyError):
    """A copy errored at land time: the data never arrived and the
    object's tier did not flip.  Fetches demote to slow-tier service;
    evictions roll back residency."""


class CopyTimeoutError(CopyError, TimeoutError):
    """``wait(handle, timeout=...)`` exceeded its bound before the copy
    landed (the bounded-wait contract: a fence must never hang forever
    on a wedged channel)."""


# ---------------------------------------------------------------------------
# fault events (provenance-carrying, logged by the session)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DegradedServe:
    """A fetch that exhausted its retries or missed its deadline: the
    consuming phase served the object from the slow tier this iteration
    instead of blocking.  The monitor sees the slowdown as drift and the
    next replan re-prices the move."""

    obj: str
    phase_index: int            # the consuming phase that was demoted
    reason: str                 # retries_exhausted | deadline | late_fail
                                # | admission:cold | admission:over-quota
    channel: int = -1
    slack_s: float = 0.0
    iteration: int = -1         # stamped by the session when logged
    tenant: Optional[str] = None  # owning tenant namespace, if any
    host: Optional[str] = None    # owning cluster host, if any


@dataclasses.dataclass
class EvictionRollback:
    """An eviction copy that failed: the object's residency rolled back
    (it never left the fast tier), so tier accounting stays consistent —
    at the price of capacity the plan thought it had freed.  The session
    audit re-checks the capacity book after any of these."""

    obj: str
    phase_index: int
    reason: str                 # retries_exhausted | late_fail
    channel: int = -1
    iteration: int = -1
    tenant: Optional[str] = None  # owning tenant namespace, if any
    host: Optional[str] = None    # owning cluster host, if any


# ---------------------------------------------------------------------------
# bounded fault log
# ---------------------------------------------------------------------------
class FaultLog:
    """List-like ring buffer for session fault events.

    Long-running chaos/serving loops log a fault event per incident; an
    unbounded list grows without limit.  The ring keeps the most recent
    ``limit`` entries and counts the overwritten rest in :attr:`dropped`
    so provenance *counts* stay exact even after entries age out
    (``len(log) + log.dropped`` == total events ever logged).  A falsy
    limit (0/None) means unbounded."""

    def __init__(self, limit: Optional[int] = None):
        self.limit = int(limit) if limit else 0
        self._entries: deque = deque(maxlen=self.limit or None)
        self.dropped = 0

    def append(self, entry: Any) -> None:
        if self.limit and len(self._entries) >= self.limit:
            self.dropped += 1
        self._entries.append(entry)

    def clear(self) -> None:
        self._entries.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def __iter__(self):
        return iter(self._entries)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._entries)[idx]
        return self._entries[idx]

    def __repr__(self) -> str:
        return (f"FaultLog(len={len(self._entries)}, limit={self.limit}, "
                f"dropped={self.dropped})")


# ---------------------------------------------------------------------------
# channel health state machine
# ---------------------------------------------------------------------------
HEALTHY, DEGRADED, QUARANTINED = "healthy", "degraded", "quarantined"


class ChannelHealth:
    """Healthy -> degraded -> quarantined with probation re-admittance.

    A fault (straggler cancel, late failure, stuck handle) on a channel
    moves it one state down; ``quarantine_after`` consecutive faults
    quarantine it.  Quarantined channels are excluded from the fetch
    channel chooser (:meth:`avoid`) — except that every
    ``probation_interval``-th choose lets one quarantined channel
    through as a probe; a clean landing on a quarantined or degraded
    channel re-admits it one state up.  With no faults recorded the
    machine is empty and :meth:`avoid` returns the empty set, so the
    fault-free chooser is untouched."""

    def __init__(self, quarantine_after: int = 2,
                 probation_interval: int = 8):
        self.quarantine_after = max(1, quarantine_after)
        self.probation_interval = max(1, probation_interval)
        self._state: Dict[int, str] = {}
        self._strikes: Dict[int, int] = {}
        self._chooses = 0           # avoid() calls, drives probation cadence

    def state(self, channel: int) -> str:
        return self._state.get(channel, HEALTHY)

    def record_fault(self, channel: Optional[int]) -> None:
        if channel is None or channel < 0:
            return
        strikes = self._strikes.get(channel, 0) + 1
        self._strikes[channel] = strikes
        if strikes >= self.quarantine_after:
            self._state[channel] = QUARANTINED
        else:
            self._state[channel] = DEGRADED

    def record_success(self, channel: Optional[int]) -> None:
        if channel is None or channel < 0:
            return
        self._strikes[channel] = 0
        state = self._state.get(channel)
        if state == QUARANTINED:
            self._state[channel] = DEGRADED     # probation passed
        elif state == DEGRADED:
            self._state[channel] = HEALTHY

    def avoid(self) -> set:
        """Channels the fetch chooser must skip.  Every
        ``probation_interval``-th call re-admits the lowest-numbered
        quarantined channel for one probe copy."""
        quarantined = sorted(c for c, s in self._state.items()
                             if s == QUARANTINED)
        if not quarantined:
            return set()
        self._chooses += 1
        if self._chooses % self.probation_interval == 0:
            quarantined = quarantined[1:]       # probe the first one
        return set(quarantined)

    def summary(self) -> Dict[int, str]:
        return {c: s for c, s in sorted(self._state.items())
                if s != HEALTHY}


# ---------------------------------------------------------------------------
# fault specification
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded fault profile for :class:`ChaosBackend`.

    All rates are per-``start_move`` probabilities drawn from one
    ``random.Random(seed)`` stream, so a fixed spec against a
    deterministic issue sequence (the virtual-time simulator) reproduces
    the exact same fault pattern run over run.  Multi-host runs give
    each host its own sub-stream (see :func:`host_sub_seed`): a host's
    fault pattern depends only on its own issue sequence, never on how
    the cluster interleaves the hosts.
    """

    seed: int = 0
    #: P(start_move raises TransientCopyError) per attempt — retries
    #: re-roll, so a retry can succeed.
    transient_rate: float = 0.0
    #: P(a copy's handle never completes: ``is_done`` stays false,
    #: completion time goes to +inf, the channel wedges until cancelled).
    stuck_rate: float = 0.0
    #: P(a copy errors at land time: it occupies its channel for the
    #: full duration, then fails — the tier never flips).
    late_fail_rate: float = 0.0
    #: P(a copy opens a straggler window on its channel): bandwidth
    #: collapses by a factor sampled from ``straggler_factor`` for a
    #: duration sampled from ``straggler_duration_s``.
    straggler_rate: float = 0.0
    straggler_factor: Tuple[float, float] = (4.0, 16.0)
    straggler_duration_s: Tuple[float, float] = (0.05, 0.2)
    #: A permanently collapsed channel (the benchmark's "1 straggler
    #: channel" profile): every copy on it runs ``straggler_channel_factor``
    #: times slower.  None = no fixed straggler.
    straggler_channel: Optional[int] = None
    straggler_channel_factor: float = 8.0

    def any_faults(self) -> bool:
        return (self.transient_rate > 0 or self.stuck_rate > 0
                or self.late_fail_rate > 0 or self.straggler_rate > 0
                or self.straggler_channel is not None)


def host_sub_seed(seed: int, host: Optional[str]) -> int:
    """Deterministic per-host sub-seed for a shared cluster fault seed.

    ``None`` (the single-host path) returns ``seed`` unchanged, so
    existing chaos goldens are untouched.  Host ids hash through CRC-32
    (stable across processes and Python versions, unlike ``hash``), so
    two hosts sharing one :class:`FaultSpec` draw from independent
    streams and a host's faults do not depend on scheduling order."""
    if host is None:
        return int(seed)
    return int(seed) ^ zlib.crc32(str(host).encode("utf-8"))


# ---------------------------------------------------------------------------
# chaos backend decorator
# ---------------------------------------------------------------------------
def _obj_name(obj: Any) -> str:
    return getattr(obj, "name", None) or str(obj)


class ChaosBackend:
    """Fault-injecting decorator over any :class:`~.mover.TierBackend`.

    Forwards the full duck-typed backend surface (``start_move`` /
    ``wait`` / ``settle`` / ``complete`` / ``is_done`` / ``cancel`` /
    ``place`` / ``now_fn`` / ...) to the wrapped backend and injects the
    :class:`FaultSpec`'s faults at the boundary:

    * **transient**: ``start_move`` raises :class:`TransientCopyError`
      before touching the inner backend;
    * **stuck**: the issued handle never completes — its completion time
      is stretched to +inf (simulated backends; the channel wedges until
      the mover cancels it) or tagged so ``is_done`` stays false and
      ``wait`` raises :class:`CopyTimeoutError` (real backends);
    * **late failure**: the copy runs to its land time, then errors —
      ``settle`` retires it *without* a tier flip and
      ``complete``/``wait`` raise :class:`CopyFailedError`;
    * **straggler**: the copy's channel bandwidth collapses by a sampled
      factor (timed backends only — completion times are stretched and
      the channel stays busy accordingly).

    Timing faults (stuck/straggler stretching) need the simulated
    backends' ``start``/``done``/``channel`` handle surface; on real
    backends they degrade to the tag-based stuck path.  ``fault_log``
    records every injected fault as ``(kind, obj, channel)``.
    """

    def __init__(self, inner: Any, spec: Optional[FaultSpec] = None,
                 host: Optional[str] = None):
        self.inner = inner
        self.spec = spec or FaultSpec()
        #: owning cluster host (None on the single-host path).  Each
        #: host draws from its own seeded sub-stream, so a multi-host
        #: chaos run is deterministic regardless of host scheduling
        #: order — host A's faults never consume host B's draws.
        self.host = host
        self.rng = random.Random(host_sub_seed(self.spec.seed, host))
        self.fault_log: List[Tuple[str, str, int]] = []
        # open straggler windows: channel -> (start, end, factor)
        self._windows: Dict[int, Tuple[float, float, float]] = {}

    def __getattr__(self, name: str) -> Any:
        # anything not overridden (place, now_fn, machine, copies,
        # busy_seconds, max_concurrency, cancel, shutdown, ...) passes
        # straight through to the wrapped backend
        return getattr(self.inner, name)

    # ------------------------------------------------------------------ issue
    def _straggler_factor_for(self, channel: int, t: float) -> float:
        spec = self.spec
        if (spec.straggler_channel is not None
                and channel == spec.straggler_channel):
            return spec.straggler_channel_factor
        win = self._windows.get(channel)
        if win is not None and win[0] <= t < win[1]:
            return win[2]
        if spec.straggler_rate > 0 and self.rng.random() < spec.straggler_rate:
            f = self.rng.uniform(*spec.straggler_factor)
            d = self.rng.uniform(*spec.straggler_duration_s)
            self._windows[channel] = (t, t + d, f)
            return f
        return 1.0

    def _stretch(self, handle: Any, new_done: float) -> None:
        """Stretch a timed handle's completion and keep the wrapped
        engine's channel bookkeeping consistent (the channel stays busy
        for the stretched duration — a straggler slows its queue too)."""
        ch = getattr(handle, "channel", None)
        free = getattr(self.inner, "_free_at", None)
        if (free is not None and ch is not None
                and free[ch] <= handle.done + 1e-12):
            free[ch] = new_done
        handle.done = new_done

    def start_move(self, obj: Any, dst: str, after: Any = None,
                   avoid: Any = None, prefer: Any = None) -> Any:
        if (self.spec.transient_rate > 0
                and self.rng.random() < self.spec.transient_rate):
            self.fault_log.append(("transient", _obj_name(obj), -1))
            raise TransientCopyError(
                f"injected transient start_move failure: {_obj_name(obj)}"
                f" -> {dst}")
        kwargs = {}
        if after is not None:
            kwargs["after"] = after
        if avoid:
            kwargs["avoid"] = avoid
        if prefer:
            try:
                h = self.inner.start_move(obj, dst, prefer=prefer, **kwargs)
                return self._post_issue(obj, h)
            except TypeError:   # inner without tenant channel preference
                pass
        try:
            h = self.inner.start_move(obj, dst, **kwargs)
        except TypeError:       # inner without chaining / channel choice
            h = self.inner.start_move(obj, dst)
        return self._post_issue(obj, h)

    def _post_issue(self, obj: Any, h: Any) -> Any:
        if h is None:
            return None
        ch = getattr(h, "channel", None)
        start, done = getattr(h, "start", None), getattr(h, "done", None)
        if (self.spec.stuck_rate > 0
                and self.rng.random() < self.spec.stuck_rate):
            h._chaos_stuck = True
            if done is not None:
                self._stretch(h, float("inf"))
            self.fault_log.append(
                ("stuck", _obj_name(obj), ch if ch is not None else -1))
            return h
        if (self.spec.late_fail_rate > 0
                and self.rng.random() < self.spec.late_fail_rate):
            h._chaos_fail = True    # logged when it retires at land time
        if ch is not None and start is not None and done is not None:
            factor = self._straggler_factor_for(ch, start)
            if factor > 1.0:
                self._stretch(h, start + (done - start) * factor)
        return h

    # --------------------------------------------------------------- landing
    def settle(self, now: float = 0.0) -> None:
        """Retire due late-failing copies *without* a tier flip, then let
        the wrapped backend land the rest."""
        open_copies = (getattr(self.inner, "copies", None)
                       or getattr(self.inner, "_open", None) or ())
        for c in list(open_copies):
            if not getattr(c, "_chaos_fail", False) or getattr(c, "landed",
                                                               False):
                continue
            done = getattr(c, "done", None)
            if done is not None:
                due = done <= now
            else:
                probe = getattr(self.inner, "is_done", None)
                due = probe(c) if probe is not None else True
            if due:
                c.landed = True     # retired; tier never flips
                self.fault_log.append(
                    ("late_fail", _obj_name(getattr(c, "obj", "?")),
                     getattr(c, "channel", -1)))
        inner_settle = getattr(self.inner, "settle", None)
        if inner_settle is not None:
            inner_settle(now)

    def _raise_injected(self, handle: Any) -> None:
        if getattr(handle, "_chaos_stuck", False):
            raise CopyTimeoutError(
                f"injected stuck handle: {_obj_name(getattr(handle, 'obj', '?'))}"
                " never completes")
        if getattr(handle, "_chaos_fail", False):
            handle.landed = True    # retired; tier never flips
            self.fault_log.append(
                ("late_fail", _obj_name(getattr(handle, "obj", "?")),
                 getattr(handle, "channel", -1)))
            raise CopyFailedError(
                f"injected copy failure at land time: "
                f"{_obj_name(getattr(handle, 'obj', '?'))}")

    def wait(self, handle: Any, timeout: Optional[float] = None) -> Any:
        if handle is None:
            return 0.0
        self._raise_injected(handle)
        try:
            return self.inner.wait(handle, timeout=timeout)
        except TypeError:           # inner without the bounded-wait surface
            return self.inner.wait(handle)

    def complete(self, handle: Any) -> None:
        if handle is None:
            return
        self._raise_injected(handle)
        complete = getattr(self.inner, "complete", None)
        if complete is not None:
            complete(handle)
        else:
            self.inner.wait(handle)

    def is_done(self, handle: Any) -> bool:
        if handle is None:
            return True
        if getattr(handle, "_chaos_stuck", False):
            return False
        probe = getattr(self.inner, "is_done", None)
        if probe is not None:
            return probe(handle)
        done = getattr(handle, "done", None)
        now_fn = getattr(self.inner, "now_fn", None)
        if done is not None and now_fn is not None:
            return done <= now_fn()
        return True
