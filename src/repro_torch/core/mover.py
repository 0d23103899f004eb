"""Proactive data movement (paper §3.1.2 "cost", §3.3 "implementation").

The paper uses a helper thread and a shared FIFO queue: the main thread
enqueues movement requests at trigger points; the helper thread performs them
in the background; phase entry fences the moves that phase depends on.

Here the "helper thread" is whatever the backend provides:

* :class:`TorchTierBackend` / :class:`AsyncTorchTierBackend` — real
  tensors copied between HBM and pinned host memory on CUDA copy streams
  (one stream per channel).  The copy engine runs in the background
  exactly like the paper's helper thread; the fence is the copy's
  ``torch.cuda.Event``.
* :class:`SimTierBackend` — a simulated copy engine with a FIFO service
  queue, used by the discrete-event simulator and the benchmarks.
* :class:`ChannelSimBackend` — a simulated *multi-channel* copy engine:
  up to N copies in flight at once, sharing the engine's aggregate
  bandwidth; tier flips only when a copy lands (no phase may consume an
  object mid-flight).
* :class:`CpuPoolBackend` — a host-side ``memcpy`` thread pool: each move
  copies the object's (numpy/host) leaves on a worker thread, duck-typing
  the same ``settle``/``complete``/``is_done``/``start_move(after=)``
  scheduler surface as the async backends — tier flips only when the
  worker finishes and the copy is settled or fenced.

Two movers execute a placement program (the
:class:`~.policy.PlanProgram` IR — or any
:class:`~.planner.PlacementPlan`, which the IR subsumes) against a
backend:

* :class:`ProactiveMover` — the paper's baseline: a FIFO queue serviced in
  plan order, fences only at phase boundaries.
* :class:`SlackAwareMover` — the overlap engine: walks the plan's emitted
  schedule, computes per-move slack (latest start such that the object lands
  before its first consuming phase), releases moves most-urgent-first onto
  the channels, and consumes ``chunkable`` objects chunk-by-chunk so early
  chunks are read from the fast tier while later chunks are still in flight
  (double buffering).  Fence stalls appear only when slack is truly
  exhausted.

**The backend contract** (duck-typed; :class:`TierBackend` is the minimal
protocol):

* ``start_move(obj, dst) -> handle`` issues one asynchronous copy.  It may
  raise :class:`~.faults.TransientCopyError` — the movers retry with
  exponential backoff bounded by the move's slack deadline.  Optional
  keywords: ``after=`` chains the copy behind a predecessor handle,
  ``avoid=`` is a set of channels the chooser must skip (quarantined
  channels; see :class:`~.faults.ChannelHealth`), ``prefer=`` is the set
  of channels the copy's tenant owns under a bandwidth partition (the
  chooser favors them but borrows idle foreign channels
  work-conservingly; see :mod:`~.tenancy`).
* ``wait(handle, timeout=None)`` is the **bounded-wait contract**: with a
  timeout it must raise :class:`~.faults.CopyTimeoutError` instead of
  blocking past the bound (simulated backends compare the remaining
  virtual stall against the timeout; real backends poll readiness against
  a wall-clock deadline).  With ``timeout=None`` the legacy blocking
  behavior is preserved.  ``wait``/``complete`` raise
  :class:`~.faults.CopyFailedError` for a copy that errored at land time —
  the tier never flips, so a failed eviction's residency rolls back and a
  failed fetch demotes to slow-tier service.
* Backends with in-flight semantics additionally expose ``settle(now)``
  (land finished copies without blocking), ``complete(handle)``,
  ``is_done(handle)``, and optionally ``cancel(handle)`` (abort an
  in-flight copy without a tier flip — straggler reissue and deadline
  abandonment need it).

Failure handling lives in the movers (not the session): per-move retry
with slack-bounded exponential backoff, straggler detection
(in-flight time exceeding ``straggler_factor`` times the priced copy
time) with cancel-and-reissue on a different channel, a per-channel
health state machine feeding the channel chooser, and demotion of
undeliverable fetches to :class:`~.faults.DegradedServe` events the
session logs and the monitor treats as drift.  All of it is inert
without injected faults: the retry loop runs ``start_move`` once, the
health machine stays empty, and traces are bitwise identical.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Protocol

import torch

from .. import _tree
from .data_objects import DataObject, ObjectRegistry
from .faults import (ChannelHealth, CopyError, CopyTimeoutError,
                     DegradedServe, EvictionRollback, TransientCopyError)
from .phase import PhaseGraph
from .planner import MoveOp, PlacementPlan, ScheduledMove
from .tenancy import tenant_of
from .tiers import MachineProfile


class TierBackend(Protocol):
    """Minimal copy-backend protocol (full contract in the module
    docstring): ``wait`` honors the bounded-wait contract — with a
    ``timeout`` it raises :class:`~.faults.CopyTimeoutError` instead of
    blocking past the bound."""

    def start_move(self, obj: DataObject, dst: str) -> Any: ...
    def wait(self, handle: Any, timeout: Optional[float] = None) -> Any: ...


# ---------------------------------------------------------------------------
def _require_cuda(obj: DataObject) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"moving the payload of {obj.name!r} between HBM and pinned host "
            "memory needs CUDA; drive the runtime with backend='sim' on a "
            "machine without a card")


@dataclasses.dataclass
class _TorchCopy:
    """One in-flight copy of a whole object's leaves on one copy stream.

    ``sources`` holds the leaves being copied from until the copy lands,
    so the caching allocator cannot hand their memory to anyone else
    while the copy engine still reads it."""

    obj: DataObject
    dst: str
    leaves: List[Any]
    treedef: Any
    sources: List[Any]
    event: Any                  # torch.cuda.Event recorded after the copy
    channel: int = 0
    landed: bool = False


class TorchTierBackend:
    """Moves real tensors between HBM (the fast tier, CUDA tensors) and
    pinned host memory (the slow tier, CPU tensors allocated with
    ``pin_memory=True``) with ``copy_(non_blocking=True)`` on dedicated
    copy streams, one :class:`torch.cuda.Stream` per channel.

    Blocking flavour: the object's payload and tier flip when the copy is
    issued (the consuming stream is ordered behind the copy's event), and
    :meth:`wait` fences the copy on the host.  A payload-free object
    (registered with ``manage_payload=False``) flips its tier logically.
    A real payload move without CUDA raises: there is no silent fallback."""

    def __init__(self, machine: MachineProfile, channels: int = 1):
        self.machine = machine
        self.n_channels = max(1, int(channels))
        self._streams: Optional[List[Any]] = None
        self._next_channel = 0

    def _stream(self, channel: int):
        if self._streams is None:
            self._streams = [torch.cuda.Stream()
                             for _ in range(self.n_channels)]
        return self._streams[channel]

    def _issue(self, obj: DataObject, dst: str) -> _TorchCopy:
        """Issue the copy of every leaf not already on ``dst``'s device on
        the next channel's stream, behind all work queued so far on the
        current stream (which may still be writing the sources)."""
        _require_cuda(obj)
        channel = self._next_channel
        self._next_channel = (channel + 1) % self.n_channels
        stream = self._stream(channel)
        stream.wait_stream(torch.cuda.current_stream())
        sources, treedef = _tree.flatten(obj.payload)
        moved = []
        for src in sources:
            on_fast = src.is_cuda
            if (dst == "fast") == on_fast:
                moved.append(src)
                continue
            if dst == "fast":
                out = torch.empty(src.shape, dtype=src.dtype, device="cuda")
                out.record_stream(stream)
            else:
                out = torch.empty(src.shape, dtype=src.dtype, device="cpu",
                                  pin_memory=True)
            with torch.cuda.stream(stream):
                out.copy_(src, non_blocking=True)
            moved.append(out)
        event = torch.cuda.Event()
        event.record(stream)
        return _TorchCopy(obj, dst, moved, treedef, sources, event, channel)

    def start_move(self, obj: DataObject, dst: str) -> Any:
        if obj.payload is None:
            obj.tier = dst
            return None
        h = self._issue(obj, dst)
        torch.cuda.current_stream().wait_event(h.event)
        obj.payload = _tree.unflatten(h.treedef, h.leaves)
        obj.tier = dst
        return h

    @staticmethod
    def _wait_event(h: _TorchCopy, timeout: Optional[float]) -> None:
        """Fence one copy; with a timeout, poll the event against a
        monotonic deadline instead of blocking (bounded-wait contract)."""
        if timeout is None:
            h.event.synchronize()
            return
        deadline = _time.monotonic() + timeout
        while not h.event.query():
            if _time.monotonic() >= deadline:
                raise CopyTimeoutError(
                    f"copy of {h.obj.name} to {h.dst} still running after "
                    f"{timeout:.3f}s")
            _time.sleep(min(1e-3, timeout / 10))

    def wait(self, handle: Optional[_TorchCopy],
             timeout: Optional[float] = None) -> float:
        if handle is not None:
            self._wait_event(handle, timeout)
            handle.sources = []
        return 0.0              # real backend: the fence blocked, no stall


class AsyncTorchTierBackend(TorchTierBackend):
    """Asynchronous copies whose tier flip waits for the copy to land.

    The object keeps its old payload until the copy's event has fired;
    landing swaps in the copied leaves, flips the tier and drops the
    sources (so an eviction frees its HBM only once the bytes are safe on
    the host).  The scheduler surface the slack-aware mover duck-types on:

    * :meth:`settle` lands every copy whose event ``query()``\\ s true,
      without blocking;
    * :meth:`wait` / :meth:`complete` fence one copy (``wait`` honours
      ``timeout=``);
    * :meth:`is_done` probes one copy without blocking.
    """

    def __init__(self, machine: MachineProfile, channels: int = 1):
        super().__init__(machine, channels)
        self._open: List[_TorchCopy] = []

    def start_move(self, obj: DataObject, dst: str,
                   after: Optional[_TorchCopy] = None) -> Any:
        # ``after`` chains a fetch behind the eviction freeing its space:
        # issuing both at once would hold the outgoing and the incoming
        # bytes in HBM together (an OOM when the fast tier is sized near
        # capacity), so land the predecessor first.
        if after is not None and not after.landed:
            after.event.synchronize()
            self._land(after)
        if obj.payload is None:
            obj.tier = dst          # logical object: nothing to copy
            return None
        h = self._issue(obj, dst)
        self._open.append(h)
        return h

    def _land(self, h: _TorchCopy) -> None:
        if not h.landed:
            h.obj.payload = _tree.unflatten(h.treedef, h.leaves)
            h.obj.tier = h.dst
            h.landed = True
            h.sources = []
        try:
            self._open.remove(h)
        except ValueError:
            pass

    def wait(self, handle: Optional[_TorchCopy],
             timeout: Optional[float] = None) -> float:
        if handle is not None:
            self._wait_event(handle, timeout)
            self._land(handle)
        return 0.0

    def complete(self, handle: Optional[_TorchCopy]) -> None:
        self.wait(handle)

    def is_done(self, handle: Optional[_TorchCopy]) -> bool:
        """Non-blocking completion probe (the slack mover uses it to keep
        in-flight evictions off the critical path)."""
        return handle is None or handle.landed or handle.event.query()

    def settle(self, now: float = 0.0) -> None:
        """Land every copy whose event has fired — without blocking."""
        for h in list(self._open):          # _land prunes as it lands
            if h.event.query():
                self._land(h)

# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _PoolCopy:
    """One in-flight copy on the CPU memcpy pool."""

    obj: DataObject
    dst: str
    future: Any                 # concurrent.futures.Future -> copied leaves
    treedef: Any = None
    landed: bool = False


class CpuPoolBackend:
    """CPU ``memcpy`` thread pool — the host-memory analogue of the async
    device backends (ROADMAP: multi-backend copy engines).

    Each :meth:`start_move` submits the object's leaf copies to a worker
    pool and returns immediately; the worker materializes copied leaves
    (``np.array(leaf, copy=True)``) off the critical path.  Like the other
    in-flight backends, the object's ``tier`` (and its relocated payload)
    flips only when the finished copy is *landed* — by a non-blocking
    :meth:`settle`, or by the consuming fence's :meth:`wait`/:meth:`complete`.
    ``start_move(after=...)`` chains a fetch behind the eviction freeing
    its space: the worker blocks on the predecessor's future, never the
    caller.  Payload-free (logical) objects flip immediately, matching
    :class:`TorchTierBackend`."""

    def __init__(self, machine: MachineProfile, workers: int = 2):
        import concurrent.futures
        self.machine = machine
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="unimem-memcpy")
        self._open: List[_PoolCopy] = []

    @staticmethod
    def _copy_leaves(leaves: List[Any], predecessor: Optional[Any]) -> List[Any]:
        import numpy as np
        if predecessor is not None:
            predecessor.result()        # worker waits, caller never does
        return [l.clone() if isinstance(l, torch.Tensor)
                else np.array(l, copy=True) for l in leaves]

    def start_move(self, obj: DataObject, dst: str,
                   after: Optional[_PoolCopy] = None) -> Optional[_PoolCopy]:
        if self._pool is None:
            raise RuntimeError("CpuPoolBackend is shut down")
        if obj.payload is None:
            obj.tier = dst              # logical object: nothing to copy
            return None
        leaves, treedef = _tree.flatten(obj.payload)
        pred = after.future if (after is not None
                                and not after.landed) else None
        fut = self._pool.submit(self._copy_leaves, leaves, pred)
        h = _PoolCopy(obj, dst, fut, treedef)
        self._open.append(h)
        return h

    def _land(self, h: _PoolCopy) -> None:
        if not h.landed:
            h.obj.payload = _tree.unflatten(h.treedef, h.future.result())
            h.obj.tier = h.dst
            h.landed = True
        try:
            self._open.remove(h)
        except ValueError:
            pass

    def wait(self, handle: Optional[_PoolCopy],
             timeout: Optional[float] = None) -> float:
        if handle is not None:
            import concurrent.futures
            try:
                handle.future.result(timeout=timeout)
            except concurrent.futures.TimeoutError:
                raise CopyTimeoutError(
                    f"pool copy of {handle.obj.name} still running after "
                    f"{timeout:.3f}s") from None
            self._land(handle)
        return 0.0                      # real backend: the fence blocked

    def complete(self, handle: Optional[_PoolCopy]) -> None:
        self.wait(handle)

    def is_done(self, handle: Optional[_PoolCopy]) -> bool:
        return (handle is None or handle.landed
                or handle.future.done())

    def settle(self, now: float = 0.0) -> None:
        """Land every finished copy — without blocking."""
        for h in list(self._open):      # _land prunes as it lands
            if h.future.done():
                self._land(h)

    def shutdown(self, wait: bool = True) -> None:
        """Idempotent teardown: the first call releases the worker pool,
        every later call (including del-after-shutdown) is a no-op.
        Errors surface to the caller — only ``__del__`` swallows them,
        and only because interpreter teardown may have already torn down
        the executor machinery underneath us."""
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            pool.shutdown(wait=wait)

    def __del__(self):
        # sessions resolve backends through the registry and have no
        # teardown hook; without this, every discarded session would leak
        # its idle worker threads until interpreter exit
        try:
            self.shutdown(wait=False)
        except Exception:
            pass    # interpreter-exit race: executor already dismantled


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _SimCopy:
    obj: str
    dst: str
    size_bytes: int
    start: float = 0.0
    done: float = 0.0


class SimTierBackend:
    """FIFO copy engine for the discrete-event simulator.

    ``now_fn`` reads the simulation clock; completion times respect a single
    serial copy engine at ``machine.copy_bw`` (the paper's helper thread)."""

    def __init__(self, machine: MachineProfile, now_fn: Callable[[], float]):
        self.machine = machine
        self.now_fn = now_fn
        self._engine_free_at = 0.0
        self.copies: List[_SimCopy] = []

    def place(self, obj: DataObject, dst: str) -> None:
        """Allocation-time placement: no copy, the object starts in ``dst``
        (paper §3.2 initial placement happens at ``unimem_malloc``)."""
        obj.tier = dst

    def start_move(self, obj: DataObject, dst: str) -> _SimCopy:
        now = self.now_fn()
        start = max(now, self._engine_free_at)
        dur = obj.size_bytes / self.machine.copy_bw
        c = _SimCopy(obj.name, dst, obj.size_bytes, start, start + dur)
        self._engine_free_at = c.done
        self.copies.append(c)
        obj.tier = dst
        return c

    def wait(self, handle: _SimCopy, timeout: Optional[float] = None) -> float:
        """Returns the stall (seconds past ``now``) the fence must absorb.
        With a ``timeout``, a copy that would stall past the bound raises
        instead (virtual-time bounded-wait semantics)."""
        stall = max(0.0, handle.done - self.now_fn())
        if timeout is not None and stall > timeout:
            raise CopyTimeoutError(
                f"sim copy of {handle.obj} needs {stall:.4f}s "
                f"> timeout {timeout:.4f}s")
        return stall


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _ChannelCopy:
    """One in-flight copy on the multi-channel engine."""

    obj: DataObject
    dst: str
    size_bytes: int
    start: float
    done: float
    channel: int
    rate: float
    issued_at: float
    landed: bool = False


class ChannelSimBackend:
    """Simulated multi-channel copy engine.

    ``channels`` copies may be in flight concurrently, one per channel; a
    copy issued while ``k`` other channels are busy is served at
    ``copy_bw / (k+1)`` (the engine's aggregate bandwidth is shared among
    concurrent transfers; a lone copy gets the full engine, matching the
    FIFO baseline's service rate).  The rate is fixed at issue time, which
    keeps completion times deterministic and monotone in issue order per
    channel.

    **Prioritized channels** (CUDA-stream-style): ``priorities`` assigns
    each channel a priority class.  Bulk demotion traffic (evictions,
    ``dst == "slow"``) may only queue on the *minimum*-priority channels,
    while urgent fetches pick the earliest-free channel of any class — so
    a burst of evictions can never head-of-line-block the fetch a phase
    is about to fence on.  ``None`` (or all-equal priorities) reproduces
    the unprioritized engine exactly.

    Unlike :class:`SimTierBackend`, an object's ``tier`` flips only when its
    copy *lands* — callers advance landings with :meth:`settle` (at phase
    boundaries) or force completion with :meth:`complete` after absorbing a
    fence stall.  A phase can therefore never observe fast-tier service for
    data still in flight.
    """

    def __init__(self, machine: MachineProfile, now_fn: Callable[[], float],
                 channels: int = 2,
                 priorities: Optional[List[int]] = None):
        if channels < 1:
            raise ValueError("need at least one copy channel")
        self.machine = machine
        self.now_fn = now_fn
        self.channels = channels
        self.priorities = list(priorities) if priorities is not None else None
        if self.priorities is not None and len(self.priorities) != channels:
            raise ValueError(
                f"priorities must name every channel: got "
                f"{len(self.priorities)} for {channels} channels")
        if self.priorities is None or len(set(self.priorities)) <= 1:
            self._bulk_channels: List[int] = list(range(channels))
        else:
            lowest = min(self.priorities)
            self._bulk_channels = [c for c, p in enumerate(self.priorities)
                                   if p == lowest]
        self._free_at = [0.0] * channels
        self.copies: List[_ChannelCopy] = []

    def place(self, obj: DataObject, dst: str) -> None:
        """Allocation-time placement: no copy, the object starts in ``dst``
        (paper §3.2 initial placement happens at ``unimem_malloc``)."""
        obj.tier = dst

    def start_move(self, obj: DataObject, dst: str,
                   after: Optional[_ChannelCopy] = None,
                   avoid: Optional[set] = None,
                   prefer: Optional[frozenset] = None) -> _ChannelCopy:
        """Issue a copy on the earliest-free channel.  ``after`` delays the
        start until another copy lands (eviction -> incoming chaining: the
        incoming copy cannot begin until its space is free).  ``avoid``
        names channels the chooser must skip (quarantined by the mover's
        health machine) — ignored when it would leave no channel at all.
        ``prefer`` names the channels this copy's tenant *owns* (bandwidth
        partitioning): the chooser picks the earliest-free preferred
        channel, but work-conservingly borrows an *idle* non-preferred
        channel rather than queue behind a busy owned one — a tenant's
        reserved bandwidth shields it from others, never strands capacity.

        Contention: copies active while this one starts are re-rated to the
        equal share ``copy_bw / n`` (their completed bytes are preserved and
        their queued successors shift later), so the engine's aggregate
        bandwidth never exceeds ``copy_bw``.  Rates are not raised back when
        a copy finishes — a deterministic, slightly conservative model."""
        now = self.now_fn()
        # bulk demotions are confined to the minimum-priority channels;
        # fetches pick the earliest-free channel of any class
        allowed = self._bulk_channels if dst == "slow" else range(self.channels)
        if avoid:
            healthy = [c for c in allowed if c not in avoid]
            if healthy:
                allowed = healthy
        ch = min(allowed, key=lambda c: self._free_at[c])
        if prefer:
            pref = [c for c in allowed if c in prefer]
            if pref:
                owned = min(pref, key=lambda c: self._free_at[c])
                if self._free_at[owned] > now:
                    idle = [c for c in allowed if self._free_at[c] <= now]
                    ch = min(idle) if idle else owned
                else:
                    ch = owned
        start = max(now, self._free_at[ch])
        if after is not None:
            start = max(start, after.done)
        active = [c for c in self.copies
                  if not c.landed and c.channel != ch
                  and c.start <= start < c.done]
        rate = self.machine.copy_bw / (len(active) + 1)
        for c in active:
            if c.rate <= rate:
                continue
            remaining = (c.done - start) * c.rate
            delta = (start + remaining / rate) - c.done
            c.rate = rate
            self._shift_channel(c.channel, c.done, delta)
            c.done += delta
        dur = obj.size_bytes / rate
        copy = _ChannelCopy(obj, dst, obj.size_bytes, start, start + dur,
                            ch, rate, issued_at=now)
        self._free_at[ch] = max(self._free_at[ch], copy.done)
        self.copies.append(copy)
        return copy

    def _shift_channel(self, ch: int, from_time: float, delta: float) -> None:
        """Push the queued copies of ``ch`` (start >= from_time) later by
        ``delta`` — their predecessor just slowed down."""
        if delta <= 0:
            return
        for c in self.copies:
            if c.channel == ch and not c.landed and c.start >= from_time - 1e-12:
                c.start += delta
                c.done += delta
        self._free_at[ch] += delta

    def wait(self, handle: _ChannelCopy,
             timeout: Optional[float] = None) -> float:
        """Stall (seconds past ``now``) a fence on this copy must absorb.
        With a ``timeout``, a copy that would stall past the bound raises
        instead (virtual-time bounded-wait semantics; a stuck handle's
        infinite stall always raises)."""
        stall = max(0.0, handle.done - self.now_fn())
        if timeout is not None and stall > timeout:
            raise CopyTimeoutError(
                f"channel copy of {handle.obj.name} needs {stall:.4f}s "
                f"> timeout {timeout:.4f}s")
        return stall

    def cancel(self, handle: _ChannelCopy) -> bool:
        """Abort an in-flight copy: retired without a tier flip.  If the
        copy was its channel's tail (including a stuck copy wedging the
        channel at +inf), the channel frees immediately — this is how the
        mover un-wedges a quarantined channel."""
        if handle.landed:
            return False
        handle.landed = True
        aborted_at = max(self.now_fn(), handle.start)
        if self._free_at[handle.channel] <= handle.done:
            self._free_at[handle.channel] = aborted_at
        handle.done = aborted_at    # occupied the channel until aborted
        return True

    def complete(self, handle: _ChannelCopy) -> None:
        """Mark the copy landed (the caller absorbed any remaining stall).

        Earlier unlanded copies of the same object (a superseded
        direction-flip, e.g. an eviction the completing fetch was chained
        after) are retired without a tier flip — otherwise a later
        ``settle`` would apply their stale flip on top of this one."""
        if handle.landed:
            return
        for c in self.copies:
            if (not c.landed and c.obj is handle.obj
                    and c.done <= handle.done and c is not handle):
                c.landed = True
        handle.obj.tier = handle.dst
        handle.landed = True

    def settle(self, now: float) -> None:
        """Land every copy whose completion time has passed, in completion
        order (two in-flight copies of one object — an eviction chained
        into a re-fetch — must flip the tier in ``done`` order)."""
        for c in sorted((c for c in self.copies if not c.landed),
                        key=lambda c: c.done):
            if c.done <= now:
                c.obj.tier = c.dst
                c.landed = True

    def max_concurrency(self) -> int:
        """Peak number of copies simultaneously in flight (for invariants)."""
        events = []
        for c in self.copies:
            events.append((c.start, 1))
            events.append((c.done, -1))
        peak = cur = 0
        # at equal timestamps, land (-1) before launch (+1): back-to-back
        # copies on one channel are serial, not concurrent
        for _, delta in sorted(events, key=lambda e: (e[0], e[1])):
            cur += delta
            peak = max(peak, cur)
        return peak

    def busy_seconds(self) -> float:
        return sum(c.done - c.start for c in self.copies)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _CrossHostCopy:
    """One in-flight shard migration over an interconnect link."""

    obj: DataObject
    dst: str                    # destination *tier* on the destination host
    src_host: str
    dst_host: str
    size_bytes: int
    start: float
    done: float
    channel: int                # send/recv pair index on the link
    link_name: str
    landed: bool = False


class CrossHostBackend:
    """Simulated shard-migration engine over modeled interconnect links.

    Where :class:`ChannelSimBackend` models one host's DRAM<->NVM copy
    engine, this backend models the *fabric between hosts*: each
    directed host pair resolves to a :class:`~.perfmodel.LinkSpec`
    through an :class:`~.perfmodel.InterconnectModel`, and each link
    sustains ``channel_pairs`` concurrent **send/recv channel pairs** —
    a transfer occupies one sender-side and one receiver-side endpoint
    for its full wire time (``latency + size/bandwidth``), and transfers
    beyond the pair budget queue on the earliest-free pair, exactly like
    the intra-host engine's channels.

    The tier flip happens only at land time (``settle``/``complete``),
    and an optional ``on_land`` callback performs the cluster-level
    handoff (re-homing the object from the source host's registry to the
    destination's) — the backend itself stays pure virtual-time
    bookkeeping so it composes with :class:`~.faults.ChaosBackend` like
    any other registered backend.
    """

    def __init__(self, links: "InterconnectModel",
                 now_fn: Callable[[], float],
                 on_land: Optional[Callable[[_CrossHostCopy], None]] = None):
        self.links = links
        self.now_fn = now_fn
        self.on_land = on_land
        # (src_host, dst_host, pair) -> time the pair frees up
        self._free_at: Dict[tuple, float] = {}
        self.copies: List[_CrossHostCopy] = []

    def start_move(self, obj: DataObject, dst: str, *,
                   src_host: str, dst_host: str,
                   after: Optional[_CrossHostCopy] = None) -> _CrossHostCopy:
        """Issue one shard pull ``src_host`` -> ``dst_host`` landing in
        tier ``dst``; picks the link's earliest-free send/recv pair."""
        if src_host == dst_host:
            raise ValueError(
                f"cross-host move of {obj.name!r} needs distinct hosts, "
                f"got {src_host!r} on both ends")
        link = self.links.link(src_host, dst_host)
        now = self.now_fn()
        key_of = lambda pair: (src_host, dst_host, pair)
        ch = min(range(link.channel_pairs),
                 key=lambda p: self._free_at.get(key_of(p), 0.0))
        start = max(now, self._free_at.get(key_of(ch), 0.0))
        if after is not None:
            start = max(start, after.done)
        dur = link.latency + obj.size_bytes / link.bandwidth
        copy = _CrossHostCopy(obj, dst, src_host, dst_host, obj.size_bytes,
                              start, start + dur, ch, link.name)
        self._free_at[key_of(ch)] = copy.done
        self.copies.append(copy)
        return copy

    def wait(self, handle: _CrossHostCopy,
             timeout: Optional[float] = None) -> float:
        stall = max(0.0, handle.done - self.now_fn())
        if timeout is not None and stall > timeout:
            raise CopyTimeoutError(
                f"cross-host copy of {handle.obj.name} "
                f"({handle.src_host}->{handle.dst_host}) needs "
                f"{stall:.4f}s > timeout {timeout:.4f}s")
        return stall

    def cancel(self, handle: _CrossHostCopy) -> bool:
        if handle.landed:
            return False
        handle.landed = True
        aborted_at = max(self.now_fn(), handle.start)
        key = (handle.src_host, handle.dst_host, handle.channel)
        if self._free_at.get(key, 0.0) <= handle.done:
            self._free_at[key] = aborted_at
        handle.done = aborted_at
        return True

    def _land(self, copy: _CrossHostCopy) -> None:
        copy.obj.tier = copy.dst
        copy.landed = True
        if self.on_land is not None:
            self.on_land(copy)

    def complete(self, handle: _CrossHostCopy) -> None:
        if not handle.landed:
            self._land(handle)

    def settle(self, now: float) -> None:
        for c in sorted((c for c in self.copies if not c.landed),
                        key=lambda c: c.done):
            if c.done <= now:
                self._land(c)

    def is_done(self, handle: _CrossHostCopy) -> bool:
        return handle.landed or handle.done <= self.now_fn()

    def busy_seconds(self) -> float:
        return sum(c.done - c.start for c in self.copies)


def _handle_orphaned(registry: ObjectRegistry, name: str, handle: Any) -> bool:
    """True when an in-flight handle's object was retired from the
    registry — by name, or by identity when the handle carries the
    DataObject (a rebuild may re-register a merged chunk under the same
    name; the handle still points at the orphan)."""
    if name not in registry:
        return True
    dob = getattr(handle, "obj", None)
    return isinstance(dob, DataObject) and dob is not registry[name]


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MoveStats:
    n_moves: int = 0
    moved_bytes: int = 0
    fence_stall_s: float = 0.0
    overlapped_moves: int = 0
    # fault-tolerance counters (all zero on a fault-free run)
    n_retries: int = 0              # transient start_move failures retried
    n_degraded: int = 0             # fetches demoted to slow-tier service
    n_failed_evictions: int = 0     # evictions rolled back (residency kept)
    n_straggler_reissues: int = 0   # copies cancelled + reissued elsewhere

    @property
    def overlap_fraction(self) -> float:
        return self.overlapped_moves / self.n_moves if self.n_moves else 1.0


class ProactiveMover:
    """Executes a :class:`PlacementPlan` against a tier backend.

    * at the start of phase ``i``: fence moves with ``needed_by == i`` (they
      must have completed), then trigger moves whose ``trigger_phase`` maps to
      ``i`` (they run in the background toward their ``needed_by`` phase).
    """

    def __init__(self, registry: ObjectRegistry, backend: TierBackend,
                 retry_limit: int = 3):
        self.registry = registry
        self.backend = backend
        self.retry_limit = retry_limit
        self._inflight: Dict[str, Any] = {}     # obj -> handle
        self._queue: Deque[MoveOp] = deque()
        self.stats = MoveStats()
        #: DegradedServe / EvictionRollback events, drained by the session
        self.fault_events: List[Any] = []

    def _fault(self, m: MoveOp, phase_index: int, reason: str,
               channel: int = -1) -> None:
        if m.dst == "slow":
            self.stats.n_failed_evictions += 1
            self.fault_events.append(EvictionRollback(
                obj=m.obj, phase_index=phase_index, reason=reason,
                channel=channel))
        else:
            self.stats.n_degraded += 1
            self.fault_events.append(DegradedServe(
                obj=m.obj, phase_index=phase_index, reason=reason,
                channel=channel))

    def load_plan(self, plan: PlacementPlan, graph: Optional[PhaseGraph] = None
                  ) -> None:
        """Bind a freshly-built plan: drop in-flight handles whose object
        was retired by the rebuild (a coalesce pass removes chunk objects
        and may re-register merged chunks under the *same names* — a
        stale handle would alias the orphaned object's copy onto the new
        chunk and silently swallow its first move)."""
        for name in list(self._inflight):
            if _handle_orphaned(self.registry, name, self._inflight[name]):
                self._inflight.pop(name)    # orphan lands in the background

    def on_phase_start(self, plan: PlacementPlan, phase_index: int,
                       n_phases: int) -> float:
        """Fence + trigger.  Returns fence stall seconds (sim backend) or 0."""
        stall = 0.0
        # 1. fence
        for m in plan.fences_for_phase(phase_index):
            h = self._inflight.pop(m.obj, None)
            if h is not None:
                try:
                    s = self.backend.wait(h)
                except CopyError:
                    # the copy never delivered: a fetch serves slow this
                    # iteration, a failed eviction keeps its residency
                    self._fault(m, phase_index, "late_fail",
                                getattr(h, "channel", -1))
                    continue
                if isinstance(s, (int, float)):
                    stall += float(s)
                    if s <= 0.0:
                        self.stats.overlapped_moves += 1
                else:
                    self.stats.overlapped_moves += 1
        self.stats.fence_stall_s += stall
        # 2. trigger
        for m in plan.moves_for_phase(phase_index, n_phases):
            obj = self.registry[m.obj]
            if obj.tier == m.dst:
                continue
            # dependency safety: never start moving an object the current
            # phase itself references unless the move is fenced right here.
            h = self._start_with_retry(obj, m, phase_index)
            if h is None and obj.tier != m.dst:
                continue            # retries exhausted (fault recorded)
            self.stats.n_moves += 1
            self.stats.moved_bytes += m.size_bytes
            if m.needed_by == phase_index:
                try:
                    s = self.backend.wait(h)
                except CopyError:
                    self._fault(m, phase_index, "late_fail",
                                getattr(h, "channel", -1))
                    continue
                if isinstance(s, (int, float)):
                    stall += float(s)
                    if s <= 0.0:
                        self.stats.overlapped_moves += 1
                else:
                    self.stats.overlapped_moves += 1
            else:
                self._inflight[m.obj] = h
        return stall

    def _start_with_retry(self, obj: DataObject, m: MoveOp,
                          phase_index: int) -> Optional[Any]:
        attempts = 0
        while True:
            try:
                return self.backend.start_move(obj, m.dst)
            except TransientCopyError:
                attempts += 1
                if attempts > self.retry_limit:
                    self._fault(m, phase_index, "retries_exhausted")
                    return None
                self.stats.n_retries += 1

    def drain(self) -> None:
        for obj, h in list(self._inflight.items()):
            try:
                self.backend.wait(h)
            except CopyError:
                pass                # draining: the copy's fate is recorded
            del self._inflight[obj]


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MoveRecord:
    """Audit record of one issued move (property tests consume these)."""

    obj: str
    dst: str
    trigger_phase: int
    needed_by: int
    size_bytes: int
    issued_at: float            # virtual time the scheduler released the move
    start: float                # virtual time the copy began on its channel
    done: float                 # virtual time the copy landed
    channel: int
    slack_s: float
    fenced_at: float = float("nan")   # virtual time of the consuming fence
    fence_stall_s: float = 0.0
    superseded: bool = False          # overwritten by a direction-flip move


class SlackAwareMover:
    """Slack-aware asynchronous migration scheduler.

    Lookahead over the plan's emitted schedule (:class:`ScheduledMove`): at
    each phase boundary the mover

    1. *settles* the backend — copies that landed flip their object's tier;
    2. *releases* the moves whose trigger window opens here, tightest slack
       first (ties broken by predicted benefit per byte), onto the backend's
       copy channels.  Evictions are released before fetches, and a fetch
       this same phase consumes is chained after the last eviction (its
       space is only free then — paper Fig 6);
    3. *fences* the moves this phase consumes.  Plain objects stall for the
       maximum remaining copy time; chunked objects are consumed chunk by
       chunk (chunk ``k``'s virtual consume point is the phase start plus
       the phase-time fraction of the sibling bytes preceding it), so a late
       chunk stalls only its own remainder — double buffering.  Evictions
       are never fenced: the phase does not read evicted data.

    Works against any :class:`TierBackend`; the timing-aware paths activate
    when the backend exposes the simulator's ``settle``/``complete``/``done``
    surface (blocking backends such as :class:`TorchTierBackend` fence with
    zero recorded stall, exactly like :class:`ProactiveMover`).
    """

    def __init__(self, registry: ObjectRegistry, backend: TierBackend,
                 graph: Optional[PhaseGraph] = None, retry_limit: int = 3,
                 straggler_factor: Optional[float] = None):
        self.registry = registry
        self.backend = backend
        self.graph = graph
        #: max transient-failure retries per move (beyond the slack bound)
        self.retry_limit = retry_limit
        #: in-flight copy exceeding ``straggler_factor`` x its priced time
        #: is cancelled and reissued on another channel; the same factor
        #: bounds fence waits (deadline abandonment).  ``None`` disables
        #: both — the fault-free default (contention alone legitimately
        #: slows sim copies by up to ``channels`` x).
        self.straggler_factor = straggler_factor
        self.health = ChannelHealth()
        #: tenant -> owned copy channels, from the plan's bandwidth
        #: partition (empty = no tenancy, chooser untouched)
        self.channel_prefs: Dict[str, frozenset] = {}
        #: DegradedServe / EvictionRollback events, drained by the session
        self.fault_events: List[Any] = []
        self._inflight: Dict[str, Any] = {}      # obj name -> handle
        self._records: Dict[str, MoveRecord] = {}  # obj name -> open record
        self.trace: List[MoveRecord] = []
        self.stats = MoveStats()

    # ------------------------------------------------------------------ utils
    def load_plan(self, plan: PlacementPlan, graph: PhaseGraph) -> None:
        """Bind the profiled phase graph (phase-time estimates for the
        chunk-consumption model and slack fallbacks), and drop in-flight
        handles whose object was retired by the rebuild (coalesced chunk
        names can be reused by merged chunks; a stale handle would match
        the new chunk's first move as 'already in flight' and swallow
        it)."""
        self.graph = graph
        self.channel_prefs = {
            t: frozenset(chs) for t, chs in
            (getattr(plan, "tenant_channels", None) or {}).items()}
        for name in list(self._inflight):
            if _handle_orphaned(self.registry, name, self._inflight[name]):
                self._inflight.pop(name)
                self._finish_record(name, float("nan"), 0.0, superseded=True)

    def _now(self) -> float:
        now_fn = getattr(self.backend, "now_fn", None)
        return now_fn() if now_fn is not None else 0.0

    def _done_of(self, handle: Any) -> Optional[float]:
        return getattr(handle, "done", None)

    def _complete(self, handle: Any) -> None:
        complete = getattr(self.backend, "complete", None)
        if complete is not None and handle is not None:
            complete(handle)

    def _count_fence(self, stall: float) -> None:
        if stall <= 1e-12:
            self.stats.overlapped_moves += 1

    # ------------------------------------------------------------- fault paths
    def _fault(self, obj: str, dst: str, phase_index: int, reason: str,
               channel: int = -1, slack_s: float = 0.0) -> None:
        """Record a failed move: an undeliverable fetch demotes to
        slow-tier service (DegradedServe), a failed eviction keeps its
        residency (EvictionRollback).  The session drains these."""
        if dst == "slow":
            self.stats.n_failed_evictions += 1
            self.fault_events.append(EvictionRollback(
                obj=obj, phase_index=phase_index, reason=reason,
                channel=channel))
        else:
            self.stats.n_degraded += 1
            self.fault_events.append(DegradedServe(
                obj=obj, phase_index=phase_index, reason=reason,
                channel=channel, slack_s=slack_s))

    def _fail_inflight(self, name: str, h: Any, phase_index: int,
                       reason: str, now: float) -> None:
        """Retire a failed/abandoned in-flight copy: fault event, channel
        strike, bookkeeping closed.  The tier never flipped, so the plan
        replay (or next replan) naturally reissues the move."""
        ch = getattr(h, "channel", -1)
        self.health.record_fault(ch if isinstance(ch, int) else -1)
        self._fault(name, getattr(h, "dst", "fast"), phase_index, reason,
                    ch if isinstance(ch, int) else -1)
        self._inflight.pop(name, None)
        self._finish_record(name, now, 0.0)

    def _deadline_for(self, size_bytes: int) -> Optional[float]:
        """Max fence wait for a copy of this size (straggler_factor x its
        priced full-bandwidth time); None = unbounded (fault-free mode)."""
        if self.straggler_factor is None:
            return None
        bw = getattr(getattr(self.backend, "machine", None), "copy_bw", 0.0)
        if not bw:
            return None
        return self.straggler_factor * (size_bytes / bw)

    def _cancel(self, handle: Any) -> bool:
        cancel = getattr(self.backend, "cancel", None)
        return bool(cancel(handle)) if cancel is not None else False

    @staticmethod
    def _service_exceeded(h: Any, deadline: Optional[float]) -> bool:
        """True when the copy's *service* time (channel occupancy) exceeds
        the deadline.  Queue wait is excluded on purpose: a copy delayed
        behind a long queue on a healthy channel is contention, not a
        fault, and striking its channel would cascade into quarantining
        the whole engine.  Non-finite times (a stuck handle, or a copy
        queued behind one on a wedged channel) always exceed."""
        if deadline is None:
            return False
        start, done = getattr(h, "start", None), getattr(h, "done", None)
        if start is None or done is None:
            return False
        if not math.isfinite(done) or not math.isfinite(start):
            return True
        return (done - start) > deadline

    def _prefer_for(self, name: str) -> Optional[frozenset]:
        """The channels this object's tenant owns under the plan's
        bandwidth partition, or None (no tenancy / unowned object)."""
        if not self.channel_prefs:
            return None
        t = tenant_of(name, self.channel_prefs)
        return self.channel_prefs.get(t) if t is not None else None

    def _start_move_raw(self, obj: DataObject, dst: str,
                        after: Any = None, avoid: Optional[set] = None,
                        prefer: Optional[frozenset] = None) -> Any:
        if prefer:
            try:
                if avoid:
                    return self.backend.start_move(obj, dst, after=after,
                                                   avoid=avoid, prefer=prefer)
                return self.backend.start_move(obj, dst, after=after,
                                               prefer=prefer)
            except TypeError:   # backend without tenant channel preference
                pass
        try:
            if avoid:
                return self.backend.start_move(obj, dst, after=after,
                                               avoid=avoid)
            return self.backend.start_move(obj, dst, after=after)
        except TypeError:       # backend without dependency chaining
            return self.backend.start_move(obj, dst)

    def _start_with_retry(self, entry: ScheduledMove, obj: DataObject,
                          after: Any, now: float) -> Optional[Any]:
        """Issue with exponential backoff on transient failures, bounded
        by the move's slack (a retry that would already land the copy
        late is pointless — demote instead) and by ``retry_limit``."""
        m = entry.op
        avoid = self.health.avoid()
        prefer = self._prefer_for(m.obj)
        b0 = max(1e-6, 0.1 * entry.duration_s)
        budget = max(entry.slack_s, b0)     # always worth one retry
        backoff, spent, attempts = b0, 0.0, 0
        while True:
            try:
                return self._start_move_raw(obj, m.dst, after, avoid, prefer)
            except TransientCopyError:
                attempts += 1
                spent += backoff
                if attempts > self.retry_limit or spent > budget:
                    self._fault(m.obj, m.dst, m.needed_by,
                                "retries_exhausted", slack_s=entry.slack_s)
                    return None
                self.stats.n_retries += 1
                backoff *= 2.0

    def _sweep_failures(self, phase_index: int, now: float) -> None:
        """Purge in-flight handles that late-failed (retired by the chaos
        settle with no tier flip): record the fault and drop them so the
        plan replay reissues instead of treating them as still pending."""
        for name, h in list(self._inflight.items()):
            if (getattr(h, "_chaos_fail", False)
                    and getattr(h, "landed", False)):
                self._fail_inflight(name, h, phase_index, "late_fail", now)

    def _detect_stragglers(self, phase_index: int, now: float) -> None:
        """Cancel-and-reissue copies stuck past their deadline: an
        in-flight copy that has been running ``straggler_factor`` x its
        priced time (including stuck handles at done=+inf) is aborted,
        its channel struck, and the copy reissued avoiding that channel."""
        f = self.straggler_factor
        if f is None:
            return
        bw = getattr(getattr(self.backend, "machine", None), "copy_bw", 0.0)
        if not bw:
            return
        for name, h in list(self._inflight.items()):
            start, done = getattr(h, "start", None), getattr(h, "done", None)
            if (start is None or done is None
                    or getattr(h, "landed", False) or done <= now):
                continue
            priced = getattr(h, "size_bytes", 0) / bw
            if now < start + f * priced:
                continue
            ch = getattr(h, "channel", -1)
            if not self._cancel(h):
                continue
            self.health.record_fault(ch)
            self.stats.n_straggler_reissues += 1
            obj = self.registry[name] if name in self.registry else None
            if obj is None:
                self._inflight.pop(name, None)
                self._finish_record(name, now, 0.0, superseded=True)
                continue
            avoid = {ch} | self.health.avoid()
            try:
                h2 = self._start_move_raw(obj, h.dst, None, avoid,
                                          self._prefer_for(name))
            except CopyError:
                self._fail_inflight(name, h, phase_index,
                                    "straggler_reissue_failed", now)
                continue
            self._inflight[name] = h2
            rec = self._records.get(name)
            if rec is not None:
                rec.channel = getattr(h2, "channel", rec.channel)
                rec.start = getattr(h2, "start", rec.start)
                d2 = self._done_of(h2)
                rec.done = d2 if d2 is not None else rec.done

    # ------------------------------------------------------------------ fence
    def _fence(self, plan: PlacementPlan, phase_index: int,
               now: float) -> float:
        """Absorb remaining copy time for every move this phase consumes.

        Evictions are *not* fenced: the phase never reads the evicted data,
        and a fetch that depends on the freed space was chained after the
        eviction copy at release time — the eviction itself stays off the
        critical path (unlike the FIFO baseline, which stalls on it)."""
        singles: List[Any] = []
        groups: Dict[str, List[Any]] = {}
        for m in plan.fences_for_phase(phase_index):
            h = self._inflight.get(m.obj)
            if h is None:
                continue
            if m.dst == "slow":
                # eviction: never fenced (the phase does not read evicted
                # data); once landed it counts as a fully-overlapped move.
                # Timing-less backends are probed with their non-blocking
                # is_done (blocking here — e.g. the async torch backend's
                # complete() — would put the eviction back on the critical
                # path while recording zero stall).
                done = self._done_of(h)
                if done is not None:
                    landed = done <= now
                else:
                    probe = getattr(self.backend, "is_done", None)
                    landed = probe(h) if probe is not None else True
                if landed:
                    self._inflight.pop(m.obj)
                    try:
                        self._complete(h)
                    except CopyError:
                        self._fail_inflight(m.obj, h, phase_index,
                                            "late_fail", now)
                        continue
                    self.stats.overlapped_moves += 1
                    self.health.record_success(getattr(h, "channel", -1))
                    self._finish_record(m.obj, now, 0.0)
                continue
            self._inflight.pop(m.obj)
            dob = self.registry[m.obj] if m.obj in self.registry else None
            if dob is not None and dob.parent is not None:
                groups.setdefault(dob.parent, []).append((dob, m, h))
            else:
                singles.append((m, h))

        stall = 0.0
        for m, h in singles:
            done = self._done_of(h)
            if done is None:
                # blocking backend (real arrays): the fence must block
                # here — but never past the straggler deadline
                try:
                    self.backend.wait(h, timeout=self._deadline_for(
                        m.size_bytes))
                except TypeError:
                    self.backend.wait(h)
                except CopyError:
                    self._cancel(h)
                    self._fail_inflight(m.obj, h, phase_index,
                                        "deadline", now)
                    continue
                s = 0.0
            else:
                s = max(0.0, done - now)
                if self._service_exceeded(h, self._deadline_for(m.size_bytes)):
                    # stuck/straggling copy: abandon rather than deadlock;
                    # the phase serves this object from the slow tier
                    self._cancel(h)
                    self._fail_inflight(m.obj, h, phase_index,
                                        "deadline", now)
                    continue
            # parallel channels: waiting on all fenced copies costs the max
            stall = max(stall, s)
            self._count_fence(s)
            try:
                self._complete(h)
            except CopyError:
                self._fail_inflight(m.obj, h, phase_index, "late_fail", now)
                continue
            self.health.record_success(getattr(h, "channel", -1))
            self._finish_record(m.obj, now, s)

        phase_est = (self.graph[phase_index].time
                     if self.graph is not None else 0.0)
        t0 = now + stall
        extra_max = 0.0
        for parent, entries in groups.items():
            extra_max = max(extra_max,
                            self._fence_chunks(parent, entries, t0, phase_est,
                                               phase_index))
        stall += extra_max
        self.stats.fence_stall_s += stall
        return stall

    def _fence_chunks(self, parent: str, entries: List[Any], t0: float,
                      phase_est: float, phase_index: int = 0) -> float:
        """Double-buffered consumption of one chunked object.

        Chunks are consumed in index order across the phase; chunk ``k``'s
        consume point is ``t0 + phase_est * frac(bytes before k)``.  A chunk
        landing after its consume point stalls only its own remainder; the
        stall pushes every later consume point back (``extra``)."""
        siblings = sorted((o for o in self.registry if o.parent == parent),
                          key=lambda o: o.chunk_index or 0)
        total = sum(o.size_bytes for o in siblings) or 1
        before: Dict[str, int] = {}
        acc = 0
        for o in siblings:
            before[o.name] = acc
            acc += o.size_bytes
        extra = 0.0
        for dob, m, h in sorted(entries, key=lambda e: e[0].chunk_index or 0):
            consume = t0 + extra + phase_est * (before[dob.name] / total)
            done = self._done_of(h)
            if done is None:
                try:    # blocking backend: fence the chunk (bounded)
                    self.backend.wait(h, timeout=self._deadline_for(
                        m.size_bytes))
                except TypeError:
                    self.backend.wait(h)
                except CopyError:
                    self._cancel(h)
                    self._fail_inflight(m.obj, h, phase_index,
                                        "deadline", consume)
                    continue
                late = 0.0
            else:
                late = max(0.0, done - consume)
                if self._service_exceeded(h, self._deadline_for(m.size_bytes)):
                    # a stuck/straggling chunk: abandon, serve it slow
                    self._cancel(h)
                    self._fail_inflight(m.obj, h, phase_index,
                                        "deadline", consume)
                    continue
            extra += late
            self._count_fence(late)
            try:
                self._complete(h)
            except CopyError:
                self._fail_inflight(m.obj, h, phase_index, "late_fail",
                                    consume)
                continue
            self.health.record_success(getattr(h, "channel", -1))
            self._finish_record(m.obj, consume, late)
        return extra

    def _finish_record(self, obj: str, fenced_at: float, stall: float,
                       superseded: bool = False) -> None:
        rec = self._records.pop(obj, None)
        if rec is not None:
            rec.fenced_at = fenced_at
            rec.fence_stall_s = stall
            rec.superseded = superseded

    # ---------------------------------------------------------------- release
    def _release(self, plan: PlacementPlan, phase_index: int, n_phases: int,
                 now: float) -> None:
        """Issue the moves whose trigger window opens at this phase, most
        urgent first.  Fetches the entered phase itself consumes are chained
        after the evictions freeing their space; the subsequent fence absorbs
        whatever copy time remains."""
        if plan.schedule:
            entries = plan.scheduled_for_phase(phase_index, n_phases)
        else:   # hand-built plan without timing: wrap the raw ops
            entries = [ScheduledMove(m, 0.0, 0.0, 0.0)
                       for m in plan.moves_for_phase(phase_index, n_phases)]
        evictions = [e for e in entries if e.op.dst == "slow"]
        fetches = [e for e in entries if e.op.dst != "slow"]

        last_evict = None
        for e in evictions:
            h = self._issue(e, now)
            if h is not None:
                last_evict = h

        for e in fetches:
            same_phase = e.op.needed_by % n_phases == phase_index % n_phases
            self._issue(e, now, after=last_evict if same_phase else None)

    def _issue(self, entry: ScheduledMove, now: float,
               after: Any = None) -> Optional[Any]:
        m = entry.op
        if m.obj not in self.registry:
            return None
        obj = self.registry[m.obj]
        pending = self._inflight.get(m.obj)
        if pending is not None:
            if getattr(pending, "dst", None) == m.dst:
                return None     # identical move already in flight
            # direction flip (e.g. re-fetch of an object whose eviction is
            # still in flight): chain after the pending copy.  The pending
            # copy was never fenced, so it ran entirely in the background.
            if after is None or (getattr(pending, "done", 0.0)
                                 > getattr(after, "done", 0.0)):
                after = pending
            self.stats.overlapped_moves += 1
            self._finish_record(m.obj, now, 0.0, superseded=True)
        elif obj.tier == m.dst:
            return None
        h = self._start_with_retry(entry, obj, after, now)
        if h is None and obj.tier != m.dst:
            return None     # retries exhausted (fault recorded); a payload-
                            # free logical flip returns None *after* flipping
        self.stats.n_moves += 1
        self.stats.moved_bytes += m.size_bytes
        self._inflight[m.obj] = h
        rec = MoveRecord(
            obj=m.obj, dst=m.dst, trigger_phase=m.trigger_phase,
            needed_by=m.needed_by, size_bytes=m.size_bytes, issued_at=now,
            start=getattr(h, "start", now),
            done=self._done_of(h) if self._done_of(h) is not None else now,
            channel=getattr(h, "channel", 0), slack_s=entry.slack_s)
        self._records[m.obj] = rec
        self.trace.append(rec)
        return h

    # ------------------------------------------------------------- entrypoint
    def on_phase_start(self, plan: PlacementPlan, phase_index: int,
                       n_phases: int) -> float:
        now = self._now()
        settle = getattr(self.backend, "settle", None)
        if settle is not None:
            settle(now)
        # failure upkeep (both no-ops on a fault-free run): purge copies
        # that late-failed at settle, then cancel-and-reissue stragglers
        self._sweep_failures(phase_index, now)
        self._detect_stragglers(phase_index, now)
        # release first so moves this phase both triggers AND consumes flow
        # through the same fence logic (incl. chunk-granular consumption)
        self._release(plan, phase_index, n_phases, now)
        return self._fence(plan, phase_index, now)

    def drain(self) -> None:
        for name, h in list(self._inflight.items()):
            try:
                self.backend.wait(h)
                self._complete(h)
            except CopyError:
                pass            # draining: the copy's fate is recorded
            del self._inflight[name]
