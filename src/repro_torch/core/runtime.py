"""UnimemRuntime — compatibility facade over the v2 runtime session.

Paper API mapping (Table 2), v2 session surface, and the deprecated
imperative shims this facade keeps alive:

=================  ==========================================================
unimem_init        ``UnimemRuntime(machine, ...)``
unimem_malloc      ``rt.register(name, pytree_or_size, ...)``
                   (deprecated: ``rt.alloc(name, size_bytes=...)``)
unimem_start/end   ``with rt.iteration(): with rt.phase("fwd"): ...``
                   (deprecated: ``start_loop`` / ``begin_iteration`` /
                   ``phase_begin`` / ``phase_end`` / ``end_iteration``)
PMPI wrapper       phase boundaries are the ``rt.phase(...)`` contexts
                   (collective / jit-step boundaries), exactly as PMPI
                   interception delimits them
=================  ==========================================================

All orchestration lives in :class:`~.session.Session`; the shims below
delegate to the same internals the context managers use, so old-style and
new-style drivers produce **bit-identical** plans (parity-tested).  New
code should use the session API; the shims emit ``DeprecationWarning``.

See :mod:`.session` for the workflow semantics (profile -> plan -> move ->
monitor, incremental replanning, per-chunk attribution) and
:mod:`.instrumentation` / :mod:`.backends` for the pluggable
instrumentation-source and copy-backend layers.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence

from .data_objects import DataObject
from .session import PhaseContext, RuntimeConfig, Session

__all__ = ["RuntimeConfig", "UnimemRuntime", "PhaseContext"]


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"UnimemRuntime.{old} is deprecated; use {new} "
                  "(see README MIGRATION)", DeprecationWarning, stacklevel=3)


class UnimemRuntime(Session):
    """The v2 :class:`~.session.Session` plus the paper's Table-2 imperative
    API as deprecated, delegating shims."""

    # ------------------------------------------------------------- allocation
    def alloc(self, name: str, *, size_bytes: Optional[int] = None,
              payload: Any = None, chunkable: bool = False,
              pinned: bool = False,
              static_refs: Optional[float] = None) -> DataObject:
        """Deprecated ``unimem_malloc`` shim -> :meth:`Session.register`."""
        _deprecated("alloc(...)", "register(name, pytree_or_size, ...)")
        return self.register(name, size_bytes=size_bytes, payload=payload,
                             chunkable=chunkable, pinned=pinned,
                             static_refs=static_refs)

    # ------------------------------------------------------------- main loop
    def start_loop(self, phase_names: List[str],
                   static_refs: Optional[Dict[str, float]] = None) -> None:
        """Deprecated ``unimem_start`` shim: declare the loop's phase
        structure upfront.  The session auto-starts the loop and
        auto-registers phases on first use instead."""
        _deprecated("start_loop(...)",
                    "with rt.iteration(): (phases auto-register)")
        self._static_refs.update(static_refs or {})
        self._start_loop(phase_names)

    def begin_iteration(self) -> None:
        _deprecated("begin_iteration()", "with rt.iteration():")
        self._ensure_loop()
        self._begin_iteration()

    def phase_begin(self, index: int) -> float:
        _deprecated("phase_begin(i)", "with rt.phase(name):")
        return self._phase_begin(index)

    def phase_end(self, index: int, *, elapsed: float,
                  accesses: Optional[Dict[str, float]] = None,
                  time_shares: Optional[Dict[str, float]] = None,
                  access_bins: Optional[Dict[str, Sequence[float]]] = None
                  ) -> None:
        _deprecated("phase_end(i, ...)",
                    "with rt.phase(name, ...) / an InstrumentationSource")
        self._phase_end(index, elapsed=elapsed, accesses=accesses,
                        time_shares=time_shares, access_bins=access_bins)

    def end_iteration(self) -> None:
        _deprecated("end_iteration()", "with rt.iteration():")
        self._end_iteration()
