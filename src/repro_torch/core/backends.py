"""String-keyed copy-backend registry (runtime API v2).

The registry makes the copy backend a config string
(``RuntimeConfig.backend = "torch" | "torch_async" | "sim" | ...``)
resolved through one factory table, so a new copy engine registers itself
without changing any driver.

Factory signature: ``factory(machine, **options) -> TierBackend``.  All
factories must tolerate unknown keyword options (each driver passes its
full option set — ``now_fn``, ``mover``, ``channels`` — and every factory
picks what it understands).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from .faults import ChaosBackend, FaultSpec
from .mover import (AsyncTorchTierBackend, ChannelSimBackend, CpuPoolBackend,
                    CrossHostBackend, SimTierBackend, TorchTierBackend)
from .tiers import MachineProfile

BackendFactory = Callable[..., Any]

_REGISTRY: Dict[str, BackendFactory] = {}


def register_backend(name: str, factory: BackendFactory,
                     *, overwrite: bool = False) -> None:
    """Register a copy-backend factory under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _REGISTRY[name] = factory


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def make_backend(name: str, machine: MachineProfile, **options: Any):
    """Instantiate the backend registered under ``name``."""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown copy backend {name!r}; registered: "
                         f"{available_backends()}")
    return factory(machine, **options)


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------
def _sim_factory(machine: MachineProfile, *, now_fn=None, mover: str = "slack",
                 channels: int = 2, priorities=None, **_: Any):
    """Simulated copy engine matched to the configured migration engine:
    the slack mover gets the multi-channel engine (tier flips on landing;
    optional per-channel ``priorities`` confine bulk evictions to the
    lowest-priority channels), the FIFO baseline the single serial
    queue."""
    if now_fn is None:
        now_fn = lambda: 0.0            # noqa: E731 — static virtual clock
    if mover == "slack":
        return ChannelSimBackend(machine, now_fn, channels=channels,
                                 priorities=priorities)
    return SimTierBackend(machine, now_fn)


def _cpu_pool_factory(machine: MachineProfile, *, pool_workers: int = 2,
                      **_: Any):
    """Host-side memcpy thread pool (ROADMAP: CPU copy engine) — numpy
    leaves copied on worker threads, tier flips on landing."""
    return CpuPoolBackend(machine, workers=pool_workers)


def _cross_host_factory(machine: MachineProfile, *, links=None, now_fn=None,
                        default_link=None, on_land=None, **_: Any):
    """Shard-migration engine over modeled interconnect links: prices
    peer-host pulls with per-link bandwidth/latency and a bounded number
    of send/recv channel pairs per link.  ``links`` is an
    :class:`~.perfmodel.InterconnectModel` (or a ``{(src, dst): LinkSpec}``
    mapping; ``default_link`` prices unnamed pairs)."""
    from .perfmodel import InterconnectModel
    if not isinstance(links, InterconnectModel):
        links = InterconnectModel(links, default=default_link)
    if now_fn is None:
        now_fn = lambda: 0.0            # noqa: E731 — static virtual clock
    return CrossHostBackend(links, now_fn, on_land=on_land)


def _chaos_factory(machine: MachineProfile, *, chaos_inner: str = "torch_async",
                   fault_spec=None, **options: Any):
    """Fault-injecting decorator over any registered backend:
    ``make_backend("chaos", machine, chaos_inner="sim", fault_spec=spec)``
    wraps the inner backend in :class:`~.faults.ChaosBackend`.  With no
    ``fault_spec`` the wrapper injects nothing (a pass-through useful for
    testing the decorator plumbing itself)."""
    if chaos_inner == "chaos":
        raise ValueError("chaos backend cannot wrap itself")
    inner = make_backend(chaos_inner, machine, **options)
    return ChaosBackend(inner, fault_spec or FaultSpec(),
                        host=options.get("host"))


register_backend("sim", _sim_factory)
register_backend("torch", lambda machine, *, channels=1, **_:
                 TorchTierBackend(machine, channels))
register_backend("torch_async", lambda machine, *, channels=1, **_:
                 AsyncTorchTierBackend(machine, channels))
register_backend("cpu_pool", _cpu_pool_factory)
register_backend("chaos", _chaos_factory)
register_backend("cross_host", _cross_host_factory)
