"""Serving: batched greedy decoding with KV caches, under the Unimem
runtime (counterpart of the reference package's ``serve/engine.py``).

Prefill is a scanned decode, as in the reference: the prompt is fed one
token per step through the same decode step, so every cache family is
served alike -- keys and values (``attn``), keys and values with Mamba-2
states (zamba2), or the mLSTM and sLSTM states alone (xlstm).  With a
``runtime`` the engine registers its params and that cache (as
``kv_cache``, whichever family) as runtime data objects and runs each
``generate`` as one runtime iteration with ``prefill`` and ``decode``
phases.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..models import lm


def build_decode_step(cfg: ArchConfig) -> Callable:
    """Returns decode_step(params, cache, token, pos) -> (next_token,
    logits); the cache is updated in place."""

    def decode_step(params, cache, token, pos):
        logits = lm.decode_step(params, cfg, cache, token, pos)
        return torch.argmax(logits, dim=-1), logits

    return decode_step


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0


class ServeEngine:
    """Minimal batched serving loop (greedy) on the runtime's session API.

    With a ``runtime`` (a :class:`~..core.session.Session` /
    ``UnimemRuntime``), params and the KV cache are registered as runtime
    data objects — sizes and leaf spans only (``manage_payload=False``:
    the engine owns the tensors, so their tiers flip logically) — every
    ``generate`` call is one runtime iteration, and prefill/decode run as
    phases, so the runtime profiles the cache traffic and plans tier
    placement across calls.  ``tenant`` scopes all of it to a tenant
    namespace (``rt.tenant(tenant, ...)``): object and phase names carry
    the ``tenant/`` prefix, so one runtime can host many engines.
    ``runtime=None`` keeps the plain loop."""

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any], *,
                 max_seq: int, batch: int, runtime=None,
                 tenant: Optional[str] = None, priority: float = 1.0,
                 slo: float = 1.0, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine serves on {self.device}")
        self.runtime = runtime
        self._ns = None       # registration namespace: tenant handle or rt
        self._registered = False
        if runtime is not None:
            self._ns = (runtime.tenant(tenant, priority=priority, slo=slo)
                        if tenant else runtime)
        self.step = build_decode_step(cfg)
        self.stats = ServeStats()

    # ------------------------------------------------------------------
    def _register(self, cache: Any) -> None:
        if self._ns is None or self._registered:
            return
        self._ns.register("params", self.params, manage_payload=False,
                          pinned=True)
        self._ns.register("kv_cache", cache, manage_payload=False,
                          chunkable=True)
        self._registered = True

    def _phase(self, name: str):
        return (contextlib.nullcontext() if self._ns is None
                else self._ns.phase(name))

    def generate(self, prompts: torch.Tensor, n_new: int) -> torch.Tensor:
        """prompts: (B, P) integer tokens.  Returns (B, P + n_new)."""
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"batch {B} != engine batch {self.batch}")
        if P + n_new > self.max_seq:
            raise ValueError(f"{P} + {n_new} tokens exceed max_seq "
                             f"{self.max_seq}")
        prompts = prompts.to(self.device)
        cache = lm.init_cache(self.cfg, B, self.max_seq, device=self.device)
        self._register(cache)
        with (self.runtime.iteration() if self.runtime is not None
              else contextlib.nullcontext()):
            # prefill by scanned decode (uniform across cache families)
            with self._phase("prefill"):
                for i in range(P):
                    nxt, _ = self.step(self.params, cache, prompts[:, i], i)
                    self.stats.prefill_tokens += B
            tok = nxt
            gen = []
            with self._phase("decode"):
                for j in range(n_new):
                    gen.append(tok[:, None])
                    nxt, _ = self.step(self.params, cache, tok, P + j)
                    tok = nxt
                    self.stats.decode_tokens += B
            return torch.cat([prompts] + gen, dim=1)
