"""Gated MLP (SwiGLU / GeGLU), every product through the ``tiered_matmul``
kernel.  The plain two-layer MLP of other families is queued in
ROADMAP.md (queue 1: "The other nine configs and the moe family")."""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import ACTIVATIONS, dense_init


def init_mlp_params(generator: torch.Generator, cfg: ArchConfig,
                    n_layers: int, dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    d, f, L = cfg.d_model, cfg.d_ff, n_layers
    _require_gated(cfg)
    return {
        "w_gate": dense_init(generator, (L, d, f), dtype),
        "w_up": dense_init(generator, (L, d, f), dtype),
        "w_down": dense_init(generator, (L, f, d), dtype),
    }


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """x: (B, d) -> (B, d)."""
    _require_gated(cfg)
    act = ACTIVATIONS[cfg.activation]
    gate = act(ops.tiered_matmul(x, params["w_gate"]))
    return ops.tiered_matmul(gate * ops.tiered_matmul(x, params["w_up"]),
                             params["w_down"])


def _require_gated(cfg: ArchConfig) -> None:
    if cfg.mlp_type not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"mlp_type {cfg.mlp_type!r} is not ported yet (ROADMAP.md, "
            "queue 1: 'The other nine configs and the moe family')")
