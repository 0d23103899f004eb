"""Gated MLP (SwiGLU / GeGLU): :func:`mlp_forward` over a full sequence
leaves its products to ``torch.matmul`` (as the reference leaves them to
XLA); :func:`mlp_decode` sends each product of the one-token decode
through the ``tiered_matmul`` kernel.  The plain two-layer MLP of other
families is queued in ROADMAP.md (queue 1: "The moe family and the other
five configs")."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import ACTIVATIONS, dense_init


def init_mlp_params(generator: torch.Generator, cfg: ArchConfig,
                    n_layers: Optional[int], dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """Stacked over a leading layer axis of ``n_layers``, or one unstacked
    block with ``n_layers=None``."""
    d, f = cfg.d_model, cfg.d_ff
    L = () if n_layers is None else (n_layers,)
    _require_gated(cfg)
    return {
        "w_gate": dense_init(generator, (*L, d, f), dtype),
        "w_up": dense_init(generator, (*L, d, f), dtype),
        "w_down": dense_init(generator, (*L, f, d), dtype),
    }


def _gated(params: Dict[str, torch.Tensor], x: torch.Tensor,
           cfg: ArchConfig, matmul) -> torch.Tensor:
    _require_gated(cfg)
    act = ACTIVATIONS[cfg.activation]
    gate = act(matmul(x, params["w_gate"]))
    return matmul(gate * matmul(x, params["w_up"]), params["w_down"])


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """Full sequence (training): x (B, S, d) -> (B, S, d), ``torch.matmul``."""
    return _gated(params, x, cfg, torch.matmul)


def mlp_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """One-token decode: x (B, d) -> (B, d), each product through the
    ``tiered_matmul`` kernel, whatever B is."""
    return _gated(params, x, cfg, ops.tiered_matmul)


def _require_gated(cfg: ArchConfig) -> None:
    if cfg.mlp_type not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"mlp_type {cfg.mlp_type!r} is not ported yet (ROADMAP.md, "
            "queue 1: 'The moe family and the other five configs')")
