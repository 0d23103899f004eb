"""MLP variants: SwiGLU / GeGLU (gated) and the plain two-layer MLP
(GELU / squared ReLU).  :func:`mlp_forward` over a full sequence leaves
its products to ``torch.matmul`` (as the reference leaves them to XLA);
:func:`mlp_decode` sends each product of the one-token decode through the
``tiered_matmul`` kernel: three launches a gated layer, two a plain one."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import ACTIVATIONS, dense_init


def _is_gated(cfg: ArchConfig) -> bool:
    return cfg.mlp_type in ("swiglu", "geglu")


def init_mlp_params(generator: torch.Generator, cfg: ArchConfig,
                    n_layers: Optional[int], dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """Stacked over a leading layer axis of ``n_layers``, or one unstacked
    block with ``n_layers=None``.  Gated: ``w_gate``, ``w_up`` (d, f) and
    ``w_down`` (f, d); plain: ``w_up`` and ``w_down``."""
    d, f = cfg.d_model, cfg.d_ff
    L = () if n_layers is None else (n_layers,)
    names = ("w_gate", "w_up") if _is_gated(cfg) else ("w_up",)
    params = {name: dense_init(generator, (*L, d, f), dtype)
              for name in names}
    params["w_down"] = dense_init(generator, (*L, f, d), dtype)
    return params


def _mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
         cfg: ArchConfig, matmul) -> torch.Tensor:
    act = ACTIVATIONS[cfg.activation]
    if _is_gated(cfg):
        h = act(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
    else:
        h = act(matmul(x, params["w_up"]))
    return matmul(h, params["w_down"])


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """Full sequence (training): x (B, S, d) -> (B, S, d), ``torch.matmul``."""
    return _mlp(params, x, cfg, torch.matmul)


def mlp_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """One-token decode: x (B, d) -> (B, d), each product through the
    ``tiered_matmul`` kernel, whatever B is."""
    return _mlp(params, x, cfg, ops.tiered_matmul)
