"""GQA/MQA attention: parameters and the one-token decode against a KV
cache (counterpart of the reference's ``attn_decode``).

Every projection goes through the ``tiered_matmul`` kernel and the
attention itself through the ``decode_attention`` kernel (both via
:mod:`..kernels.ops`).  The cache is updated in place.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import apply_rope, dense_init


def init_attn_params(generator: torch.Generator, cfg: ArchConfig,
                     n_layers: int, dtype=torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Stacked over a leading layer axis of ``n_layers``."""
    d, H, K, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    L = n_layers
    p = {
        "wq": dense_init(generator, (L, d, H * Dh), dtype),
        "wk": dense_init(generator, (L, d, K * Dh), dtype),
        "wv": dense_init(generator, (L, d, K * Dh), dtype),
        "wo": dense_init(generator, (L, H * Dh, d), dtype),
    }
    if cfg.attn_bias:
        for name, width in (("bq", H * Dh), ("bk", K * Dh), ("bv", K * Dh)):
            p[name] = torch.zeros((L, width), dtype=dtype,
                                  device=generator.device)
    return p


def attn_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                cos: torch.Tensor, sin: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """One-token decode.  x: (B, d); cache_k/v: (B, S_max, K, Dh), written
    in place at ``pos``; ``pos``: the token's position (cache rows
    ``0..pos`` are attended, so the kernel's length is ``pos + 1``);
    ``cos``/``sin``: the rotary row of ``pos`` (:func:`.common.rope_at`).
    Returns (B, d)."""
    B = x.shape[0]
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = ops.tiered_matmul(x, params["wq"])
    k = ops.tiered_matmul(x, params["wk"])
    v = ops.tiered_matmul(x, params["wv"])
    if cfg.attn_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.view(B, H, Dh)
    k = k.view(B, K, Dh)
    v = v.view(B, K, Dh)
    rd = int(Dh * cfg.rotary_fraction)
    if rd:
        q = apply_rope(q, cos, sin, rotary_dim=rd)
        k = apply_rope(k, cos, sin, rotary_dim=rd)
    cache_k[:, pos] = k.to(cache_k.dtype)
    cache_v[:, pos] = v.to(cache_v.dtype)
    out = ops.decode_attention(q.view(B, K, H // K, Dh),
                               cache_k.permute(0, 2, 1, 3),
                               cache_v.permute(0, 2, 1, 3), pos + 1)
    return ops.tiered_matmul(out.reshape(B, H * Dh), params["wo"])
