"""GQA/MQA attention: parameters, the full-sequence causal forward of
training (counterpart of the reference's ``attn_forward``) and the
one-token decode against a KV cache (``attn_decode``).

The full-sequence forward leaves its projections to ``torch.matmul``, as
the reference leaves them to XLA, and runs the attention itself through
the ``flash_attention`` kernel and its backward kernel.  The decode sends
every projection through the ``tiered_matmul`` kernel and the attention
through the ``decode_attention`` kernel (all via :mod:`..kernels.ops`);
its cache (bf16, fp32 or fp8 e4m3) is updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import apply_rope, dense_init, kv_cast


def init_attn_params(generator: torch.Generator, cfg: ArchConfig,
                     n_layers: Optional[int], dtype=torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Stacked over a leading layer axis of ``n_layers``, or one unstacked
    block with ``n_layers=None`` (zamba2's shared block)."""
    d, H, K, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    L = () if n_layers is None else (n_layers,)
    p = {
        "wq": dense_init(generator, (*L, d, H * Dh), dtype),
        "wk": dense_init(generator, (*L, d, K * Dh), dtype),
        "wv": dense_init(generator, (*L, d, K * Dh), dtype),
        "wo": dense_init(generator, (*L, H * Dh, d), dtype),
    }
    if cfg.attn_bias:
        for name, width in (("bq", H * Dh), ("bk", K * Dh), ("bv", K * Dh)):
            p[name] = torch.zeros((*L, width), dtype=dtype,
                                  device=generator.device)
    return p


def attn_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Causal self-attention over a full sequence.  x: (B, S, d); cos/sin:
    (S, rotary_dim // 2) tables (:func:`.common.rope_frequencies`).
    Returns (B, S, d)."""
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.matmul(x, params["wq"])
    k = torch.matmul(x, params["wk"])
    v = torch.matmul(x, params["wv"])
    if cfg.attn_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.view(B, S, H, Dh)
    k = k.view(B, S, K, Dh)
    v = v.view(B, S, K, Dh)
    rd = int(Dh * cfg.rotary_fraction)
    if rd:
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, cos, sin, positions=pos, rotary_dim=rd)
        k = apply_rope(k, cos, sin, positions=pos, rotary_dim=rd)
    # head h = k * G + g, as the reference's (B, S, K, G, D) reshape
    qg = q.view(B, S, K, H // K, Dh).permute(0, 2, 3, 1, 4)  # (B,K,G,S,D)
    out = ops.flash_attention(qg, k.permute(0, 2, 1, 3),
                              v.permute(0, 2, 1, 3), causal=True)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * Dh)
    return torch.matmul(out, params["wo"])


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
    cache_k[:, pos] = kv_cast(k, cache_k.dtype)
    cache_v[:, pos] = kv_cast(v, cache_v.dtype)
    out = ops.decode_attention(q.view(B, K, H // K, Dh),
                               cache_k.permute(0, 2, 1, 3),
                               cache_v.permute(0, 2, 1, 3), pos + 1)
    return ops.tiered_matmul(out.reshape(B, H * Dh), params["wo"])
