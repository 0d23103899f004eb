"""Language model assembly, ``attn`` block pattern (embed -> blocks ->
norm -> tied or untied head), for greedy decode.

Functional API, as in the reference package's ``models/lm.py``:
  init_params(cfg, generator, device, dtype)   -> params dict
  init_cache(cfg, batch, max_seq, device)      -> decode cache dict
  decode_step(params, cfg, cache, token, pos)  -> logits (cache in place)

Parameters keep the reference's keys, shapes and stacked layer axis, so
the runtime records the same leaf spans for them in both packages.  The
reference scans over layers; here a Python loop indexes the stacked
tensors.  The ``mamba_shared_attn`` and ``xlstm`` patterns, ``forward``
and ``loss_fn`` are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import attention, mlp as mlp_mod
from .common import dense_init, embed_init, rms_norm, rope_at


def _require_attn(cfg: ArchConfig) -> None:
    if cfg.block_pattern != "attn" or cfg.is_moe or cfg.norm != "rms":
        raise NotImplementedError(
            f"{cfg.name}: only the dense 'attn' pattern with rms norm is "
            "ported (ROADMAP.md, queue 1: 'The ssd_scan kernel, with mamba2, "
            "zamba2 and xlstm' and 'The other nine configs and the moe "
            "family')")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (on its own device) and
    placed on ``device``.  Same keys and shapes as the reference package;
    not the same numbers (its draws come from ``jax.random``)."""
    _require_attn(cfg)
    L, d = cfg.n_layers, cfg.d_model
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype,   # noqa: E731
                                       device=generator.device)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, (cfg.vocab_size, d), dtype),
        "final_ln_scale": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (d, cfg.vocab_size), dtype)
    blocks: Dict[str, Any] = {
        "attn": attention.init_attn_params(generator, cfg, L, dtype),
        "ln1_scale": zeros(L, d),
        "ln2_scale": zeros(L, d),
    }
    if cfg.d_ff:
        blocks["mlp"] = mlp_mod.init_mlp_params(generator, cfg, L, dtype)
    params["blocks"] = blocks
    return _to(params, torch.device(device))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda",
               kv_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(n_layers, batch, max_seq, K, Dh) keys and values, zeroed."""
    _require_attn(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
            "v": torch.zeros(shape, dtype=kv_dtype, device=device)}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def decode_step(params: Dict[str, Any], cfg: ArchConfig,
                cache: Dict[str, torch.Tensor], token: torch.Tensor,
                pos: int) -> torch.Tensor:
    """token: (B,) int; pos: the token's position.  Writes the token's keys
    and values into ``cache`` in place and returns logits (B, V)."""
    _require_attn(cfg)
    x = params["embed"][token]                               # (B, d)
    rd = int(cfg.resolved_head_dim * cfg.rotary_fraction)
    cos, sin = rope_at(pos, rd, cfg.rope_theta, x.device)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        blk = _layer(blocks, i)
        h = rms_norm(x, blk["ln1_scale"])
        x = x + attention.attn_decode(blk["attn"], h, cache["k"][i],
                                      cache["v"][i], pos, cos, sin, cfg)
        if cfg.d_ff:
            h = rms_norm(x, blk["ln2_scale"])
            x = x + mlp_mod.mlp_forward(blk["mlp"], h, cfg)
    x = rms_norm(x, params["final_ln_scale"])
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head
