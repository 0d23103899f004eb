"""Language model assembly, ``attn`` block pattern (embed -> blocks ->
norm -> tied or untied head), for training and greedy decode.

Functional API, as in the reference package's ``models/lm.py``:
  init_params(cfg, generator, device, dtype)   -> params dict
  forward(params, cfg, tokens, remat=)         -> (logits, aux)
  loss_fn(params, cfg, batch, remat=)          -> (loss, {"nll", "aux"})
  init_cache(cfg, batch, max_seq, device)      -> decode cache dict
  decode_step(params, cfg, cache, token, pos)  -> logits (cache in place)

Parameters keep the reference's keys, shapes and stacked layer axis, so
the runtime records the same leaf spans for them in both packages.  The
reference scans over layers; here a Python loop walks per-layer views of
the stacked tensors.  The ``mamba_shared_attn`` and ``xlstm`` patterns
are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import _tree
from ..configs.base import ArchConfig
from . import attention, mlp as mlp_mod
from .common import (dense_init, embed_init, rms_norm, rope_at,
                     rope_frequencies)


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


def _unstack(tree, n: int) -> List[Any]:
    """Per-layer views of a tree of stacked tensors; the gradient of
    ``unbind`` is one ``stack``, not a full-size zero tensor per layer."""
    leaves, treedef = _tree.flatten(tree)
    per_leaf = [t.unbind(0) for t in leaves]
    return [_tree.unflatten(treedef, [p[i] for p in per_leaf])
            for i in range(n)]


def _block_fwd(blk, x, cos, sin, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, blk["ln1_scale"])
    x = x + attention.attn_forward(blk["attn"], h, cos, sin, cfg)
    if cfg.d_ff:
        h = rms_norm(x, blk["ln2_scale"])
        x = x + mlp_mod.mlp_forward(blk["mlp"], h, cfg)
    return x


def forward(params: Dict[str, Any], cfg: ArchConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S).  Returns (logits (B, S, V) in the parameters' dtype,
    aux loss = 0 for the dense pattern).  ``remat`` recomputes each layer
    in the backward pass and keeps only its input, as the reference's
    ``jax.checkpoint(nothing_saveable)`` over the layer scan."""
    _require_attn(cfg)
    if frontend_embeds is not None:
        raise NotImplementedError("frontend embeddings are not ported (no "
                                  "ported config has a frontend)")
    x = params["embed"][tokens]                              # (B, S, d)
    S = x.shape[1]
    rd = int(cfg.resolved_head_dim * cfg.rotary_fraction)
    cos, sin = rope_frequencies(cfg.resolved_head_dim, S, cfg.rope_theta,
                                rotary_dim=rd, device=x.device)
    for blk in _unstack(params["blocks"], cfg.n_layers):
        if remat:
            x = checkpoint(_block_fwd, blk, x, cos, sin, cfg,
                           use_reentrant=False)
        else:
            x = _block_fwd(blk, x, cos, sin, cfg)
    x = rms_norm(x, params["final_ln_scale"])
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return torch.matmul(x, head), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def loss_fn(params: Dict[str, Any], cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32: (loss, {"nll", "aux"})."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("frontend"), remat=remat)
    logits = logits[:, :-1].float()
    targets = batch["labels"][:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def decode_step(params: Dict[str, Any], cfg: ArchConfig,
                cache: Dict[str, torch.Tensor], token: torch.Tensor,
                pos: int) -> torch.Tensor:
    """token: (B,) int; pos: the token's position.  Writes the token's keys
    and values into ``cache`` in place and returns logits (B, V)."""
    _require_attn(cfg)
    x = params["embed"][token]                               # (B, d)
    rd = int(cfg.resolved_head_dim * cfg.rotary_fraction)
    cos, sin = rope_at(pos, rd, cfg.rope_theta, x.device)
    for i, blk in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        h = rms_norm(x, blk["ln1_scale"])
        x = x + attention.attn_decode(blk["attn"], h, cache["k"][i],
                                      cache["v"][i], pos, cos, sin, cfg)
        if cfg.d_ff:
            h = rms_norm(x, blk["ln2_scale"])
            x = x + mlp_mod.mlp_decode(blk["mlp"], h, cfg)
    x = rms_norm(x, params["final_ln_scale"])
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head
