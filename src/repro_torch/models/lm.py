"""Language model assembly (embed -> blocks -> norm -> tied or untied
head), for training and greedy decode.  Three block patterns:

* ``attn``              -- dense transformers (gemma-2b, yi-6b,
                          chatglm3-6b, nemotron-4-340b), the vision and
                          audio models (phi-3-vision-4.2b, musicgen-large)
                          and MoE transformers (moonshot-v1-16b-a3b,
                          dbrx-132b: an MoE layer, :mod:`.moe`, in place of
                          the MLP);
* ``mamba_shared_attn`` -- zamba2: a Mamba-2 backbone with one *shared*
                          attention block (its own KV cache per
                          application) before every ``attn_every`` layers;
* ``xlstm``             -- xlstm-350m: groups of ``slstm_every - 1`` mLSTM
                          layers, each followed by one sLSTM layer (24
                          layers: 21 mLSTM and 3 sLSTM, in groups of 7 + 1).

Functional API, as in the reference package's ``models/lm.py``:
  init_params(cfg, generator, device, dtype)   -> params dict
  forward(params, cfg, tokens, frontend_embeds, remat=) -> (logits, aux)
  loss_fn(params, cfg, batch, remat=)          -> (loss, {"nll", "aux"})
  init_cache(cfg, batch, max_seq, device)      -> decode cache dict
  decode_step(params, cfg, cache, token, pos)  -> logits (cache in place)

Norms are ``rms`` or ``layer`` (dbrx-132b: scale and bias).  ``forward``
sums the MoE layers' aux losses over the layers, and ``loss_fn`` returns
nll + 0.01 aux.  Parameters keep the reference's keys, shapes and stacked
layer axis, so the runtime records the same leaf spans for them in both
packages.  The reference scans over layers; here a Python loop walks
per-layer views of the stacked tensors.

The frontends are stubs, as in the reference: ``forward`` takes
precomputed embeddings (B, n_front, d) and puts them before the tokens,
through ``frontend_proj`` for ``vision`` (phi-3-vision's CLIP patches) and
as they are for ``audio`` (musicgen's conditioning frames).  ``loss_fn``
drops their positions; serving and the train loop feed tokens only, as
the reference's do.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import _tree
from ..configs.base import ArchConfig
from . import attention, mamba2, mlp as mlp_mod, moe as moe_mod, xlstm
from .common import (dense_init, embed_init, embed_lookup, layer_norm,
                     rms_norm, rope_at, rope_frequencies, shard_hint)


# ---------------------------------------------------------------- norms
def _norm(blk: Dict[str, Any], name: str, x: torch.Tensor,
          cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm == "layer":
        return layer_norm(x, blk[f"{name}_scale"], blk[f"{name}_bias"])
    return rms_norm(x, blk[f"{name}_scale"])


def _init_norm(cfg: ArchConfig, name: str, n_layers, dtype, device
               ) -> Dict[str, torch.Tensor]:
    """rms: a scale of zeros (applied as 1 + scale); layer: a scale of ones
    and a bias of zeros.  Stacked over ``n_layers`` unless it is None."""
    shape = (cfg.d_model,) if n_layers is None else (n_layers, cfg.d_model)
    if cfg.norm == "layer":
        return {f"{name}_scale": torch.ones(shape, dtype=dtype, device=device),
                f"{name}_bias": torch.zeros(shape, dtype=dtype,
                                            device=device)}
    return {f"{name}_scale": torch.zeros(shape, dtype=dtype, device=device)}


def _init_block(generator, cfg: ArchConfig, n_layers, dtype):
    """An attention block: stacked over ``n_layers``, or one unstacked
    block (``n_layers=None``, zamba2's shared block)."""
    block: Dict[str, Any] = {
        "attn": attention.init_attn_params(generator, cfg, n_layers, dtype)}
    for name in ("ln1", "ln2"):
        block.update(_init_norm(cfg, name, n_layers, dtype, generator.device))
    if cfg.is_moe:
        block["moe"] = moe_mod.init_moe_params(generator, cfg, n_layers,
                                               dtype)
    elif cfg.d_ff:
        block["mlp"] = mlp_mod.init_mlp_params(generator, cfg, n_layers,
                                               dtype)
    return block


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (on its own device) and
    placed on ``device``.  Same keys and shapes as the reference package;
    not the same numbers (its draws come from ``jax.random``)."""
    L, d = cfg.n_layers, cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(generator, (cfg.vocab_size, d), dtype),
        **_init_norm(cfg, "final_ln", None, dtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (d, cfg.vocab_size), dtype)

    def with_ln1(blocks, n):
        blocks.update(_init_norm(cfg, "ln1", n, dtype, generator.device))
        return blocks

    if cfg.block_pattern == "attn":
        params["blocks"] = _init_block(generator, cfg, L, dtype)
    elif cfg.block_pattern == "mamba_shared_attn":
        params["mamba_blocks"] = with_ln1(
            mamba2.init_mamba2_params(generator, cfg, L, dtype), L)
        params["shared_attn"] = _init_block(generator, cfg, None, dtype)
    elif cfg.block_pattern == "xlstm":
        n_m, n_s = _xlstm_counts(cfg)
        params["mlstm_blocks"] = with_ln1(
            xlstm.init_mlstm_params(generator, cfg, n_m, dtype), n_m)
        if n_s:
            params["slstm_blocks"] = with_ln1(
                xlstm.init_slstm_params(generator, cfg, n_s, dtype), n_s)
    else:
        raise ValueError(cfg.block_pattern)
    if cfg.frontend == "vision":
        params["frontend_proj"] = dense_init(generator, (d, d), dtype)
    return _to(params, torch.device(device))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _n_apps(cfg: ArchConfig) -> int:
    """Applications of zamba2's shared block: one before each group of at
    most ``attn_every`` Mamba-2 layers."""
    return -(-cfg.n_layers // cfg.attn_every)


def _xlstm_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(mLSTM layers, sLSTM layers): one sLSTM in every ``slstm_every``."""
    n_s = cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0
    return cfg.n_layers - n_s, n_s


def _xlstm_layout(cfg: ArchConfig) -> List[Tuple[str, int, int]]:
    """The layers in order, as the reference walks them: ("m", first, count)
    for a run of mLSTM layers, ("s", index, 1) for an sLSTM layer."""
    L = cfg.n_layers
    period = cfg.slstm_every or (L + 1)
    n_s = L // period
    out, mi, si, done = [], 0, 0, 0
    while done < L:
        take = min(period - 1, L - done - (1 if si < n_s else 0))
        if take > 0:
            out.append(("m", mi, take))
            mi += take
            done += take
        if si < n_s and done < L:
            out.append(("s", si, 1))
            si += 1
            done += 1
    return out


def _stacked(one: Dict[str, torch.Tensor], n: int, device):
    return {k: torch.zeros((n, *t.shape), dtype=t.dtype, device=device)
            for k, t in one.items()}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda",
               kv_dtype=torch.bfloat16) -> Dict[str, Any]:
    """``attn``: (n_layers, batch, max_seq, K, Dh) keys and values.
    ``mamba_shared_attn``: keys and values per shared-block application,
    and per layer the fp32 SSM state (n_layers, batch, H, N, P) and the
    conv window (n_layers, batch, K - 1, C) in bf16.  ``xlstm``: per mLSTM
    layer the fp32 state (n_m, batch, H, P, P + 1), per sLSTM layer its
    fp32 h, c, n, m (n_s, batch, H, P); no keys or values.  All zeroed.
    ``kv_dtype``: the keys' and values' dtype, bf16 as the reference's
    default, or ``torch.float8_e4m3fn`` (half the bytes; the reference's
    fp8 cache), which the decode writes through :func:`.common.kv_cast`
    and the ``decode_attention`` kernel's e4m3 route reads."""
    if cfg.block_pattern == "xlstm":
        n_m, n_s = _xlstm_counts(cfg)
        cache = {"mlstm": _stacked(
            xlstm.init_mlstm_cache(cfg, batch, "meta"), n_m, device)}
        if n_s:
            cache["slstm"] = _stacked(
                xlstm.init_slstm_cache(cfg, batch, "meta"), n_s, device)
        return cache
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.block_pattern == "attn":
        n_kv, cache = cfg.n_layers, {}
    else:
        n_kv = _n_apps(cfg)
        cache = {"mamba": _stacked(
            mamba2.init_mamba2_cache(cfg, batch, "meta"), cfg.n_layers,
            device)}
    cache["k"] = torch.zeros((n_kv, *kv), dtype=kv_dtype, device=device)
    cache["v"] = torch.zeros((n_kv, *kv), dtype=kv_dtype, device=device)
    return cache


def _unstack(tree, n: int) -> List[Any]:
    """Per-layer views of a tree of stacked tensors; the gradient of
    ``unbind`` is one ``stack``, not a full-size zero tensor per layer."""
    leaves, treedef = _tree.flatten(tree)
    per_leaf = [t.unbind(0) for t in leaves]
    return [_tree.unflatten(treedef, [p[i] for p in per_leaf])
            for i in range(n)]


def _block_fwd(blk, x, cos, sin, cfg: ArchConfig) -> torch.Tensor:
    h = _norm(blk, "ln1", x, cfg)
    x = x + attention.attn_forward(blk["attn"], h, cos, sin, cfg)
    if cfg.d_ff:
        h = _norm(blk, "ln2", x, cfg)
        x = x + mlp_mod.mlp_forward(blk["mlp"], h, cfg)
    return x


def _moe_block_fwd(blk, x, cos, sin, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An MoE layer's block: (output, the layer's aux loss)."""
    h = _norm(blk, "ln1", x, cfg)
    x = x + attention.attn_forward(blk["attn"], h, cos, sin, cfg)
    out, aux = moe_mod.moe_forward(blk["moe"], _norm(blk, "ln2", x, cfg), cfg)
    return x + out, aux


def _mamba_fwd(blk, x, cfg: ArchConfig) -> torch.Tensor:
    return x + mamba2.mamba2_forward(blk, _norm(blk, "ln1", x, cfg), cfg)


def _mlstm_fwd(blk, x, cfg: ArchConfig) -> torch.Tensor:
    return x + xlstm.mlstm_forward(blk, _norm(blk, "ln1", x, cfg), cfg)


def _slstm_fwd(blk, x, cfg: ArchConfig) -> torch.Tensor:
    return x + xlstm.slstm_forward(blk, _norm(blk, "ln1", x, cfg), cfg)


def _apply(fn, remat: bool, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params: Dict[str, Any], cfg: ArchConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S_text); ``frontend_embeds``: (B, n_front, d) or None.
    Returns (logits (B, n_front + S_text, V) in the parameters' dtype, aux
    loss: the sum of the MoE layers' load-balancing losses, fp32, 0
    without MoE).  The frontend positions come first and rope counts
    them, so the text starts at position n_front.  ``remat`` recomputes each
    layer (and each application of zamba2's shared block) in the backward
    pass and keeps only its input, as the reference's
    ``jax.checkpoint(nothing_saveable)`` over the layer scan (and its
    ``jax.checkpoint`` of each sLSTM layer)."""
    x = embed_lookup(params["embed"], tokens, tied=cfg.tie_embeddings)
    if frontend_embeds is not None:
        fe = frontend_embeds.to(x.dtype)
        if cfg.frontend == "vision":                 # CLIP patch embeddings
            fe = torch.matmul(fe, params["frontend_proj"])
        x = torch.cat([fe, x], dim=1)                # audio: frames as is
    x = shard_hint(x, "dp", None, "model")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_pattern == "xlstm":
        x = _xlstm_forward(params, cfg, x, remat)
    else:
        S = x.shape[1]
        rd = int(cfg.resolved_head_dim * cfg.rotary_fraction)
        cos, sin = rope_frequencies(cfg.resolved_head_dim, S, cfg.rope_theta,
                                    rotary_dim=rd, device=x.device)
        if cfg.block_pattern == "attn":
            for blk in _unstack(params["blocks"], cfg.n_layers):
                if cfg.is_moe:
                    x, a = _apply(_moe_block_fwd, remat, blk, x, cos, sin,
                                  cfg)
                    aux = aux + a
                else:
                    x = _apply(_block_fwd, remat, blk, x, cos, sin, cfg)
                x = shard_hint(x, "dp", None, "model")
        else:
            x = _hybrid_forward(params, cfg, x, cos, sin, remat)
    x = _norm(params, "final_ln", x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return shard_hint(torch.matmul(x, head), "dp", None, "model"), aux


def _hybrid_forward(params, cfg: ArchConfig, x, cos, sin, remat: bool):
    """zamba2: the shared block before each group of ``attn_every``
    Mamba-2 layers (38 layers: 7 applications)."""
    blocks = _unstack(params["mamba_blocks"], cfg.n_layers)
    for g in range(0, cfg.n_layers, cfg.attn_every):
        x = _apply(_block_fwd, remat, params["shared_attn"], x, cos, sin, cfg)
        for blk in blocks[g:g + cfg.attn_every]:
            x = shard_hint(_apply(_mamba_fwd, remat, blk, x, cfg),
                           "dp", None, "model")
    return x


def _xlstm_blocks(params, cfg: ArchConfig):
    n_m, n_s = _xlstm_counts(cfg)
    return (_unstack(params["mlstm_blocks"], n_m),
            _unstack(params["slstm_blocks"], n_s) if n_s else [])


def _xlstm_forward(params, cfg: ArchConfig, x, remat: bool):
    """xlstm: the runs of mLSTM layers and the sLSTM layers between them,
    in the reference's order (:func:`_xlstm_layout`)."""
    mblocks, sblocks = _xlstm_blocks(params, cfg)
    for kind, first, n in _xlstm_layout(cfg):
        if kind == "m":
            for blk in mblocks[first:first + n]:
                x = shard_hint(_apply(_mlstm_fwd, remat, blk, x, cfg),
                               "dp", None, "model")
        else:
            x = _apply(_slstm_fwd, remat, sblocks[first], x, cfg)
    return x


def loss_fn(params: Dict[str, Any], cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32 over the text positions (the
    frontend's carry no loss): (loss, {"nll", "aux"})."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("frontend"), remat=remat)
    n_front = logits.shape[1] - batch["tokens"].shape[1]
    logits = logits[:, n_front:-1].float()
    targets = batch["labels"][:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def _block_decode(blk, x, ck, cv, pos, cos, sin, cfg: ArchConfig):
    h = _norm(blk, "ln1", x, cfg)
    x = x + attention.attn_decode(blk["attn"], h, ck, cv, pos, cos, sin, cfg)
    if cfg.is_moe:
        x = x + moe_mod.moe_decode(blk["moe"], _norm(blk, "ln2", x, cfg), cfg)
    elif cfg.d_ff:
        h = _norm(blk, "ln2", x, cfg)
        x = x + mlp_mod.mlp_decode(blk["mlp"], h, cfg)
    return x


def decode_step(params: Dict[str, Any], cfg: ArchConfig,
                cache: Dict[str, Any], token: torch.Tensor,
                pos: int) -> torch.Tensor:
    """token: (B,) int; pos: the token's position.  Writes the token's keys
    and values (for zamba2 also each layer's SSM state and conv window; for
    xlstm each layer's recurrent state instead) into ``cache`` in place
    and returns logits (B, V)."""
    x = embed_lookup(params["embed"], token, tied=cfg.tie_embeddings)
    if cfg.block_pattern == "xlstm":
        x = _xlstm_decode(params, cfg, cache, x)
        x = _norm(params, "final_ln", x, cfg)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return shard_hint(x @ head, None, "model")
    rd = int(cfg.resolved_head_dim * cfg.rotary_fraction)
    cos, sin = rope_at(pos, rd, cfg.rope_theta, x.device)
    if cfg.block_pattern == "attn":
        for i, blk in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            x = _block_decode(blk, x, cache["k"][i], cache["v"][i], pos,
                              cos, sin, cfg)
    else:
        x = _hybrid_decode(params, cfg, cache, x, pos, cos, sin)
    x = _norm(params, "final_ln", x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return shard_hint(x @ head, None, "model")


def _hybrid_decode(params, cfg: ArchConfig, cache, x, pos, cos, sin):
    blocks = _unstack(params["mamba_blocks"], cfg.n_layers)
    ssm, conv = cache["mamba"]["ssm"], cache["mamba"]["conv"]
    for app, g in enumerate(range(0, cfg.n_layers, cfg.attn_every)):
        x = _block_decode(params["shared_attn"], x, cache["k"][app],
                          cache["v"][app], pos, cos, sin, cfg)
        for i in range(g, min(g + cfg.attn_every, cfg.n_layers)):
            blk = blocks[i]
            h = _norm(blk, "ln1", x, cfg)
            x = x + mamba2.mamba2_decode(blk, h, {"ssm": ssm[i],
                                                  "conv": conv[i]}, cfg)
    return x


def _xlstm_decode(params, cfg: ArchConfig, cache, x):
    mblocks, sblocks = _xlstm_blocks(params, cfg)
    for kind, first, n in _xlstm_layout(cfg):
        for i in range(first, first + n):
            if kind == "m":
                blk = mblocks[i]
                x = x + xlstm.mlstm_decode(
                    blk, _norm(blk, "ln1", x, cfg),
                    {"state": cache["mlstm"]["state"][i]}, cfg)
            else:
                blk = sblocks[i]
                x = x + xlstm.slstm_decode(
                    blk, _norm(blk, "ln1", x, cfg),
                    {k: t[i] for k, t in cache["slstm"].items()}, cfg)
    return x
