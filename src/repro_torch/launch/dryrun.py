"""Dry run of every cell on one card: the fit loop, then each cell that
fits run at full width and depth.

  python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k \\
      --microbatches-run 2 --attribution
  python -m repro_torch.launch.dryrun --all --attribution --out DIR
  python -m repro_torch.launch.dryrun --all --predict-only --device cpu \\
      --hbm 85029158912
  python -m repro_torch.launch.dryrun --all --predict-only --mesh 16x16 \\
      --flat-dp --device cpu --hbm 85029158912
  python -m repro_torch.launch.dryrun --arch gemma --shape decode_32k \\
      --reduced --batch 2 --seq-len 64 --hbm 3000000000 --device cpu \\
      --attribution
  python -m repro_torch.launch.dryrun --arch gemma --shape train_4k \\
      --reduced --batch 8 --seq-len 32 --hbm 40000000 --device cpu
  python -m repro_torch.launch.dryrun --arch musicgen --shape prefill_32k \\
      --reduced --batch 2 --seq-len 64 --hbm 3000000000 --device cpu

The counterpart of the reference's ``launch/dryrun.py`` on one card,
``n_chips`` 1 and each shape's global batch whole.  There is nothing to
compile, so each fit loop decides from a stated prediction of the peak:
exact bytes taken from the shapes (FakeTensorMode, the meta device),
activations from the formulas below, and a workspace measured on the card.

* **Decode cells** (``decode_32k``: batch 128 over a 32,768-row cache;
  ``long_500k``: batch 1 over 524,288 rows): the weights, the cache and
  ``DECODE_WORKSPACE``.  Under ``HBM_FRACTION`` of the card's memory (the
  reference's rule, there 0.95 x 16 GiB) the cell runs with a bf16 KV
  cache; over it, with the fp8 e4m3 cache (the reference's second
  attempt); over it still, it reports ``fits_hbm: false`` and is not run.
  A cell that runs fills its cache from a seed one layer at a time (slabs
  of at most ``FILL_SLAB`` elements) and runs ``decode_step`` at ``pos =
  seq_len - 1``, which reads the whole cache, as the reference's decode
  program does for its ``pos`` input.
* **Train cells** (``train_4k``: 256 x 4,096 tokens).  The mode is the
  reference's (:func:`offload_mode`): ``fused`` (``build_train_step``,
  AdamW with its fp32 master and moments on the card) or, where that state
  would take over ``OFFLOAD_SHARE`` of the card, ``offload-grads``
  (``build_grads_step``, a bf16 accumulator; the AdamW update runs as
  per-slice programs whose state lives on the host tier,
  :func:`offload_programs`).  The fit loop starts at ``auto_microbatches``
  and doubles the microbatch count, at most ``FIT_ATTEMPTS`` times, while
  the prediction (:func:`predict_train`) passes ``HBM_FRACTION`` of the
  card.  ``microbatches_run`` runs K of the fitted microbatches (the peak
  does not depend on K: the accumulator is allocated once).
* **Prefill cells** (``prefill_32k``: 32 x 32,768): ``lm.forward`` without
  remat under ``torch.no_grad``, returning the logits; one attempt
  (:func:`predict_prefill`), as the reference has no fallback.

A cell that runs draws bf16 weights and its inputs from a seed, runs one
warm-up step, then ``steps`` timed ones (host clock, each ending in a
synchronisation) with the kernel launches counted, the measured peak
beside the prediction and, with ``attribution``, the per-object access
histograms of one more step (:class:`..core.OperandAttributionSource`,
the objects registered as the reference's ``_ATTRIBUTION_OPERANDS``
registers them).  A train or prefill cell that runs also runs the
reference's two cost probes (:func:`cost_probes`) and, in offload mode,
its AdamW slice (:func:`offload_programs`).  The entry point runs on the
card unless ``--device cpu`` is given; off the card ``--hbm`` states the
memory the fit loop holds a cell to.

``--mesh 16x16`` or ``2x16x16`` (the reference's one- and two-pod meshes,
``--flat-dp`` its flat-DP profile) predicts each cell on that mesh from the
sharding rules alone (:func:`mesh_cell`): one device's bytes of the
parameters, the optimizer state and the cache, and the reference's offload
rule with this card's memory in place of a v5e chip's.  It predicts no
activations and runs nothing (ROADMAP P17).  ``--mesh 1``, the default, is
the one-card dry run above.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import _tree
from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..core import H100_HBM_HOST, OperandAttributionSource, Session
from ..distributed import sharding as shd
from ..kernels import ops
from ..models import lm
from ..models.common import E4M3, kv_cast, tree_bytes
from ..optim import AdamWConfig, adamw_update, global_norm, init_opt_state
from ..train.step import auto_microbatches, build_grads_step, build_train_step
from . import roofline
from .mesh import make_production_mesh

#: share of the card's memory a cell's predicted peak may take (the
#: reference's rule)
HBM_FRACTION = 0.95
#: bytes beside the weights and the cache that a decode cell's peak holds:
#: the fill's slab (FILL_SLAB fp32 elements, its clamp and its e4m3
#: result), a step's transients (the logits, B x vocab; an mLSTM layer's
#: state-sized outer product) and the allocator's rounding.  On an H100
#: the cells that ran took at most 0.5625 GiB over weights and cache
#: (gemma-2b's and chatglm3-6b's decode_32k)
DECODE_WORKSPACE = 2 * 1024 ** 3
#: elements of one fp32 draw when a cache is filled
FILL_SLAB = 1 << 26
DECODE_SHAPES = ("decode_32k", "long_500k")
KV_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": E4M3}

#: offload mode when the fused state, bf16 weights and the fp32 master and
#: moments (2 + 12 bytes a parameter), takes over this share of a chip's
#: memory (the reference's rule)
OFFLOAD_SHARE = 0.35
OFFLOAD_STATE_BYTES = 2 + 12
#: the reference's fit loop compiles at most this many attempts
FIT_ATTEMPTS = 4
#: bytes beside the prediction's named parts that a train cell's peak
#: holds: cuBLAS's workspaces, the rope tables, the loss's scalars and the
#: allocator's rounding.  On an H100 the train cells took at most 0.39 GB
#: over their named parts (phi-3-vision-4.2b and zamba2-1.2b train_4k)
TRAIN_WORKSPACE = 1024 ** 3
#: the same for a prefill cell (at most 0.3 GB over the named parts on an
#: H100: zamba2-1.2b prefill_32k at batch 1)
PREFILL_WORKSPACE = 1024 ** 3
#: bytes a logit costs at the start of the loss's backward: its fp32 copy
#: (kept for ``logsumexp``'s backward), the gather's gradient (fp32) and
#: ``logsumexp``'s backward, ``grad * (self - result).exp()``, whose
#: temporaries all live until the product is done: three fp32 tensors of
#: the logits' shape.  On an H100, gemma-2b's train_4k peak is its named
#: parts with 20 bytes a logit, to 0.25 GB
LOSS_BYTES_PER_LOGIT = 20
#: fp32 copies of the largest leaf that AdamW's update (and the global
#: norm before it) holds at once: the gradient in fp32 and one temporary
ADAMW_LEAF_COPIES = 2
#: the AdamW slice's scalars (the step, its float, the norm, the clip
#: factor, the bias corrections), each one of the caching allocator's
#: 512-byte blocks: the slice's measured peak is its tensors' bytes and
#: these (3,068 bytes over the tensors on an H100)
ADAMW_SCALAR_BYTES = 16 * 512
#: a probe's timings (their median is its ms), each of PROBE_BATCH runs
#: queued back to back, as a step's microbatches are, so that the host's
#: share of a run overlaps the card's (a 1-layer probe of musicgen-large
#: queues its launches about as fast as the card runs them: timed alone, a
#: run times the host); after warm-up runs for at least PROBE_WARMUP_S on
#: the card (its clocks settle as under a step), one elsewhere
PROBE_RUNS = 3
PROBE_BATCH = 4
PROBE_WARMUP_S = 1.0
#: the reference's offload slices, and its slice program's learning rate
N_SLICES = 12
OFFLOAD_LR = 1e-4
#: the reference's collective kinds (each 0 bytes on one card)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: the registered objects of each mode's step, as the reference's
#: ``_ATTRIBUTION_OPERANDS`` registers them
ATTRIBUTION_OBJECTS = {"fused": ("params", "opt_state"),
                       "offload-grads": ("params",),
                       "prefill": ("params",),
                       "decode": ("params", "kv_cache")}


#: ``--mesh`` names: the one-card dry run, and the reference's production
#: meshes (``--multi-pod off`` and ``on``)
MESHES = ("1", "16x16", "2x16x16")


def cell_id(cfg: ArchConfig, shape_name: str, mesh: str = "1") -> str:
    return f"{cfg.name}|{shape_name}|{'1xH100' if mesh == '1' else mesh}"


def _param_shapes(cfg: ArchConfig):
    """The bf16 parameters ``lm.init_params`` draws, as fake tensors: their
    shapes and dtypes from a run under FakeTensorMode (nothing
    allocated)."""
    with FakeTensorMode():
        return lm.init_params(cfg, torch.Generator(), device="cpu")


def weights_bytes(cfg: ArchConfig) -> int:
    """Bytes of the bf16 parameters ``lm.init_params`` draws."""
    return tree_bytes(_param_shapes(cfg))


def opt_state_bytes(params, opt_cfg: AdamWConfig) -> int:
    """Bytes of ``init_opt_state(params)``: the fp32 master, the moments
    and ``step``, from its shapes under FakeTensorMode."""
    with FakeTensorMode():
        fake = [torch.empty(t.shape, dtype=t.dtype) for t in
                _tree.leaves(params)]
        return tree_bytes(init_opt_state(fake, opt_cfg))


def cache_bytes(cfg: ArchConfig, shape: ShapeConfig, kv_dtype) -> int:
    return tree_bytes(lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device="meta", kv_dtype=kv_dtype))


def _has_kv(cfg: ArchConfig) -> bool:
    return cfg.block_pattern != "xlstm"


def fit(cfg: ArchConfig, shape: ShapeConfig, hbm_bytes: int
        ) -> Dict[str, Any]:
    """The decode fit loop: bf16 KV cache, then e4m3 if the prediction is
    over ``HBM_FRACTION`` of ``hbm_bytes`` (xlstm has no KV cache to
    switch).  Returns the chosen ``kv_dtype``, ``fits_hbm``, ``memory``
    (the chosen attempt's prediction, reference keys) and every
    ``attempt``."""
    limit, workspace = HBM_FRACTION * hbm_bytes, DECODE_WORKSPACE
    w = weights_bytes(cfg)
    attempts = []
    for name in KV_DTYPES:
        c = cache_bytes(cfg, shape, KV_DTYPES[name])
        peak = w + c + workspace
        attempts.append(dict(kv_dtype=name, weights_bytes=w, cache_bytes=c,
                             workspace_bytes=workspace, peak_bytes=peak,
                             fits=peak <= limit))
        if peak <= limit or not _has_kv(cfg):
            break
    last = attempts[-1]
    memory = dict(argument_bytes=last["weights_bytes"] + last["cache_bytes"],
                  weights_bytes=last["weights_bytes"],
                  cache_bytes=last["cache_bytes"],
                  workspace_bytes=workspace, peak_bytes=last["peak_bytes"],
                  limit_bytes=limit, hbm_bytes=hbm_bytes)
    return dict(kv_dtype=last["kv_dtype"], fits_hbm=last["fits"],
                memory=memory, attempts=attempts)


# ------------------------------------------------------ train and prefill
def offload_mode(cfg: ArchConfig, hbm_bytes: float, n_chips: int = 1
                 ) -> bool:
    """The reference's rule: a train cell runs in offload mode when the
    fused state, ``OFFLOAD_STATE_BYTES`` a parameter, takes over
    ``OFFLOAD_SHARE`` of each chip's ``hbm_bytes``."""
    state = cfg.n_params() * OFFLOAD_STATE_BYTES
    return state / n_chips > OFFLOAD_SHARE * hbm_bytes


def _reduced_layer_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """The cost probes' depths, the reference's: one and two groups of
    zamba2's shared block or of xlstm's sLSTM period, else 1 and 2."""
    if cfg.block_pattern == "mamba_shared_attn":
        g = cfg.attn_every
        return g, 2 * g
    if cfg.block_pattern == "xlstm":
        g = cfg.slstm_every or 2
        return g, 2 * g
    return 1, 2


def _frontend_scale(cfg: ArchConfig) -> float:
    """The frontend embeddings' std: CLIP patches as drawn (std 1, through
    ``frontend_proj``), audio frames at the token embeddings' scale."""
    return 1.0 if cfg.frontend == "vision" else 0.02


def input_batch(cfg: ArchConfig, shape: ShapeConfig,
                generator: torch.Generator, device) -> Dict[str, Any]:
    """The cell's inputs, the counterpart of the reference's
    ``input_specs``: ``tokens`` and ``labels`` (B, S) drawn from
    ``generator``, and for a frontend config ``frontend`` embeddings (B,
    ``frontend_tokens``, d) in bf16."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                   generator=generator, device=device),
           "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                   generator=generator, device=device)}
    if cfg.frontend:
        fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                         generator=generator, device=device)
        out["frontend"] = (fe * _frontend_scale(cfg)).to(torch.bfloat16)
    return out


def input_bytes(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Bytes of :func:`input_batch` (int64 tokens and labels)."""
    B, S = shape.global_batch, shape.seq_len
    front = B * cfg.frontend_tokens * cfg.d_model * 2 if cfg.frontend else 0
    return 2 * B * S * 8 + front


def _block_token_bytes(cfg: ArchConfig) -> Dict[str, int]:
    """Bytes a token costs in one layer of ``cfg``, by the module's code:
    ``live``, the most a forward without gradients holds at once (the
    largest of its parts); ``saved``, what a layer's recomputed forward
    keeps for its backward (the sum of its parts).  Parts (bf16 is 2 bytes
    an element, fp32 4):

    * attention block: the norm's fp32 copy, normalised and scaled values
      (14 d); q, k and v, their rotated copies and the kernel's operands
      (4 (H + 2K) D), q's rotation in fp32 (4 H D), the kernel's output and
      its permuted copy (4 H D); the MLP's hidden: gated 3 x 2 f (the gate,
      its activation, the product), plain 2 x 2 f (3 x for squared ReLU),
      MoE its top-k experts' capacity slots and shared experts;
    * Mamba-2 layer (d_in channels, N state, H heads, P head width): the
      input projection (2 (2 d_in + 2N + H)) and the conv's output (2
      (d_in + 2N)) in bf16, v = xs dt in fp32 (4 d_in), the gated norm's
      stage, when the scan's output, its skip, the gate and the norm's
      fp32 work are alive at once (22 d_in), and the scan's chunk states
      (4 H N P / 256);
    * mLSTM layer: as Mamba-2 with its 512 x 513 state a head;
    * sLSTM layer: the written-out scan's per-step gates and states in fp32
      (4 x 4 d) and its projections (2 x 8 d)."""
    d = cfg.d_model
    out: Dict[str, int] = {}
    if cfg.block_pattern in ("attn", "mamba_shared_attn"):
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        f = cfg.d_ff
        norm = 14 * d
        attn = 4 * (H + 2 * K) * D + 4 * H * D + 4 * H * D
        if cfg.is_moe:
            slots = cfg.moe_top_k * cfg.moe_capacity_factor
            mlp = int(2 * 3 * cfg.moe_d_ff * (slots + cfg.moe_shared_experts)
                      + 4 * cfg.moe_experts)
        elif cfg.mlp_type == "mlp":
            mlp = (3 if cfg.activation == "squared_relu" else 2) * 2 * f
        else:
            mlp = 3 * 2 * f
        out["attn"] = dict(live=max(norm, attn, mlp),
                           saved=2 * norm + attn + mlp)
    if cfg.block_pattern in ("mamba_shared_attn", "xlstm"):
        d_in = cfg.ssm_expand * d
        if cfg.block_pattern == "xlstm":
            H = cfg.n_heads
            P = d_in // H
            N = P
        else:
            P = cfg.ssm_head_dim
            H, N = d_in // P, cfg.ssm_state
        live = 2 * (2 * d_in + 2 * N + H) + 2 * (d_in + 2 * N) + 26 * d_in
        states = 4 * H * N * (P + 1) // 256
        key = "mamba" if cfg.block_pattern == "mamba_shared_attn" else "mlstm"
        out[key] = dict(live=live, saved=live + states)
    if cfg.block_pattern == "xlstm" and cfg.slstm_every:
        out["slstm"] = dict(live=2 * 8 * d, saved=4 * 4 * d + 2 * 8 * d)
    return out


def _n_checkpointed(cfg: ArchConfig) -> int:
    """The layer applications per-layer remat wraps: each keeps its input
    (zamba2's shared block is applied before each group of layers)."""
    if cfg.block_pattern == "mamba_shared_attn":
        return cfg.n_layers + -(-cfg.n_layers // cfg.attn_every)
    return cfg.n_layers


def activation_bytes(cfg: ArchConfig, batch: int, seq_len: int,
                     train: bool) -> Dict[str, int]:
    """The activations of one microbatch of ``batch`` sequences of
    ``seq_len`` tokens (frontend positions before them) at their peak,
    by the formula of the module (see :func:`_block_token_bytes`).

    Train (per-layer remat): ``boundaries``, each remat unit's bf16 input
    (L x T x d x 2); ``loss``, ``LOSS_BYTES_PER_LOGIT`` over the text
    positions' logits (T_text x V); ``layer``, one layer's recomputed
    forward and its backward (saved + live).  Prefill (no gradient):
    ``boundaries`` 0; ``loss``, the bf16 logits beside the final norm's
    input and output (T x (2V + 4d)); ``layer``, the residual stream, the
    block's normed input and the largest part alive (T x (4d + live)).
    ``peak`` is ``boundaries`` plus the larger of the other two."""
    T = batch * (seq_len + cfg.frontend_tokens)
    T_text = batch * seq_len
    d, V = cfg.d_model, cfg.vocab_size
    blocks = _block_token_bytes(cfg)
    if train:
        per = max(b["saved"] + b["live"] for b in blocks.values())
        out = dict(boundaries=_n_checkpointed(cfg) * T * d * 2,
                   loss=LOSS_BYTES_PER_LOGIT * T_text * V,
                   layer=T * per)
    else:
        per = max(b["live"] for b in blocks.values())
        out = dict(boundaries=0, loss=T * (2 * V + 4 * d),
                   layer=T * (4 * d + per))
    out["peak"] = out["boundaries"] + max(out["loss"], out["layer"])
    return out


def predict_train(cfg: ArchConfig, shape: ShapeConfig, mode: str,
                  microbatches: int, opt_cfg: Optional[AdamWConfig] = None
                  ) -> Dict[str, Any]:
    """The predicted peak of a train step at ``microbatches``: exact bytes
    of the bf16 weights, of ``init_opt_state``'s master, moments and step
    (fused only), of the gradient accumulator (fp32 when fused, bf16 in
    offload mode, none at one microbatch) and of the inputs;
    ``TRAIN_WORKSPACE``; and the largest of four phases of a microbatch
    (``phase_bytes``): the loss's backward (the remat boundaries and the
    logits' fp32 work, :func:`activation_bytes`), a layer's backward (the
    larger of the boundaries and one microbatch's gradients, the weights'
    bytes, and one layer's activations), the backward's end (the
    gradients and the largest leaf, which ``unbind``'s backward stacks
    anew) and, fused, AdamW's update (``ADAMW_LEAF_COPIES`` fp32 copies of
    the largest leaf)."""
    opt_cfg = opt_cfg or AdamWConfig()
    params = _param_shapes(cfg)
    leaves = _tree.leaves(params)
    n = sum(t.numel() for t in leaves)
    w = tree_bytes(params)
    fused = mode == "fused"
    opt = opt_state_bytes(params, opt_cfg) if fused else 0
    acc = (4 if fused else 2) * n if microbatches > 1 else 0
    act = activation_bytes(cfg, shape.global_batch // microbatches,
                           shape.seq_len, train=True)
    largest = max(t.numel() * t.element_size() for t in leaves)
    phases = {
        # the loss's backward: every remat boundary, the logits' fp32 work
        "loss": act["boundaries"] + act["loss"],
        # a layer's backward: the boundaries still held give way to the
        # gradients made, so at most the larger of the two beside it
        "layer": max(act["boundaries"], w) + act["layer"],
        # the backward's end: one microbatch's gradients, and the stack
        # that gathers a stacked leaf's per-layer gradients (its bytes)
        "end": w + largest,
        # fused, AdamW's update: the accumulator is its gradient
        "update": (ADAMW_LEAF_COPIES * 4 * max(t.numel() for t in leaves)
                   if fused else 0)}
    inputs = input_bytes(cfg, shape)
    phase = max(phases, key=phases.get)
    peak = w + opt + acc + inputs + phases[phase] + TRAIN_WORKSPACE
    return dict(microbatches=microbatches, weights_bytes=w,
                opt_state_bytes=opt, accumulator_bytes=acc, grads_bytes=w,
                input_bytes=inputs, activation_bytes=act,
                phase_bytes=phases, peak_phase=phase,
                workspace_bytes=TRAIN_WORKSPACE, peak_bytes=peak)


def predict_prefill(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The predicted peak of a prefill step: the weights and the inputs
    (exact), the forward's activations without gradients
    (:func:`activation_bytes`) and ``PREFILL_WORKSPACE``."""
    w = weights_bytes(cfg)
    act = activation_bytes(cfg, shape.global_batch, shape.seq_len,
                           train=False)
    inputs = input_bytes(cfg, shape)
    peak = w + inputs + act["peak"] + PREFILL_WORKSPACE
    return dict(microbatches=None, weights_bytes=w, input_bytes=inputs,
                activation_bytes=act, workspace_bytes=PREFILL_WORKSPACE,
                peak_bytes=peak)


def fit_train(cfg: ArchConfig, shape: ShapeConfig, hbm_bytes: int,
              opt_cfg: Optional[AdamWConfig] = None) -> Dict[str, Any]:
    """The train fit loop: the mode by :func:`offload_mode`; from
    ``auto_microbatches(cfg, B, S, 1, 1)``, double the microbatches while
    the prediction passes ``HBM_FRACTION`` of ``hbm_bytes`` and there are
    fewer than B, at most ``FIT_ATTEMPTS`` attempts (the reference's
    loop).  Each attempt's ``fits``: its peak within the limit."""
    limit = HBM_FRACTION * hbm_bytes
    mode = "offload-grads" if offload_mode(cfg, hbm_bytes) else "fused"
    B = shape.global_batch
    mb = auto_microbatches(cfg, B, shape.seq_len, 1, 1)
    attempts = []
    for _ in range(FIT_ATTEMPTS):
        a = predict_train(cfg, shape, mode, mb, opt_cfg)
        a["fits"] = a["peak_bytes"] <= limit
        attempts.append(a)
        if a["fits"] or mb >= B:
            break
        mb *= 2
    return dict(mode=mode, attempts=attempts, limit_bytes=limit)


def _memory(attempt: Dict[str, Any], limit: float, hbm: int
            ) -> Dict[str, Any]:
    """An attempt's prediction under the reference's ``memory`` keys."""
    mem = {k: v for k, v in attempt.items()
           if k not in ("fits", "microbatches")}
    args = attempt["weights_bytes"] + attempt.get("opt_state_bytes", 0) \
        + attempt["input_bytes"]
    mem.update(argument_bytes=args, limit_bytes=limit, hbm_bytes=hbm)
    return mem


# ------------------------------------------------------------ the programs
def build_cell(cfg: ArchConfig, mode: str, *, microbatches: int = 1,
               opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    """The cell's program, the counterpart of the reference's
    ``build_cell``: ``step(params, opt_state, batch) -> dict``, per-layer
    remat in training.

    * ``fused``: ``build_train_step`` (AdamW in place, lr ``opt_cfg.lr``);
      returns ``metrics``;
    * ``offload-grads``: ``build_grads_step`` (a bf16 accumulator);
      returns ``grads`` and ``metrics``;
    * ``prefill``: ``lm.forward(..., remat=False)`` under
      ``torch.no_grad``; returns ``logits``."""
    opt_cfg = opt_cfg or AdamWConfig()
    if mode == "fused":
        train_step = build_train_step(cfg, opt_cfg, microbatches=microbatches,
                                      lr=opt_cfg.lr)

        def step(params, opt_state, batch):
            _, _, metrics = train_step(params, opt_state, batch)
            return {"metrics": metrics}
        return step
    if mode == "offload-grads":
        grads_step = build_grads_step(cfg, microbatches=microbatches)

        def step(params, opt_state, batch):
            grads, metrics = grads_step(params, batch)
            return {"grads": grads, "metrics": metrics}
        return step
    if mode == "prefill":
        def step(params, opt_state, batch):
            with torch.no_grad():
                logits, _ = lm.forward(params, cfg, batch["tokens"],
                                       batch.get("frontend"), remat=False)
            return {"logits": logits}
        return step
    raise ValueError(f"no program for mode {mode!r}")


def _rows(batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    return {k: v[:n] for k, v in batch.items()}


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _peak_since(device: str, base: int) -> Optional[int]:
    if device != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _start(device: str) -> int:
    """Reset the peak; the bytes allocated now (the base a peak counts
    from)."""
    if device != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _restart_peak(device: str) -> None:
    """Let the peak count from the bytes allocated now (the base stays
    what :func:`_start` read): the weights stay in it, the transients of
    their draws do not."""
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _extrap(a: float, b: float, L1: int, L2: int, L: int) -> float:
    """The reference's ``extrap``: the per-layer delta of two probes
    carried from L2 to L layers."""
    per_layer = (b - a) / (L2 - L1)
    return b + per_layer * (L - L2)


def cost_probes(cfg: ArchConfig, shape: ShapeConfig, mode: str,
                microbatches: int, *, device: str = "cuda",
                opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
                profile: Optional[Callable] = None) -> Dict[str, Any]:
    """The reference's two reduced-layer probes (L1 and L2 layers,
    :func:`_reduced_layer_counts`), each run on the card: the cell's
    program at one microbatch (``microbatches=1``) on one microbatch of the
    fitted size (the reference probes ``microbatches=1`` over the whole
    batch, which one card cannot hold), bf16 weights from ``seed``.  Each
    probe: ms a run (the least of ``PROBE_RUNS`` timings, ``ms_per_run``,
    each the mean of ``PROBE_BATCH`` runs queued back to back, after a
    warm-up; fused, the grads' runs and then AdamW's update, ``update_ms``,
    timed alone, its least), the measured peak, the launches a run.
    ``flops_per_device`` and ``bytes_per_device`` are the analytic terms of
    :func:`..launch.roofline.analytic_terms` at each probe's depth (there
    is no compiled program to ask), extrapolated with the reference's
    arithmetic; ``collective_bytes`` are 0 (one card).
    ``ms_a_step_extrapolated``: each probe's ms carried to the config's L
    layers, times ``microbatches`` (fused: AdamW's part once a step).  The
    least run and not the median: the extrapolation multiplies the probes' difference by
    (L - L2) / (L2 - L1), 16 at gemma-2b, whose 2-layer prefill probe
    took 98.7-112.9 ms a run on an H100 (the 1-layer one 71.1-75.5): the
    medians put its forward 45 % over the measured one, the least runs
    within 15 %.  ``profile(run, runs, wall_ms)``, if given (as
    :func:`run_cell`'s ``probe_profile``), is called after the timed runs
    with a function that runs ``PROBE_BATCH`` more; its
    ``device_busy_ms_per_step`` (plus ``update_ms``, fused) is the probe's
    ``device_ms``, and the extrapolation carries ``device_ms`` and not
    ``ms``: a probe of one or two layers can be bound by the host's
    launches where the full depth is not, so that its wall time moves
    with the host's speed, and the extrapolation, which multiplies the
    probes' difference, moves more."""
    opt_cfg = opt_cfg or AdamWConfig()
    L1, L2 = _reduced_layer_counts(cfg)
    L = cfg.n_layers
    b = shape.global_batch // microbatches
    out: Dict[str, Any] = {}
    for Lp in (L1, L2):
        c = dataclasses.replace(cfg, n_layers=Lp)
        terms = roofline.analytic_terms(c, shape, {"mode": mode,
                                                   "microbatches":
                                                   microbatches})
        probe: Dict[str, Any] = {
            "cost": {"flops": terms["flops_per_chip"],
                     "bytes": terms["hbm_bytes_per_chip"]},
            "collectives": {k: {"count": 0, "bytes": 0.0}
                            for k in COLLECTIVES}}
        base = _start(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = lm.init_params(c, gen, device=device, dtype=torch.bfloat16)
        state = init_opt_state(params, opt_cfg) if mode == "fused" else None
        batch = _rows(input_batch(c, dataclasses.replace(
            shape, global_batch=b), gen, device), b)
        _restart_peak(device)
        grads_step = (build_cell(c, "offload-grads") if mode == "fused"
                      else None)
        step = build_cell(c, mode, microbatches=1, opt_cfg=opt_cfg)
        t_warm = time.perf_counter()
        while True:     # warm-up: the card's clocks settle as in a step
            res = None
            res = step(params, state, batch)
            _sync(device)
            if (device != "cuda"
                    or time.perf_counter() - t_warm >= PROBE_WARMUP_S):
                break
        res = None
        ops.reset_launch_counts()
        ms, upd = [], []
        for _ in range(PROBE_RUNS):
            # PROBE_BATCH runs queued back to back, one synchronisation
            t = time.perf_counter()
            for _ in range(PROBE_BATCH):
                res = None
                res = (grads_step or step)(params, state, batch)
            _sync(device)
            run_ms = 1e3 * (time.perf_counter() - t) / PROBE_BATCH
            if grads_step is not None:  # fused: AdamW's update, timed alone
                t = time.perf_counter()
                adamw_update(res["grads"], params, state, opt_cfg,
                             opt_cfg.lr)
                _sync(device)
                upd.append(1e3 * (time.perf_counter() - t))
                run_ms += upd[-1]
            ms.append(run_ms)
        launches = ops.launch_counts()
        runs = PROBE_RUNS * PROBE_BATCH
        probe.update(
            ms=min(ms), ms_per_run=ms,
            measured_peak_bytes=_peak_since(device, base),
            launches={k: n / runs for k, n in launches.items() if n})
        if upd:
            probe["update_ms"] = min(upd)
        if profile is not None:
            def run():
                for _ in range(PROBE_BATCH):
                    (grads_step or step)(params, state, batch)
            prof = profile(run, PROBE_BATCH, min(ms) - min(upd or [0.0]))
            probe["device_ms"] = (prof["device_busy_ms_per_step"]
                                  + min(upd or [0.0]))
            probe["profile"] = prof
        out[f"L{Lp}"] = probe
        del params, state, batch, res
    c1, c2 = out[f"L{L1}"], out[f"L{L2}"]

    ex = lambda key: _extrap(c1[key], c2[key], L1, L2, L)  # noqa: E731
    # the probes' ms (profiled: their device ms) carried to L layers, times
    # the microbatches (fused: AdamW's part once)
    key = "ms" if profile is None else "device_ms"
    step_ms = ex(key) * microbatches
    if mode == "fused":
        step_ms = (ex(key) - ex("update_ms")) * microbatches + ex(
            "update_ms")
    flops = _extrap(c1["cost"]["flops"], c2["cost"]["flops"], L1, L2, L)
    hbytes = _extrap(c1["cost"]["bytes"], c2["cost"]["bytes"], L1, L2, L)
    return {"probe_layers": [L1, L2], "flops_per_device": flops,
            "bytes_per_device": hbytes,
            "collective_bytes": {k: 0.0 for k in COLLECTIVES},
            "cost_source": "analytic: launch/roofline.py analytic_terms at "
                           "each probe's depth",
            "probe_batch": b,
            "reduced": {"probe_batch": [shape.global_batch, b]},
            "ms_a_step_extrapolated": step_ms, "extrapolated_from": key,
            "probes": out}


def offload_slice_step(blocks, grads, opt_cfg: AdamWConfig
                       ) -> Dict[str, Any]:
    """One offload slice's program: its fp32 master and moments
    (``init_opt_state``) and one ``adamw_update`` in place at
    ``OFFLOAD_LR``, the reference's slice program's rate.  Returns the
    state."""
    state = init_opt_state(blocks, opt_cfg)
    adamw_update(grads, blocks, state, opt_cfg, OFFLOAD_LR)
    return state


def offload_programs(cfg: ArchConfig, shape: ShapeConfig,
                     opt_cfg: Optional[AdamWConfig] = None,
                     n_slices: int = N_SLICES, *, run: bool = False,
                     device: str = "cuda", seed: int = 0) -> Dict[str, Any]:
    """The per-slice AdamW program of offload mode, the counterpart of the
    reference's ``offload_programs``: one slice is ``max(1, L //
    n_slices)`` layers' ``blocks`` leaves (embed and head get their own
    slice; blocks dominate).  Predicted peak: the slice's bf16 parameters
    and its gradients, ``init_opt_state``'s master, moments and step (exact
    bytes), AdamW's ``ADAMW_LEAF_COPIES`` fp32 copies of its largest leaf
    and its scalars (``ADAMW_SCALAR_BYTES``).  ``run``: on ``device`` the
    slice's parameters, state and gradients (drawn from ``seed``) are
    allocated and the slice's update runs once
    (:func:`offload_slice_step`); ``slice_peak_bytes`` is then the
    measured peak, else the prediction.
    The state's streaming through the mover is not run (the reference
    never runs it)."""
    opt_cfg = opt_cfg or AdamWConfig()
    L_slice = max(1, cfg.n_layers // n_slices)
    c = dataclasses.replace(cfg, n_layers=L_slice)
    shapes = {k: v for k, v in _param_shapes(c).items() if "blocks" in k}
    leaves = _tree.leaves(shapes)
    pbytes = tree_bytes(shapes)
    state = opt_state_bytes(shapes, opt_cfg)
    predicted = (2 * pbytes + state + ADAMW_LEAF_COPIES * 4
                 * max(t.numel() for t in leaves) + ADAMW_SCALAR_BYTES)
    out: Dict[str, Any] = {
        "n_slices": n_slices, "layers_per_slice": L_slice,
        "slice_params_bytes": pbytes,
        "slice_peak_bytes_predicted": predicted,
        "slice_peak_bytes": predicted, "slice_peak_measured": False,
        "slice_state_bytes_per_chip": int(state),
        "host_resident_bytes_per_chip": int(cfg.n_params() * 12),
        "note": "fp32 master+moments live on host tier; the Unimem mover "
                "streams slices through HBM overlapped with backward "
                "(paper Fig 5/6 trigger-point schedule); the streaming is "
                "not run here"}
    if not run:
        return out
    base = _start(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    full = lm.init_params(c, gen, device=device, dtype=torch.bfloat16)
    blocks = {k: v for k, v in full.items() if "blocks" in k}
    del full
    _restart_peak(device)
    grads = _tree.unflatten(_tree.flatten(blocks)[1], [
        (torch.randn(t.shape, generator=gen, device=device) * 1e-3
         ).to(t.dtype) for t in _tree.leaves(blocks)])
    t0 = time.perf_counter()
    st = offload_slice_step(blocks, grads, opt_cfg)
    _sync(device)
    out["slice_update_ms"] = 1e3 * (time.perf_counter() - t0)
    measured = _peak_since(device, base)
    if measured is not None:
        out.update(slice_peak_bytes=measured, slice_peak_measured=True)
    out["slice_finite"] = bool(all(torch.isfinite(t).all().item()
                                   for t in _tree.leaves(blocks)))
    del blocks, grads, st
    return out


# ---------------------------------------------------------- attribution
def fill_cache(cache: Dict[str, Any], generator: torch.Generator) -> None:
    """Every cache leaf drawn N(0, 1) from ``generator``, one layer (the
    leading axis) at a time and at most FILL_SLAB elements a draw, cast as
    the decode writes it (:func:`..models.common.kv_cast`)."""
    for leaf in _tree.leaves(cache):
        for layer in leaf:
            flat = layer.view(-1)
            for part in flat.split(FILL_SLAB):
                part.copy_(kv_cast(torch.randn(
                    part.shape, generator=generator, dtype=torch.float32,
                    device=generator.device), part.dtype))


def _summary(sample) -> Dict[str, Any]:
    """Each object's accesses and normalised bins, as the reference's
    ``unimem_attribution`` summarises them."""
    out: Dict[str, Any] = {}
    for obj, acc in sorted(sample.accesses.items()):
        bins = np.asarray((sample.access_bins or {}).get(obj, []))
        entry: Dict[str, Any] = {"accesses": float(acc)}
        if bins.size and bins.sum() > 0:
            w = bins / bins.sum()
            entry["n_bins"] = int(bins.size)
            entry["nonzero_bins"] = int((bins > 0).sum())
            entry["peak_over_mean"] = float(w.max() * bins.size)
            entry["bins"] = [round(float(x), 6) for x in w]
        out[obj] = entry
    return out


def unimem_attribution(objects: Dict[str, Any], step: Callable[[], Any],
                       n_bins: int = 64) -> Dict[str, Any]:
    """``objects`` (name -> tree; every object but ``params`` chunkable,
    as the reference registers them) in a ``Session(H100_HBM_HOST)``, one
    run of ``step`` recorded, its sample summarised."""
    sess = Session(H100_HBM_HOST)
    for name, tree in objects.items():
        sess.register(name, tree, chunkable=(name != "params"))
    src = OperandAttributionSource(sess, n_bins=n_bins)
    with src.record("step"):
        step()
    return _summary(src.collect("step"))


# ------------------------------------------------------------ mesh cells
def mesh_cell(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
              hbm_bytes: int, flat_dp: bool = False) -> Dict[str, Any]:
    """A cell on the reference's production mesh (``16x16`` or
    ``2x16x16``): one device's bytes of the bf16 parameters under
    ``param_specs``, of the optimizer state under ``opt_specs`` (train
    cells) and of the cache under ``cache_specs`` at the shape's global
    batch (decode cells: a bf16 KV cache, the reference's first attempt),
    from ``shard_bytes``; the mode from the reference's offload rule,
    ``hbm_bytes`` a chip.  No activations are predicted and nothing runs."""
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    n_chips = mesh.size
    flat_before = shd.flat_dp()
    shd.set_flat_dp(flat_dp)
    try:
        params = _param_shapes(cfg)
        pspecs = shd.param_specs(mesh, params)
        per_device = {"params": shd.shard_bytes(params, pspecs, mesh)}
        if shape.kind == "train":
            offload = offload_mode(cfg, hbm_bytes, n_chips)
            mode = "offload-grads" if offload else "fused"
            with FakeTensorMode():
                fake = _tree.unflatten(
                    _tree.flatten(params)[1],
                    [torch.empty(t.shape, dtype=t.dtype)
                     for t in _tree.leaves(params)])
                opt = init_opt_state(fake, AdamWConfig())
            per_device["opt_state"] = shd.shard_bytes(
                opt, shd.opt_specs(mesh, opt, params, pspecs), mesh)
        elif shape.kind == "prefill":
            mode = "prefill"
        else:
            mode = "decode"
            cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
            per_device["cache"] = shd.shard_bytes(
                cache, shd.cache_specs(mesh, cfg, cache, shape.global_batch),
                mesh)
    finally:
        shd.set_flat_dp(flat_before)
    state = cfg.n_params() * OFFLOAD_STATE_BYTES
    return {"cell": cell_id(cfg, shape.name, mesh_name), "status": "ok",
            "mode": mode, "n_chips": n_chips, "mesh": mesh.shape,
            "flat_dp": flat_dp, "batch": shape.global_batch,
            "seq_len": shape.seq_len, "n_params": cfg.n_params(),
            "per_device_bytes": per_device,
            "state_bytes_per_chip": state / n_chips,
            "offload_limit_bytes": OFFLOAD_SHARE * hbm_bytes,
            "hbm_bytes": hbm_bytes, "predicted": "sharded state only",
            "ran": False}


# ------------------------------------------------------------------ cells
def run_cell(arch: str, shape_name: str, *, device: str = "cuda",
             hbm_bytes: Optional[int] = None, reduced: bool = False,
             batch: Optional[int] = None, seq_len: Optional[int] = None,
             steps: int = 3, attribution: bool = False,
             predict_only: bool = False, seed: int = 0,
             microbatches_run: Optional[int] = None, probes: bool = True,
             profile: Optional[Callable] = None,
             probe_profile: Optional[Callable] = None, mesh: str = "1",
             flat_dp: bool = False) -> Dict[str, Any]:
    """One cell's record.  ``reduced``, ``batch`` and ``seq_len`` cut it
    and ``microbatches_run`` cuts a train step to that many of its fitted
    microbatches (each listed under ``reduced``); ``hbm_bytes`` defaults
    to the card's ``total_memory``; ``probes``: a train or prefill cell
    that runs also runs its cost probes (an offload cell runs its AdamW
    slice in any case); ``profile(run, steps, wall_ms)``, if given, is called after the
    timed steps with a function that runs ``steps`` more and its result
    stored under ``profile``; ``probe_profile``, the same for each cost
    probe, which then extrapolate their device time (:func:`cost_probes`).
    ``mesh`` other than "1" (with ``flat_dp``) predicts the cell on that
    production mesh (:func:`mesh_cell`; with ``predict_only`` only)."""
    if mesh not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, not {mesh!r}")
    if mesh != "1" and not predict_only:
        raise ValueError("a cell on a production mesh is predicted only "
                         "(give predict_only)")
    cfg = get_config(arch)
    cuts: Dict[str, Any] = {}
    if reduced:
        cfg, cuts["config"] = cfg.reduced(), "reduced()"
    shape = SHAPES[shape_name]
    cid = cell_id(cfg, shape_name, mesh)
    ok, why = cfg.shape_applicable(shape)
    if not ok:
        return {"cell": cid, "status": "skipped", "reason": why}
    if batch is not None:
        cuts["batch"] = [shape.global_batch, batch]
    if seq_len is not None:
        cuts["seq_len"] = [shape.seq_len, seq_len]
    if batch is not None or seq_len is not None:
        shape = dataclasses.replace(
            shape, global_batch=batch or shape.global_batch,
            seq_len=seq_len or shape.seq_len)
    if hbm_bytes is None:
        if device != "cuda":
            raise ValueError("dryrun: give --hbm off the card")
        hbm_bytes = torch.cuda.get_device_properties(0).total_memory
    if mesh != "1":
        rec = mesh_cell(cfg, shape, mesh, hbm_bytes, flat_dp)
        rec["reduced"] = cuts or None
        return rec
    if shape.kind == "decode":
        return _decode_cell(cfg, shape, cid, cuts, device=device,
                            hbm_bytes=hbm_bytes, steps=steps,
                            attribution=attribution,
                            predict_only=predict_only, seed=seed,
                            profile=profile)
    return _step_cell(cfg, shape, cid, cuts, device=device,
                      hbm_bytes=hbm_bytes, steps=steps,
                      attribution=attribution, predict_only=predict_only,
                      seed=seed, microbatches_run=microbatches_run,
                      probes=probes, profile=profile,
                      probe_profile=probe_profile)


def _decode_cell(cfg, shape, cid, cuts, *, device, hbm_bytes, steps,
                 attribution, predict_only, seed, profile):
    fitted = fit(cfg, shape, hbm_bytes)
    B, S = shape.global_batch, shape.seq_len
    rec: Dict[str, Any] = {
        "cell": cid, "status": "ok", "mode": "decode", "n_chips": 1,
        "microbatches": None, "kv_dtype": fitted["kv_dtype"],
        "memory": fitted["memory"], "fits_hbm": fitted["fits_hbm"],
        "fit_attempts": fitted["attempts"], "batch": B, "seq_len": S,
        "pos": S - 1, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_params": cfg.n_params(), "reduced": cuts or None,
        "device": device, "ran": False}
    if predict_only or not fitted["fits_hbm"]:
        return rec
    kv = KV_DTYPES[fitted["kv_dtype"]]
    if device == "cuda":
        rec["device_name"] = torch.cuda.get_device_name(0)
    base = _start(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=device, dtype=torch.bfloat16)
    cache = lm.init_cache(cfg, B, S, device=device, kv_dtype=kv)
    fill_cache(cache, gen)
    token = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                          device=device)
    _sync(device)
    rec["init_s"] = time.perf_counter() - t0
    pos = S - 1

    def step():
        return lm.decode_step(params, cfg, cache, token, pos)

    logits = step()                                   # warm-up
    _sync(device)
    ops.reset_launch_counts()            # the cell's path starts here
    secs = []
    for _ in range(steps):
        t = time.perf_counter()
        logits = step()
        _sync(device)
        secs.append(time.perf_counter() - t)
    launches = ops.launch_counts()       # ... and ends here
    ms = [1e3 * s for s in secs]
    rec.update(ran=True, steps=steps, ms_per_step=ms,
               ms_a_step=statistics.median(ms), launches=launches,
               launches_per_step={k: n / steps for k, n in launches.items()
                                  if n},
               logits_shape=list(logits.shape),
               logits_finite=bool(torch.isfinite(logits).all().item()))
    peak = _peak_since(device, base)
    if peak is not None:
        rec["memory"]["measured_peak_bytes"] = peak
    if profile is not None:
        def run():
            for _ in range(steps):
                step()
        rec["profile"] = profile(run, steps, min(ms))
    if attribution:
        rec["unimem_attribution"] = unimem_attribution(
            {"params": params, "kv_cache": cache}, step)
    del params, cache, logits
    return rec


def _step_cell(cfg, shape, cid, cuts, *, device, hbm_bytes, steps,
               attribution, predict_only, seed, microbatches_run, probes,
               profile, probe_profile):
    """A train or prefill cell (see the module's docstring)."""
    opt_cfg = AdamWConfig()
    limit = HBM_FRACTION * hbm_bytes
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fitted = fit_train(cfg, shape, hbm_bytes, opt_cfg)
        mode, attempts = fitted["mode"], fitted["attempts"]
    else:
        mode = "prefill"
        a = predict_prefill(cfg, shape)
        a["fits"] = a["peak_bytes"] <= limit
        attempts = [a]
    last = attempts[-1]
    mb = last["microbatches"]
    fits = last["fits"]
    rec: Dict[str, Any] = {
        "cell": cid, "status": "ok", "mode": mode, "n_chips": 1,
        "microbatches": mb, "memory": _memory(last, limit, hbm_bytes),
        "fits_hbm": fits, "fit_attempts": attempts, "batch": B,
        "seq_len": S, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_params": cfg.n_params(), "reduced": cuts or None,
        "device": device, "ran": False}
    if mode == "offload-grads":
        off = offload_programs(cfg, shape, opt_cfg)
        rec["offload"] = off
        # device residency: the grads program's peak and a streamed slice
        rec["fits_hbm"] = fits = fits and (
            last["peak_bytes"] + off["slice_peak_bytes"] <= hbm_bytes)
    if predict_only or not fits:
        return rec
    K = mb if (mb is None or microbatches_run is None) else microbatches_run
    if mb is not None:
        if not 1 <= K <= mb or (K == 1 and mb > 1):
            raise ValueError(f"microbatches_run must be 2..{mb} (the "
                             "accumulator is what the fit holds)"
                             if mb > 1 else "microbatches_run must be 1")
        if K != mb:
            cuts["microbatches_run"] = [mb, K]
            rec["reduced"] = cuts
    rows = B if mb is None else K * (B // mb)
    if device == "cuda":
        rec["device_name"] = torch.cuda.get_device_name(0)
    base = _start(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=device, dtype=torch.bfloat16)
    state = init_opt_state(params, opt_cfg) if mode == "fused" else None
    inputs = input_batch(cfg, shape, gen, device)
    run_batch = _rows(inputs, rows)
    _sync(device)
    rec["init_s"] = time.perf_counter() - t0
    # the weights' fp32 draws are not the program's: its peak counts from
    # here, the weights and inputs in it
    _restart_peak(device)
    step = build_cell(cfg, mode, microbatches=K or 1, opt_cfg=opt_cfg)
    res = step(params, state, run_batch)                # warm-up
    res = None
    _sync(device)
    ops.reset_launch_counts()            # the cell's path starts here
    secs = []
    for _ in range(steps):
        t = time.perf_counter()
        res = None                       # one step's outputs at a time
        res = step(params, state, run_batch)
        _sync(device)
        secs.append(time.perf_counter() - t)
    launches = ops.launch_counts()       # ... and ends here
    peak = _peak_since(device, base)
    ms = [1e3 * s for s in secs]
    per_mb = K or 1
    rec.update(ran=True, steps=steps, microbatches_run=K, ms_per_step=ms,
               ms_a_step=statistics.median(ms),
               ms_a_microbatch=statistics.median(ms) / per_mb,
               launches=launches,
               launches_per_step={k: n / steps for k, n in launches.items()
                                  if n},
               launches_per_microbatch={k: n / steps / per_mb
                                        for k, n in launches.items() if n})
    if peak is not None:
        rec["memory"]["measured_peak_bytes"] = peak
    if mode == "prefill":
        logits = res["logits"]
        rec.update(logits_shape=list(logits.shape),
                   logits_finite=bool(torch.isfinite(logits).all().item()))
    else:
        m = res["metrics"]
        loss = float(m["loss"] if "loss" in m else m["nll"])
        gnorm = float(m["grad_norm"] if "grad_norm" in m
                      else global_norm(res["grads"]))
        rec.update(loss=loss, loss_finite=bool(np.isfinite(loss)),
                   grad_norm=gnorm)
    res = None
    if profile is not None:
        def run():
            for _ in range(steps):
                step(params, state, run_batch)
        rec["profile"] = profile(run, steps, min(ms))
    parts = {"init": rec["init_s"], "steps": sum(secs)}
    if attribution:
        t0 = time.perf_counter()
        rec.update(_step_attribution(cfg, mode, params, state,
                                     _rows(inputs, B // (mb or 1)), opt_cfg))
        parts["attribution"] = time.perf_counter() - t0
    del params, state, inputs, run_batch
    if probes:
        t0 = time.perf_counter()
        ri = cost_probes(cfg, shape, mode, mb or 1, device=device,
                         opt_cfg=opt_cfg, seed=seed, profile=probe_profile)
        rec["roofline_inputs"] = ri
        rec["ms_a_step_extrapolated"] = ri["ms_a_step_extrapolated"]
        parts["probes"] = time.perf_counter() - t0
    if mode == "offload-grads":
        t0 = time.perf_counter()
        rec["offload"] = offload_programs(cfg, shape, opt_cfg, run=True,
                                          device=device, seed=seed)
        parts["offload"] = time.perf_counter() - t0
    rec["seconds_by_part"] = parts
    return rec


def _step_attribution(cfg, mode, params, state, batch, opt_cfg
                      ) -> Dict[str, Any]:
    """One microbatch's step recorded with the objects of
    ``ATTRIBUTION_OBJECTS[mode]`` registered; for a train cell also its
    loss's forward alone (no gradient), so that the backward's share of
    the parameters' accesses shows (``params_step_over_forward``)."""
    trees = {"params": params, "opt_state": state}
    objects = {k: trees[k] for k in ATTRIBUTION_OBJECTS[mode]}
    step = build_cell(cfg, mode, opt_cfg=opt_cfg)
    out = {"unimem_attribution": unimem_attribution(
        objects, lambda: step(params, state, batch))}
    if mode != "prefill":
        def forward():
            with torch.no_grad():
                lm.loss_fn(params, cfg, batch)
        fwd = unimem_attribution({"params": params}, forward)
        out["unimem_attribution_forward"] = fwd
        out["params_step_over_forward"] = (
            out["unimem_attribution"]["params"]["accesses"]
            / fwd["params"]["accesses"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attribution", action="store_true",
                    help="per-object access histograms of one step")
    ap.add_argument("--predict-only", action="store_true",
                    help="the fit loop only: run no cell")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hbm", type=int, default=None,
                    help="bytes the fit loop holds a cell to (default: the "
                         "card's total_memory)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--microbatches-run", type=int, default=None,
                    help="a train step runs this many of its fitted "
                         "microbatches (default: all)")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--mesh", choices=MESHES, default="1",
                    help="16x16 / 2x16x16: the reference's production mesh, "
                         "sharded state predicted only")
    ap.add_argument("--flat-dp", action="store_true",
                    help="fold the model axis into DP (with --mesh)")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args()

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    results = []
    for a in archs:
        for s in shapes:
            try:
                r = run_cell(a, s, device=args.device, hbm_bytes=args.hbm,
                             reduced=args.reduced, batch=args.batch,
                             seq_len=args.seq_len, steps=args.steps,
                             attribution=args.attribution,
                             predict_only=args.predict_only,
                             microbatches_run=args.microbatches_run,
                             probes=not args.no_probes, mesh=args.mesh,
                             flat_dp=args.flat_dp)
            except (RuntimeError, ValueError) as e:   # report, go on
                mesh = "1xH100" if args.mesh == "1" else args.mesh
                r = {"cell": f"{a}|{s}|{mesh}", "status": "error",
                     "error": f"{type(e).__name__}: {e}"}
            results.append(r)
            print(json.dumps({k: v for k, v in r.items()
                              if not k.startswith("unimem_attribution")}),
                  flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                fn = r["cell"].replace("|", "_").replace("/", "_") + ".json"
                with open(os.path.join(args.out, fn), "w") as f:
                    json.dump(r, f, indent=2)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_run = sum(bool(r.get("ran")) for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run summary: {n_ok} ok ({n_run} run), {n_skip} skipped "
          f"(documented), {n_err} errors ==")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
