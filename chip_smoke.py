#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py
  python3 chip_smoke.py --parent DIR
  python3 chip_smoke.py --compare-matmul DIR
  python3 chip_smoke.py --slstm-autograd
  python3 chip_smoke.py --trace-drops
  python3 chip_smoke.py --probe-noise
  python3 chip_smoke.py --lr-sweep ARCH LAYERS LR [LR ...]

Drives the port's main path on the card and fails (non-zero exit, no
result line) if any phase fails:

1. device   -- the card (nvidia-smi name and power limit), torch and CUDA;
2. build    -- the seven kernels compiled from ``src/repro_torch/csrc``
               with nvcc for sm_90a, all at once, with the ptxas report
               (decode_attention, tiered_matmul, ssd_scan, ssd_scan_bwd
               and knapsack_dp compiled in every run, so that their reports
               are there to read: no spill, required), each bf16 flash
               kernel's HGMMA
               count and the SSD forward's and backward's HMMA (TF32, the
               chunk kernels) and DMMA (fp64, the sums kernels) counts
               (required), the e4m3 decode kernel's HMMA count and the
               warpgroup matmul kernel's HGMMA count (required);
3. check    -- each kernel against its plain PyTorch version at the
               reference tests' shapes and the serving and training
               shapes of gemma-2b, zamba2-1.2b, yi-6b, chatglm3-6b,
               xlstm-350m (the SSD kernels' wide route; v's rows as the
               model pads them, and unpadded), moonshot-v1-16b-a3b and
               dbrx-132b (decode at G 1 and 6, the flash pair at G 6, the
               attention and shared-expert products, and tiered_matmul's
               expert route at both models' decode shapes and edge
               cases: every row on one expert, experts no row picks),
               musicgen-large, phi-3-vision-4.2b and nemotron-4-340b
               (decode at D 96 and at G 12, D 192; the flash pair at D
               96, also over 2048 + 144 patch positions, and at G 12, D
               192; each layer's products, the plain MLP's two among them,
               nemotron's 2.7 GB w_up and w_down with the far end of the
               weight checked), with kernel / plain /
               bound / library times and the launch floor (an empty
               kernel); the flash-attention and SSD-scan backward kernels
               against autograd through the plain forward, the SSD one's
               d(log a) against float64 with decays near 1; the SSD
               forward and backward each the same bits from a second call;
               decode attention, tiered_matmul and the SSD forward and
               backward also behind a NaN fill of shared memory;
               tiered_matmul with the route and plan each shape took, the
               same bits from a second call, no store past M (a guarded
               buffer), and the wrapper's host time a call, both
               tensor-core routes timed at M = 4 to 128 on gemma-2b's
               w_gate and chatglm3-6b's w_down (where the wgmma route
               starts to win), the wgmma route at its threshold and one
               row below, at ragged M, K and N and behind a NaN fill; decode
               attention's e4m3 route (an fp8 cache) at
               gemma-2b's serving shape with fp32 and bf16 q, at zamba2's,
               chatglm3-6b's, dbrx-132b's and nemotron's G and D, at
               lengths 0 and 1, with the NaN encoding inside and past the
               valid rows, behind a NaN fill of shared memory, with every
               finite e4m3 code in K and V at G 8 and 16, and the C
               entry point refusing rows it cannot read; decode attention
               at the main path's longest reads (both full decode_32k
               shapes the dry run serves in e4m3, gemma-2b's and
               chatglm3-6b's over 32,768 rows, and zamba2-1.2b's long_500k
               over 524,288 bf16 rows), fp32 q at TOL[fp32] and bf16 q
               also against float64 within 2^-7 of the largest output;
               the flash forward at each dry-run prefill_32k cell's
               attention shape (gemma-2b's q (1, 1, 8, 32768, 256),
               zamba2-1.2b's (1, 32, 1, 32768, 64), musicgen-large's
               (2, 32, 1, 32832, 64) with a ragged last tile), q x 8, on
               three sampled query tiles, and the flash pair at each
               dry-run train cell's fitted microbatch, q x 8; the SSD
               forward at
               zamba2-1.2b's prefill_32k shape (B 1, S 32,768);
               tiered_matmul at M = 128 on gemma-2b's, chatglm3-6b's and
               xlstm-350m's decode products (the wgmma route required,
               each also behind a NaN fill) and at M = 1 on the long_500k
               cells' (zamba2-1.2b's and xlstm-350m's); and what
               the card's own cast to e4m3 gives at the range's edges, with
               ``kv_cast`` the same bits on the card as on the CPU; the
               knapsack DP (the planner's, ``core/knapsack.py``) byte for
               byte against its plain version and the numpy DP, one launch
               a call, its cluster's layout as the kernel computes it: the
               reference test's draw grown to 800 items (above the device
               threshold), n 489 to 3,051 at qcap 16,384, route 1 at qcap
               100,000 against route 2 and route 2 at qcap 250,000 (timed:
               kernel, plain, the numpy DP on the host, the keep table's
               copy to the host, ns an item, the chain floor), the
               cluster's size swept (timed), grids of qcap + 1
               no multiple of 8, n 1, sizes past the capacity and of 0, a
               tie-heavy case, both routes on one input, sizes that cross
               one and two ranks, last ranks full, short and empty,
               clusters of 1 to 16 ranks, behind a NaN fill of shared
               memory and a second call;
4. runtime  -- the Unimem runtime moving real tensors between HBM and
               pinned host memory (``backend="torch_async"``), bytes checked,
               plus host<->device copy rates for 1, 2 and 4 channels;
5. parity   -- reduced gemma-2b, zamba2-1.2b, yi-6b, chatglm3-6b,
               xlstm-350m, moonshot-v1-16b-a3b, dbrx-132b, musicgen-large,
               phi-3-vision-4.2b and nemotron-4-340b, fp32 weights, the
               card against the CPU; yi-6b, chatglm3-6b, dbrx-132b and
               nemotron also at their real G (8, 16, 6 and 12 query heads
               over one KV head), phi-3-vision and nemotron (at G 12) also
               at their real head widths (D 96 and 192), xlstm-350m also at
               one head (N 128, P 129: the SSD forward's wide route); the
               two frontend configs also through ``forward`` with their
               frontend embeddings; gemma-2b, chatglm3-6b at G 16 and
               zamba2-1.2b also with an e4m3 KV cache, and one decode
               step's attribution (the same PhaseSample on both devices);
6. sim      -- the discrete-event simulator on the card's host: the
               quickstart's CG workload DRAM-only, NVM-only and under
               Unimem, twice (same plan digest and iteration times), and
               the planner's wall time on each (re)plan;
6a. planner -- the reference's chunk fixture (``sim/planner_fixture.py``)
               at 2,000 and 3,000 chunks, each plan built with the numpy
               DP and with the DP on the card (``knapsack.use_device``):
               the same plan JSON and digest, solves of 8M to 50M cells,
               one knapsack_dp launch a solve above the threshold, and the
               build's wall time both ways;
6b. dryrun  -- ``launch/dryrun.py``'s fit prediction of every (config x
               shape) cell, then each decode cell predicted to fit run at
               full width and depth (gemma-2b and chatglm3-6b decode_32k
               in e4m3, zamba2-1.2b long_500k in bf16, xlstm-350m both)
               with its attribution, a profile of its steps and its
               roofline row (``launch/roofline.py``); then the train_4k
               and prefill_32k cells of DRYRUN_STEP_CELLS at full width
               and depth (gemma-2b train_4k in offload mode, zamba2-1.2b
               train_4k fused, 2 fitted microbatches a step; gemma-2b and
               zamba2-1.2b prefill_32k at batch 1, musicgen-large's at
               batch 2; musicgen-large, phi-3-vision-4.2b, yi-6b and
               chatglm3-6b train_4k), each one required to run, with its
               cost probes (each profiled, the extrapolation carried from
               their device time), its offload slice, its attribution and
               its roofline row: measured peak
               within the prediction and the prediction at most 1.25 x it,
               the launches of a microbatch, the probes' extrapolation
               within 25 % of the measured microbatch, all required;
7. serve    -- full-width gemma-2b (18 layers, d_model 2048, vocab 256000)
               served under the runtime, with every kernel launch counted;
8. train    -- full-width gemma-2b trained for 5 steps (batch 2 x 2048
               tokens, AdamW, per-layer remat) through ``train/loop.py``
               under the runtime, with every kernel launch counted;
9. serve_zamba2 -- full-width zamba2-1.2b (a shared attention block
               every 6 Mamba-2 layers, d_model 2048), cut to 12 of its 38
               layers (EARLIER_SERVE_LAYERS: the run's time limit), served
               the same way;
10. train_zamba2 -- full-width, full-depth zamba2-1.2b trained for 5
               steps of batch 2 x 4096 tokens (16 chunks of the SSD scan a
               sequence);
11. serve_yi, serve_chatglm3 -- full-width yi-6b (d_model 4096, 32 heads
               over 4 KV heads of 128, SwiGLU 11008) and chatglm3-6b (32
               heads over 2 KV heads, qkv bias, half-dim rotary, SwiGLU
               13696), cut to 8 layers (the time limit), served as
               gemma-2b is;
12. train_yi, train_chatglm3 -- the same at full width, cut to 8 layers
               (the whole model's training state does not fit 80 GB),
               trained as gemma-2b is;
13. serve_xlstm, train_xlstm -- full-width xlstm-350m (mLSTM layers
               with a 512 x 513 state a head, an sLSTM layer in every 8;
               d_model 1024) cut to 8 of its 24 layers (7 mLSTM, 1 sLSTM;
               the time limit: the sLSTM's loop is host-bound) served as
               gemma-2b is, and trained for 5 steps of batch 2 x 2048 twice
               (the same losses, bit for bit);
14. serve_moonshot, serve_dbrx, train_moonshot -- full-width
               moonshot-v1-16b-a3b (layers of 64 experts, top-6, 2
               shared) cut to 12 of its 48 layers (the time limit) and
               dbrx-132b cut to 8 of its 40 layers (16
               experts, top-4, layer norm, G 6: 263 GB of weights fit no
               tier) served as gemma-2b is, each routed product one launch
               of the expert route; moonshot cut to 4 layers trained for 5
               steps of batch 2 x 2048 twice (the same losses, bit for bit:
               the dispatch is deterministic);
15. serve_musicgen, train_musicgen, serve_phi3v, train_phi3v,
               serve_nemotron -- full-width, full-depth musicgen-large (48
               layers, the plain gelu MLP, layer norm) and phi-3-vision-
               4.2b (32 layers, D 96) served as gemma-2b is and trained for
               5 steps of batch 2 x 2048, each train phase with a frontend
               step (64 audio frames, 144 patch embeddings before the
               tokens, at full width); nemotron-4-340b (G 12, D 192, the
               plain squared-ReLU MLP of 73728) cut to 6 of its 96 layers
               (682 GB of weights fit no tier) served as gemma-2b is;
16. distributed -- the distributed layer on a world of one NCCL rank
               (``make_host_mesh``, a (1, 1) mesh, torn down at the end):
               full-width, full-depth gemma-2b's parameters through
               ``param_specs`` and ``distribute`` (each local shard its
               tensor's bits); its first 2 layers checkpointed and
               restored onto those shardings and onto the plain device
               (the saved bits, seconds of each); gemma-2b served (one
               request of the serve phase's shape) with and without the
               mesh hint (the same tokens and launches a step; ms and
               host ms a step); ``embed_lookup``'s hinted route at the
               256,000 x 2,048 table over 2 x 2,048 tokens against the
               plain gather (forward bits; the gradient's bits for exact
               sums); ``tree_compressed_psum`` over a 2-layer step's
               gradients (per leaf: sent as the CPU's quantizer gives it,
               the error x - sent, reduced == sent; its ms and bytes);
               ``pipeline_forward`` at S 1, M 4 through 2 blocks (the
               blocks' bits, the flash launches);
17. kernels -- one line with each kernel's numbers (the e4m3 route as
               ``decode_attention_e4m3``; knapsack_dp's launches from the
               planner phase).

Each phase prints one JSON object; the last line is the device object.
``--parent DIR`` also times the SSD forward and backward of the checkout
at DIR (the parent commit) in this run, and decode attention's e4m3 route
at both decode_32k shapes and gemma-2b's serving shape, and its
tiered_matmul at the dry run's M = 128 products, before and after this
checkout's check phase, and its knapsack DP at n 489 to 3,051 over qcap
16,384, and puts them in the kernels line.
The serve phases require every product of a decode step to be one launch
of the mma.sync matmul kernel (the MoE layers' routed products one of its
expert route), and report device operations a step; the dry run's decode
cells at batch 128 require each of theirs to be one launch of the
warpgroup (wgmma) matmul kernel.
``--compare-matmul DIR`` only times the serving products at M = 4 and the
dry run's at M = 128 through this checkout's tiered_matmul and through
that of the checkout at DIR (see
``compare_matmul``); ``--slstm-autograd`` only times one sLSTM layer's
forward and backward with and without its written-out gradient (see
``slstm_autograd``); ``--trace-drops`` only counts the kernels that
torch.profiler's trace loses at a session's head (see ``trace_drops``);
``--probe-noise`` only runs musicgen-large's train_4k cell with a host
slowed by a thread of its own and sets the probes' wall and device
extrapolations beside the measured microbatch (see ``probe_noise``);
``--lr-sweep`` only trains a config 5 steps at each rate given (see
``lr_sweep``).
Times are CUDA-event times over many queued launches (median), each
behind a device-side sleep so that no host delay falls inside a timed
pair, with the L2 cache flushed before each launch, since the serving and
training paths find weights, cache and activations cold.  Needs one CUDA card and nvcc; it stops at once without them.
"""

import dataclasses
import gc
import hashlib
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the training phase holds ~40 GB of state beside multi-GB transients
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch import _tree, sim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (H100_HBM_HOST, PAPER_DRAM_NVM,  # noqa: E402
                              ManualSource, ObjectRegistry,
                              OperandAttributionSource, RuntimeConfig,
                              Session, UnimemRuntime, calibrate)
from repro_torch.core import knapsack  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.grad_compression import (  # noqa: E402
    dequantize_int8, quantize_int8, tree_compressed_psum)
from repro_torch.distributed.pipeline import pipeline_forward  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import knapsack_dp as kdp  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, fill_shared_memory_nan)
from repro_torch.kernels.ref import decode_attention_f64  # noqa: E402
from repro_torch.kernels import tiered_matmul as mm  # noqa: E402
from repro_torch.models import common, lm, moe, xlstm  # noqa: E402
from repro_torch.models.common import E4M3, kv_cast, rms_norm  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update,  # noqa: E402
                               init_opt_state)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.sim import planner_fixture  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402
from repro_torch.train.step import (build_grads_step,  # noqa: E402
                                    build_train_step)

MB = 1024 ** 2
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BW = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12, E4M3: 1979e12}
TF32_PEAK = 495e12          # dense TF32 on the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}     # tests/test_kernels.py
# The backward in fp32: dk and dv sum over G*S stacked rows (16,384 at the
# training shape) in another order than the plain version.  There the
# plain version itself lies up to ~6e-5 from a float64 reference on an H100
# (the kernel_vs_f64 / plain_vs_f64 fields of that check row), so the
# reference's 2e-5 would measure the plain version's rounding.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The SSD scan is fp32 only: the reference's tolerance (tests/test_kernels.py).
# Its backward is held to the same 1e-4, on d(log a) = da * a rather than
# da (da = d(log a) / a magnifies a rounding of d(log a) by 1/a).
SSD_TOL = 1e-4
# Decays of the SSD checks.  "strong": a = sigmoid(randn), mean log a about
# -0.8, so the carried state, the dS carry and sub-tiles two or more below
# the diagonal reach the outputs scaled by e^-50 or less and a kernel that
# dropped them would pass.  "near1": a = exp(-U(1e-3, 0.02)), as real
# Mamba-2 heads (0.98 to 0.999): e^{cum_L} over a chunk of 256 is ~0.07 and
# a sub-tile 192 rows below the diagonal keeps ~0.13, so those terms weigh.
# There d(log a) sums terms up to |400| that cancel to as little as 0.03,
# and the fp32 plain version's own rounding reaches 0.98 of allclose(1e-4)
# (on the CPU, at the training shape): so with decays near 1 the kernel's
# d(log a) is held against the plain version run in float64, at SSD_TOL;
# and at the training shape, under both decays, no further from float64
# than the fp32 plain version (the reference's arithmetic).
SSD_DECAY_RANGE = (1e-3, 0.02)
# Peaked flash checks (q x 8) run in bf16, the path the tensor-core
# kernels serve.  In fp32 such scores make gradients of ~25 and outputs
# whose fp32 rounding, in any summation order, exceeds the fp32 tolerances:
# at (1, 1, 8, 300, 300, 256) the fp32 plain version itself lies 1.5e-5
# (output) and 1.27e-4 (dk) from float64, the unchanged FFMA kernel 2.7e-5
# and 2.5e-4 (H100).
PEAKED_DTYPES = (torch.bfloat16,)
PARITY_TOL = 1e-4
# zamba2's decode keeps each layer's conv window in bf16 (as the reference
# does): where the card's and the CPU's fp32 in_proj outputs straddle a
# bf16 rounding boundary, a window value rounds an ulp apart, and later
# layers and steps follow it.  On an H100 the logits lie 2.2e-4 apart with
# the bf16 window, 1.2e-5 with the window in fp32 on both sides (held to
# PARITY_TOL, as the forward is), and 0.70 with a decode kernel that drops
# the newest key
ZAMBA_DECODE_TOL = 1e-3
# The MoE configs' decode keeps its KV cache in bf16 (as the reference
# does): where the card's and the CPU's fp32 keys straddle a bf16 rounding
# boundary a cached value rounds an ulp apart.  On an H100 reduced
# moonshot-v1-16b-a3b's logits lay 4.7e-4 apart so (greedy tokens
# identical, its 600-position forward 1.2e-5); with the KV cache in fp32
# on both sides they are held to PARITY_TOL
MOE_DECODE_TOL = 1e-3
# The same holds for musicgen-large, phi-3-vision-4.2b and nemotron-4-340b
# (reduced: 4 KV heads, or D 96 and 192, where more cached values can
# straddle a boundary): on an H100 their card decode lay 1.9e-4 to 1.5e-3
# from the CPU's with the bf16 KV cache, their 600-position forward at most
# 2.1e-5.  Their decode is held to PARITY_TOL with an fp32 KV cache on both
# sides, and with the bf16 cache to the distance that rounding the cache
# to bf16 moves the CPU's own logits (bf16 against fp32 cache, the same
# steps): an ulp apart in a few cached values moves them less than
# rounding every one of them does
# The e4m3 cache (the dry run's decode_32k cells) on reduced gemma-2b,
# chatglm3-6b at its real G 16 and zamba2-1.2b, the card against the CPU:
# the logits are held to PARITY_TOL (zamba2's with its conv window in fp32
# on both sides; with the bf16 window, to ZAMBA_DECODE_TOL as its bf16
# cache is).  Beside it stands the distance that rounding the whole cache
# to e4m3 moves the CPU's own logits (e4m3 against fp32 cache), which must
# be at least E4M3_ROUNDING_FLOOR: a card that kept the cache in fp32 or
# bf16 would lie about that far from the CPU and fail.  One decode step's
# attribution must be the same PhaseSample on both devices.  (arch, heads)
E4M3_PARITY = {("gemma-2b", None), ("chatglm3-6b", 16), ("zamba2-1.2b", None)}
E4M3_ROUNDING_FLOOR = 100 * PARITY_TOL
KV_ROUNDING_ARCHS = ("musicgen-large", "phi-3-vision-4.2b",
                     "nemotron-4-340b")
KERNELS = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:65"),
    # the e4m3 route of the same kernel: the TPU kernel takes an e4m3
    # cache and casts it to fp32 (decode_attention.py:42-43)
    "decode_attention_e4m3": ("src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:65"),
    "tiered_matmul": ("src/repro_torch/csrc/tiered_matmul.cu",
                      "src/repro/kernels/tiered_matmul.py:50"),
    # a route of the same kernel: the reference computes the experts'
    # products with jnp.einsum over a dense buffer (models/moe.py:114-117)
    "tiered_matmul_experts": ("src/repro_torch/csrc/tiered_matmul.cu",
                              "src/repro/kernels/tiered_matmul.py:50"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:85"),
    # the TPU kernel has no backward: JAX differentiates its twin
    # (models/attention.py:43) by autodiff
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:28"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:60"),
    # the TPU kernel has no backward: JAX differentiates its twin
    # (models/mamba2.py:26 chunked_linear_scan) by autodiff
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan.py:23"),
    # no Pallas kernel: the reference runs the planner's knapsack DP as one
    # jitted lax.scan (core/knapsack.py:76 _jax_dp)
    "knapsack_dp": ("src/repro_torch/csrc/knapsack_dp.cu",
                    "src/repro/core/knapsack.py:76"),
}
# the sources the kernels are built from, by name (csrc/<name>.cu)
SOURCES = sorted({os.path.basename(src)[:-3]
                  for src, _ in KERNELS.values()})
TRAIN_SHAPE = (2, 1, 8, 2048, 2048, 256)       # B, K, G, S, T, D
# zamba2-1.2b's training step (batch 2 x 4096): the shared block's
# attention (32 heads over 32 KV heads of 64) and the SSD scan (64 heads,
# N = P = 64, chunks of 256, k and q broadcast over the heads)
ZAMBA_FLASH_SHAPE = (2, 32, 1, 4096, 4096, 64)
# yi-6b's and chatglm3-6b's training step (batch 2 x 2048): 32 heads over 4
# KV heads (G 8) and over 2 (G 16), D 128
YI_FLASH_SHAPE = (2, 4, 8, 2048, 2048, 128)
GLM_FLASH_SHAPE = (2, 2, 16, 2048, 2048, 128)
# dbrx-132b's attention at batch 2 x 2048: 48 heads over 8 KV heads (G 6),
# D 128
DBRX_FLASH_SHAPE = (2, 8, 6, 2048, 2048, 128)
# musicgen-large's training step (batch 2 x 2048): 32 heads over 32 KV
# heads of 64 (G 1); phi-3-vision-4.2b's: 32 heads of 96 (G 1), which run
# in the D 128 instantiation with a quarter of each tile's columns past D,
# at 2048 tokens and at 2048 + 144 patch positions (its frontend step: the
# last key tile ragged); nemotron-4-340b's attention at batch 1 x 2048: 96
# heads over 8 KV heads (G 12) of 192, the D 256 instantiation with its
# last 64-wide box wholly past D (on no path: nemotron has no train path)
MUSICGEN_FLASH_SHAPE = (2, 32, 1, 2048, 2048, 64)
PHI3V_FLASH_SHAPE = (2, 32, 1, 2048, 2048, 96)
PHI3V_FRONT_FLASH_SHAPE = (2, 32, 1, 2192, 2192, 96)
NEMOTRON_FLASH_SHAPE = (1, 8, 12, 2048, 2048, 192)
TIMED_FLASH_SHAPES = (TRAIN_SHAPE, ZAMBA_FLASH_SHAPE, YI_FLASH_SHAPE,
                      GLM_FLASH_SHAPE, DBRX_FLASH_SHAPE, MUSICGEN_FLASH_SHAPE,
                      PHI3V_FLASH_SHAPE, PHI3V_FRONT_FLASH_SHAPE,
                      NEMOTRON_FLASH_SHAPE)
# the dry run's prefill_32k cells: their attention (32,768 positions and
# more, 8 times the longest sequence a train path runs; the shapes from
# DRYRUN_STEP_CELLS, ``_prefill_flash_shapes``) held against its plain
# version on query tiles of LONG_FLASH_TILE rows (the first, one in the
# middle and the last, which reads every key: the plain version over all
# rows of gemma-2b's would build 34 GB of scores); and zamba2-1.2b's SSD
# forward over 32,768 positions (64 heads, N = P = 64, k and q broadcast
# over the heads)
LONG_FLASH_TILE = 128
SSD_PREFILL_SHAPE = (1, 64, 32768, 64, 64, 256)   # B, H, S, N, P, chunk
# the train paths of the 6-billion-parameter configs keep this many layers
# and train at this rate: Adam's first steps move every weight by about lr,
# so a layer's output by about fan-in x lr, and at d_model 4096 the losses
# of 5 steps from a random init rose at 3e-4 (gemma-2b's and zamba2-1.2b's
# rate, at d_model 2048) and at 1.5e-4, and fell at 1e-4, for both configs
# (H100, a sweep of this phase's runs)
SIX_B_TRAIN_LAYERS = 8
SIX_B_TRAIN_LR = 1e-4
SSD_TRAIN_SHAPE = (2, 64, 4096, 64, 64, 256)   # B, H, S, N, P, chunk
# xlstm-350m's train phase trains at this rate: over its 5 steps from a
# random init the losses stayed at ~11.0 at 1e-4 and 3e-4 (gemma-2b's),
# drifted to 10.93 at 1e-3 and fell to 10.17 at 2e-3 (H100, a sweep of
# this phase's runs; the same bits in every run)
XLSTM_TRAIN_LR = 2e-3
# ... and at 8 of its 24 layers (7 mLSTM, 1 sLSTM), for the run's time
# limit: the step is host-bound by the sLSTM's Python loop over 2048
# positions (6-10 s a step at 24 layers on a slow host, 276 s for the
# phase); at 8 layers the losses still fall at 2e-3 (11.02 to 10.01, H100)
XLSTM_TRAIN_LAYERS = 8
# xlstm-350m's mLSTM training step (batch 2 x 2048): 4 heads, N = d_in / H =
# 512, P = 513 (the head width and the normalizer's ones column), chunks of
# 256; k and q per head.  The SSD kernels' wide route
XLSTM_SSD_SHAPE = (2, 4, 2048, 512, 513, 256)
# the mLSTM's v as the model lays it out: rows padded to a multiple of 4
# floats (models/xlstm.py, _augment)
XLSTM_V_ROW = -(-(XLSTM_SSD_SHAPE[4]) // 4) * 4
TIMED_SSD_SHAPES = (SSD_TRAIN_SHAPE, XLSTM_SSD_SHAPE)
# dbrx-132b serves 8 of its 40 layers: its 263 GB of bf16 weights fit
# neither the card (80 GB) nor the host tier (108 GB); 8 layers and the
# embedding and head are ~55 GB
DBRX_SERVE_LAYERS = 8
# moonshot-v1-16b-a3b trains 4 of its 48 layers: the whole model's training
# state is 462 GB at 16 bytes a parameter, 4 layers' with the embedding and
# head 48 GB.  It trains at gemma-2b's rate, 3e-4 (the same d_model, 2048):
# its losses fell over the 5 steps from a random init (H100)
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_LR = 3e-4
# nemotron-4-340b serves 6 of its 96 layers: its 682 GB of bf16 weights fit
# no tier; a layer is 6.91 GB and the untied embedding and head 18.9 GB, so
# 6 layers come to 60.3 GB, which leaves room for the init's 8.2 GB fp32
# draw of the stacked wq and wo (6 x 18432 x 18432)
NEMOTRON_SERVE_LAYERS = 6
# The earlier serve paths run cut in depth so that the whole run stays
# well inside its time limit: each decode step is host-bound (idle
# 0.75-0.92, ~26-70 launches a layer at ~10-26 us of host time each), so a
# path's time grows with its layers, and every layer runs the same kernels
# at the same shapes.  zamba2 keeps 2 applications of its shared block.
# gemma-2b (the main path), dbrx-132b (already cut), musicgen-large and
# phi-3-vision-4.2b serve at their own depth
EARLIER_SERVE_LAYERS = {"zamba2-1.2b": 12, "yi-6b": 8, "chatglm3-6b": 8,
                        "xlstm-350m": 8, "moonshot-v1-16b-a3b": 12}
# musicgen-large and phi-3-vision-4.2b train at full depth: their states
# are 38.8 and 61.1 GB at 16 bytes a parameter (phi-3-vision's train phase
# peaked at 68.1 GB, H100).  They train at 1e-5: over 5 steps from a
# random init their losses spiked and did not fall at 3e-4 (gemma-2b's
# rate; musicgen 8.33 to 21.4), 1e-4, 5e-5 and 3e-5 (musicgen) and at
# 1e-4 and 5e-5 (phi-3-vision), and fell at 1e-5 (musicgen 8.33 to 7.50,
# phi-3-vision 10.95 to 9.43) (H100, a sweep of this phase's runs).  48
# and 32 layers of random weights, each moved by about lr by Adam's first
# steps, tolerate less than gemma-2b's 18
MUSICGEN_TRAIN_LR = 1e-5
PHI3V_TRAIN_LAYERS = None
PHI3V_TRAIN_LR = 1e-5
# The knapsack DP (the planner's, core/knapsack.py) at the planner's grid,
# max_cells 16,384: qcap 16,384 at a 256 MiB fast tier.  Its item counts
# span the device DP's range there, from the threshold (489 x 16,384 =
# 8.0M cells, knapsack._DEVICE_MIN_WORK) to the greedy cut (3,051 x
# 16,384 = 50.0M); the kernels line's row is n 2,000, the 2,000-chunk
# fixture's global solve.  Its bound counts the fp64 adds at the data
# sheet's fp64 rate (H100 SXM, no tensor core).
KNAPSACK_QCAP = 1 << 14
KNAPSACK_NS = (489, 1000, 2000, 3051)
KNAPSACK_LINE_N = 2000
# route 1's cluster sizes timed (the rule in kdp.pick_ranks follows them):
# (kind, n, qcap, sizes) at n 2,000 over the planner's grid, and on two
# small grids
KNAPSACK_SWEEPS = (("planner", KNAPSACK_LINE_N, KNAPSACK_QCAP,
                    (2, 4, 8, 12, 16)),
                   ("ties", 4000, 4095, (1, 4, 16)),
                   ("ties", 8000, 1000, (1, 4, 16)))
FP64_PEAK = 34e12
# The planner phase: the reference's chunk fixture (sim/planner_fixture.py)
# at these chunk counts and fast tier, each plan built with the numpy DP and
# with the device DP
PLANNER_CHUNKS = (2000, 3000)
PLANNER_CAPACITY = 256 * MB
PLANNER_BUILDS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------- timing
class Timer:
    """Median CUDA-event time of ``fn`` over ``n`` launches, each after an
    L2 flush (a 256 MiB write, outside the timed pair).  Each flush is
    queued behind a short device-side sleep, so the host has enqueued the
    launch before the card reaches the pair's start event and no host
    delay falls inside a timed pair."""

    SLEEP_CYCLES = 1_000_000                    # ~0.5 ms at 2 GHz

    def __init__(self):
        self.flush = torch.empty(64 * MB, dtype=torch.float32, device="cuda")

    def __call__(self, fn, n: int = 40, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        for s, e in zip(starts, ends):
            torch.cuda._sleep(self.SLEEP_CYCLES)
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e)
                                 for s, e in zip(starts, ends))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = dict(phase="device", kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), nvidia_smi=smi,
                capability=list(torch.cuda.get_device_capability(0)),
                torch=torch.__version__, cuda=torch.version.cuda,
                python=sys.version.split()[0])
    emit(info)
    require(info["capability"] == [9, 0], "an sm_90 card")
    return info


# Kernels, by name, and the tensor-core instruction each instantiation must
# run: wgmma (HGMMA), mma.sync in bf16 or TF32 (HMMA) or in fp64 (DMMA).
TENSOR_CORE_KERNELS = {
    "decode_attention": {"decode_e4m3_kernel": "HMMA"},
    "tiered_matmul": {"tiered_mma_kernel": "HMMA",
                      "tiered_experts_mma_kernel": "HMMA",
                      "tiered_wgmma_kernel": "HGMMA"},
    "flash_attention": {"flash_fwd_wgmma": "HGMMA"},
    "flash_attention_bwd": {"dq_wgmma": "HGMMA", "dkdv_wgmma": "HGMMA"},
    "ssd_scan": {"ssd_fwd_chunk_kernel": "HMMA",
                 "ssd_fwd_sums_kernel": "DMMA",
                 "ssd_fwd_scores_kernel": "HMMA",
                 "ssd_fwd_wide_kernel": "HMMA"},
    "ssd_scan_bwd": {"ssd_bwd_chunk_kernel": "HMMA",
                     "ssd_bwd_sums_kernel": "DMMA",
                     "ssd_bwd_scores_kernel": "DMMA",
                     "ssd_bwd_dq_kernel": "HMMA",
                     "ssd_bwd_dk_kernel": "HMMA",
                     "ssd_bwd_dv_kernel": "HMMA"}}


def _sass_counts(name: str) -> dict:
    """HGMMA, HMMA and DMMA instructions in each kernel of a built library
    named in TENSOR_CORE_KERNELS, from ``cuobjdump --dump-sass``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            fn = fn if any(k in fn for k in TENSOR_CORE_KERNELS[name]) else None
            if fn:
                counts[fn] = dict(HGMMA=0, HMMA=0, DMMA=0)
        elif fn:
            op = next((o for o in ("HGMMA", "HMMA", "DMMA") if o in line),
                      None)
            if op:
                counts[fn][op] += 1
    return counts


# kernels whose ptxas report is required in every run, with no spill
NO_SPILL = ("decode_attention", "tiered_matmul", "ssd_scan", "ssd_scan_bwd",
            "knapsack_dp")


def phase_build() -> None:
    t0 = time.perf_counter()
    # these compiled even when their libraries exist, so that their ptxas
    # reports are read in every run
    reports = build.build(SOURCES, fresh=list(NO_SPILL))
    for name in SOURCES:
        build.load(name)
    sass = {name: _sass_counts(name) for name in TENSOR_CORE_KERNELS}
    for name in NO_SPILL:
        require(any("Used" in line for line in reports[name]),
                f"a ptxas report for {name}")
    # spill lines of the ptxas report of each source built in this run
    spills = {name: [line for line in lines if "spill" in line
                     and "0 bytes spill stores, 0 bytes spill loads"
                     not in line] for name, lines in reports.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc=build.nvcc_path(), flags=build.NVCC_FLAGS,
              ptxas=reports, spills=spills, tensor_core_sass=sass))
    for name in NO_SPILL:
        require(not spills[name],
                f"no {name} instantiation spills ({spills[name]})")
    for name, kernels in TENSOR_CORE_KERNELS.items():
        for k, op in kernels.items():
            found = {f: c for f, c in sass[name].items() if k in f}
            require(found and all(c[op] > 0 for c in found.values()),
                    f"every instantiation of {k} runs {op} ({found})")


def _compare(out, plain, dtype, tol=TOL):
    """Max abs error, and the reference tests' allclose (rtol = atol)."""
    a, b = out.float(), plain.float()
    return ((a - b).abs().max().item() if a.numel() else 0.0,
            torch.allclose(a, b, rtol=tol[dtype], atol=tol[dtype]))


def _decode_case(timer, dtype, B, K, G, D, T, length, cache_view, gen,
                 peak=1.0, against="plain", stale_nan=False, kv=None,
                 nan=None, f64_rel=None):
    """The kernel against its plain version (``against="plain"``) or the
    same attention in float64 (``"float64"``), on q scaled by ``peak``
    (8: peaked scores, so the running max moves between tiles); with
    ``stale_nan``, every SM's shared memory is filled with NaN just before
    the kernel, so a read of shared memory it did not write shows; timed
    beside the plain version and SDPA unless ``timer`` is None.  ``kv``:
    the cache's dtype (q's unless given); an e4m3 cache (``E4M3``, drawn
    N(0, 1) and cast by ``kv_cast``) makes the row kernel
    ``decode_attention_e4m3``, its library column None (no PyTorch call
    reads e4m3) and ``library_bf16_sdpa_ms`` SDPA over the same cache in
    bf16, for scale.  ``nan`` (an e4m3 cache): the NaN encoding written
    into one cache element of batch 0 inside the valid rows
    (``"inside"``: batch 0's outputs NaN in both, compared NaN for NaN) or
    past them (``"past"``: never read).  ``f64_rel``: the output is also
    held against the same attention in float64, within ``f64_rel`` times
    its largest magnitude (``float64_max_abs_err``, ``float64_limit``;
    ``plain_ok`` keeps the verdict against the plain version alone)."""
    kv = kv or dtype

    def draw(shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return kv_cast(x, kv)
    if cache_view:      # one layer of the serving cache, (B, T, K, D)
        kc, vc = draw((B, T, K, D)), draw((B, T, K, D))
        k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    else:
        k, v = draw((B, K, T, D)), draw((B, K, T, D))
    if nan is not None:                   # e4m3's NaN, S.1111.111
        row = length // 2 if nan == "inside" else length + (T - length) // 2
        k.view(torch.uint8)[0, 0, row, 0] = 0x7F
    q = (torch.randn((B, K, G, D), generator=gen, device="cuda")
         * peak).to(dtype)
    if stale_nan:
        fill_shared_memory_nan(q.device)
    out = ops.decode_attention(q, k, v, length)
    if against == "float64":
        want = decode_attention_f64(q, k, v, length)
    else:
        want = decode_attention_plain(q, k, v, length)
    torch.cuda.synchronize()
    e4m3 = kv == E4M3
    if nan is None:
        err, ok = _compare(out, want, dtype)
    else:               # NaN where the plain version has NaN, else close
        same_nan = torch.equal(out.isnan(), want.isnan())
        fin = ~want.isnan()
        err, ok = _compare(out[fin], want[fin], dtype)
        ok = ok and same_nan and bool(want.isnan().any()) == (nan == "inside")
    row = dict(
        phase="check",
        kernel="decode_attention_e4m3" if e4m3 else "decode_attention",
        dtype=str(dtype)[6:],
        shape=dict(B=B, K=K, G=G, D=D, T=T, length=length,
                   cache_view=cache_view, peak=peak, stale_nan=stale_nan,
                   kv=str(kv)[6:], nan=nan),
        against=against, max_abs_err=err, tol=TOL[dtype], ok=ok)
    if f64_rel is not None:
        del want
        err64, top = _f64_distance(out, q, k, v, length)
        row.update(float64_max_abs_err=err64, float64_limit=f64_rel * top,
                   plain_ok=ok, ok=ok and err64 <= f64_rel * top)
        torch.cuda.empty_cache()
    if timer is None:
        return row
    size = torch.tensor([], dtype=dtype).element_size()
    kv_size = k.element_size()
    nbytes = 2 * B * K * G * D * size + 2 * B * K * length * D * kv_size
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes, 4.0 * B * K * G * length * D, kv if e4m3 else dtype)
    row["library_ms"] = None
    kl, vl = k[:, :, :length], v[:, :, :length]
    if e4m3 and length:
        q16 = q.to(torch.bfloat16)
        k16, v16 = kl.to(torch.bfloat16), vl.to(torch.bfloat16)
        row["library"] = ("none: no PyTorch call reads an e4m3 cache; "
                          "library_bf16_sdpa_ms is SDPA over the same cache "
                          "in bf16, for scale")
        row["library_bf16_sdpa_ms"] = timer(
            lambda: F.scaled_dot_product_attention(q16, k16, v16))
        row["library_bf16_bound_ms"] = bound_ms(
            2 * B * K * G * D * 2 + 2 * B * K * length * D * 2,
            4.0 * B * K * G * length * D, torch.bfloat16)[0]
        del q16, k16, v16
    elif length:
        row["library_ms"] = timer(
            lambda: F.scaled_dot_product_attention(q, kl, vl))
    row["ms"] = timer(lambda: ops.decode_attention(q, k, v, length))
    row["plain_ms"] = timer(lambda: decode_attention_plain(q, k, v, length))
    return row


def _f64_distance(out, q, k, v, length, elems=1 << 28):
    """max |out - attention in float64| and max |attention in float64|,
    the float64 version taken over slices of (b, KV heads) that read at
    most ``elems`` cache elements each, so a full cache of the main path's
    longest reads fits beside it."""
    B, K, D = q.shape[0], q.shape[1], q.shape[3]
    step = max(1, elems // max(1, length * D))
    err = top = 0.0
    for b in range(B):
        for h in range(0, K, step):
            sl = (slice(b, b + 1), slice(h, h + step))
            want = decode_attention_f64(q[sl], k[sl], v[sl], length)
            err = max(err, (out[sl].double() - want).abs().max().item())
            top = max(top, want.abs().max().item())
            del want
    return err, top


# Decode shapes whose lanes own 16-byte chunks past D, which the kernel
# never copies into its ring: fp32 at D <= 128 (a lane's second chunk) and
# at D = 160 or 192, bf16 where D / 8 is no power of 2 (D 96, 160, 192);
# zamba2's shape in fp32, phi-3-vision-4.2b's (G 1, D 96) and
# nemotron-4-340b's (G 12: a block of 8 heads and one of 4 with 4 masked;
# D 192) among them.  (dtype, B, K, G, D, length)
STALE_SHARED_CASES = [
    (torch.float32, 4, 32, 1, 64, 160), (torch.float32, 2, 2, 16, 128, 161),
    (torch.float32, 2, 1, 4, 16, 37), (torch.float32, 2, 2, 4, 160, 161),
    (torch.bfloat16, 2, 2, 4, 96, 161), (torch.bfloat16, 2, 2, 4, 160, 33),
    (torch.bfloat16, 4, 1, 8, 96, 1024), (torch.bfloat16, 4, 32, 1, 96, 160),
    (torch.bfloat16, 4, 8, 12, 192, 161), (torch.float32, 2, 2, 12, 192, 33)]


def _stale_shared_cases(gen) -> list:
    """The decode kernel behind a NaN fill of every SM's shared memory, at
    the shapes of STALE_SHARED_CASES, against its plain version."""
    return [_decode_case(None, dt, B, K, G, D, 1024, length, True, gen,
                         stale_nan=True)
            for dt, B, K, G, D, length in STALE_SHARED_CASES]


# The e4m3 route's checks, (q dtype, B, K, G, D, T, length, timed):
# gemma-2b's serving shape (cache view (4, 1024, 1, 256)) and lengths 0, 1,
# 1024; zamba2-1.2b's G 1, D 64 (K 32), chatglm3-6b's G 16, D 128, dbrx-
# 132b's G 6 and nemotron-4-340b's G 12, D 192, at lengths 1, 160, 1024;
# both full decode_32k shapes the dry run serves in e4m3, gemma-2b's (B
# 128, K 1, G 8, D 256) and chatglm3-6b's (B 128, K 2, G 16, D 128) over
# all 32,768 rows (LONG_DECODE_CASES)
E4M3_CASES = [
    *((dt, 4, 1, 8, 256, 1024, n, n == 160)
      for dt in (torch.float32, torch.bfloat16) for n in (0, 1, 160, 1024)),
    *((dt, 4, K, G, D, 1024, n, False)
      for dt in (torch.float32, torch.bfloat16)
      for K, G, D in ((32, 1, 64), (2, 16, 128), (8, 6, 128), (8, 12, 192))
      for n in (1, 160, 1024))]
# The main path's longest reads, at the dry run's shapes: gemma-2b's (B
# 128, K 1, G 8, D 256) and chatglm3-6b's (B 128, K 2, G 16, D 128)
# decode_32k over all 32,768 rows of an e4m3 cache, and zamba2-1.2b's
# long_500k (B 1, K 32, G 1, D 64) over all 524,288 rows of a bf16 cache.
# Over T rows of N(0, 1) keys and values an output is about sqrt(e / T)
# (0.009 at 32,768 rows, 0.0023 at 524,288), under TOL[bf16], so a kernel
# that lost a split's partial would pass at TOL[bf16] alone: fp32 q is held
# to TOL[fp32] (an e4m3 or bf16 value dequantizes exactly, so the plain
# version differs only in summation order), and bf16 q also against float64
# within 2^-7 of the largest output (LONG_F64_REL; rounding the output to
# bf16 moves it at most 2^-8 of that).  (q dtype, kv dtype, B, K, G, D,
# length, timed)
LONG_DECODE_CASES = [
    *((dt, E4M3, 128, K, G, D, 32768, dt == torch.bfloat16)
      for K, G, D in ((1, 8, 256), (2, 16, 128))
      for dt in (torch.float32, torch.bfloat16)),
    (torch.float32, torch.bfloat16, 1, 32, 1, 64, 524288, False),
    (torch.bfloat16, torch.bfloat16, 1, 32, 1, 64, 524288, True)]
LONG_F64_REL = 2.0 ** -7
# e4m3 shapes behind a NaN fill of shared memory: lanes with 16-byte chunks
# past D (D 96: 6 chunks in 8 lanes; 160: 10 in 16; 192: 12 in 16) and one
# chunk a row (D 16).  (q dtype, B, K, G, D, length)
E4M3_STALE_CASES = [
    (torch.bfloat16, 2, 2, 4, 96, 161), (torch.float32, 2, 2, 4, 160, 33),
    (torch.bfloat16, 4, 8, 12, 192, 161), (torch.float32, 4, 32, 1, 64, 160),
    (torch.bfloat16, 2, 1, 8, 16, 37), (torch.float32, 2, 2, 16, 128, 161)]


def _e4m3_launcher_refuses(D: int) -> dict:
    """The C entry point itself refuses an e4m3 row of D * 1 bytes that is
    no multiple of 16 (cudaErrorInvalidValue, 1), with nothing launched:
    its element size comes from the dtype code."""
    q = torch.zeros((1, 1, 4, D), device="cuda")
    k = torch.zeros((1, 1, 64, D), dtype=E4M3, device="cuda")
    before = da.e4m3_launches
    heads = da._heads_per_block(4, 1)
    err = da._bind()(q.data_ptr(), k.data_ptr(), k.data_ptr(), q.data_ptr(),
                     1, 1, 4, D, 64, 1, 64, heads, 0, 1.0,
                     *q.stride()[:3], *k.stride()[:3], *k.stride()[:3],
                     *q.stride()[:3], 0, 2,
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return dict(phase="check", kernel="decode_attention_e4m3",
                dtype="float32",
                shape=dict(launcher_refuses_D=D, kv="float8_e4m3fn"),
                cuda_error=err, max_abs_err=0.0, tol=0.0,
                ok=err == 1 and da.e4m3_launches == before)


# Every finite e4m3 code in K and V (subnormals and +-448 among them), at
# gemma-2b's G 8, D 256 and chatglm3-6b's G 16, D 128, fp32 and bf16 q.
# Row 0 of each (b, k) holds codes, row 1 zeros; length 2.  Each head's q
# is one-hot at d = its head, sized so that the right decode of the K code
# there gives the score ln 2 against row 1's 0 (weights 2/3 and 1/3): each
# of the 252 nonzero codes sets one head's weights, and row 0 of V cycles
# through all 254 codes, each output 2/3 of one.  fp32 q (TOL[fp32])
# sees a subnormal decoded wrong; at bf16's tolerance a K code off by a
# factor still moves every output.  (G, D)
E4M3_EVERY_CODE_SHAPES = [(8, 256), (16, 128)]


def _e4m3_every_code_case(dtype, G: int, D: int) -> dict:
    codes = [c for c in range(256) if c & 0x7F != 0x7F]
    nonzero = [c for c in codes if c & 0x7F]
    B, T = -(-len(nonzero) // G), 64
    kb = torch.zeros((B, T, 1, D), dtype=torch.uint8)
    vb = torch.zeros((B, T, 1, D), dtype=torch.uint8)
    for b in range(B):
        row = [codes[(b * D + d) % len(codes)] for d in range(D)]
        vb[b, 0, 0] = torch.tensor(row, dtype=torch.uint8)
        kb[b, 0, 0] = torch.tensor(row[::-1], dtype=torch.uint8)
        kb[b, 0, 0, :G] = torch.tensor(
            [nonzero[(b * G + h) % len(nonzero)] for h in range(G)],
            dtype=torch.uint8)
    kb[:, 2:] = vb[:, 2:] = 0x38           # 1.0 past the valid rows
    kv = kb.view(E4M3).float()
    q = torch.zeros((B, 1, G, D))
    for h in range(G):
        q[:, 0, h, h] = math.log(2.0) * math.sqrt(D) / kv[:, 0, 0, h]
    k = kb.cuda().view(E4M3).permute(0, 2, 1, 3)
    v = vb.cuda().view(E4M3).permute(0, 2, 1, 3)
    q = q.cuda().to(dtype)
    out = ops.decode_attention(q, k, v, 2)
    want = decode_attention_plain(q, k, v, 2)
    torch.cuda.synchronize()
    err, ok = _compare(out, want, dtype)
    return dict(phase="check", kernel="decode_attention_e4m3",
                dtype=str(dtype)[6:],
                shape=dict(B=B, K=1, G=G, D=D, T=T, length=2,
                           cache_view=True, every_code=True,
                           kv="float8_e4m3fn"),
                max_abs_err=err, tol=TOL[dtype], ok=ok)


def _e4m3_cases(timer, gen) -> list:
    rows = [_decode_case(timer if timed else None, dt, B, K, G, D, T, n,
                         True, gen, kv=E4M3)
            for dt, B, K, G, D, T, n, timed in E4M3_CASES]
    torch.cuda.empty_cache()
    rows += [_decode_case(None, torch.bfloat16, 4, 1, 8, 256, 1024, 160,
                          True, gen, kv=E4M3, nan=where)
             for where in ("inside", "past")]
    rows += [_decode_case(None, dt, B, K, G, D, 1024, n, True, gen,
                          stale_nan=True, kv=E4M3)
             for dt, B, K, G, D, n in E4M3_STALE_CASES]
    rows += [_e4m3_every_code_case(dt, G, D)
             for dt in (torch.float32, torch.bfloat16)
             for G, D in E4M3_EVERY_CODE_SHAPES]
    rows += [_e4m3_launcher_refuses(D) for D in (8, 24)]
    return rows


def _long_decode_cases(timer, gen) -> list:
    """The decode kernel at LONG_DECODE_CASES, each case's caches freed
    before the next."""
    rows = []
    for dt, kv, B, K, G, D, n, timed in LONG_DECODE_CASES:
        rows.append(_decode_case(
            timer if timed else None, dt, B, K, G, D, n, n, True, gen,
            kv=kv, f64_rel=LONG_F64_REL if dt == torch.bfloat16 else None))
        torch.cuda.empty_cache()
    return rows


def phase_e4m3_cast() -> dict:
    """What the card's own ``.to(float8_e4m3fn)`` gives at the edges of the
    range, and ``kv_cast`` (the port's one conversion) giving the same
    bits on the card as on the CPU, for 10^5 N(0, 3^2) values and the
    edges."""
    edges = torch.tensor([448.0, 449.0, 463.9, 464.0, 464.5, 480.0, 1e4,
                          float("inf"), -float("inf"), float("nan"),
                          2.0 ** -10, 3 * 2.0 ** -11, -0.0])
    raw = edges.cuda().to(E4M3).view(torch.uint8).cpu().tolist()
    x = torch.cat([torch.randn(100_000, generator=torch.Generator()
                               .manual_seed(7)) * 3.0, edges])
    bits = {}
    for src in (torch.float32, torch.bfloat16):
        cpu = kv_cast(x.to(src), E4M3).view(torch.uint8)
        card = kv_cast(x.to(src).cuda(), E4M3).view(torch.uint8).cpu()
        bits[str(src)[6:]] = int((cpu != card).sum())
    res = dict(phase="e4m3_cast", values=[str(v) for v in edges.tolist()],
               card_raw_cast_bits=raw,
               card_raw_cast_values=[str(v) for v in torch.tensor(
                   raw, dtype=torch.uint8).view(E4M3).float().tolist()],
               kv_cast_card_vs_cpu_bits_apart=bits)
    emit(res)
    require(not any(bits.values()), "kv_cast gives the same bits on the card "
            "and the CPU")
    return res


def _host_us(fn, n: int = 1000) -> float:
    """Host time of one call of ``fn``: the host clock over ``n`` calls
    queued with no synchronisation in between (what a host-bound decode
    loop pays a call), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def _launch_route(x, w, route, y) -> None:
    """One launch of ``tiered_matmul``'s C entry point on route ``route``
    with the wrapper's plan for it, into the first M rows of ``y`` (rows of
    N elements, at least M of them): a check's aid, which counts no
    launch."""
    M, K = x.shape
    N = w.shape[1]
    n_split, k_chunk = mm.plan(
        M, N, K, route,
        torch.cuda.get_device_properties(0).multi_processor_count)
    if route == "ffma":
        vec = N % 8 == 0 and w.data_ptr() % 16 == 0
    else:
        vec = K % 8 == 0 and x.data_ptr() % 16 == 0
    err = mm._bind()(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K,
                     mm._ROUTES[route], n_split, k_chunk, int(vec),
                     mm._DTYPES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"tiered_matmul's {route} route launches ({err})")


def _matmul_case(timer, dtype, M, K, N, gen, name=None, stale_nan=False,
                 want_route=None):
    """The kernel against its plain version, with the route and plan the
    wrapper chose (``want_route``: the route it must choose); the same
    inputs again must give the same bits (the K split is merged in a fixed
    order); with ``stale_nan`` every SM's shared memory is filled with NaN
    just before the kernel, so a ring slot read before its copy lands
    shows.  On a tensor-core route, one more launch writes into a buffer
    of 128 more rows than y, filled with 7: the first M rows must be y's
    bits and the rows past M still 7 (a store past M writes them).  A weight of
    2^31 bytes or more (nemotron-4-340b's w_up and w_down): also the last row
    of w alone, selected by an x that is 1 in its last column and 0 elsewhere,
    must come out exactly (one product a sum), and the last column of y must
    meet the float64 product.  Timed beside the plain version and
    ``torch.matmul``, with the wrapper's host time a call, unless ``timer`` is
    None."""
    x = (torch.randn((M, K), generator=gen, device="cuda") * 0.1).to(dtype)
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.1).to(dtype)
    if stale_nan:
        fill_shared_memory_nan(x.device)
    out = ops.tiered_matmul(x, w)
    again = ops.tiered_matmul(x, w)
    plain = mm.tiered_matmul_plain(x, w)
    torch.cuda.synchronize()
    err, ok = _compare(out, plain, dtype)
    same = torch.equal(out, again)
    route = mm.route(x, w)
    n_split, k_chunk = mm.plan(
        M, N, K, route, torch.cuda.get_device_properties(0).multi_processor_count)
    row = dict(
        phase="check", kernel="tiered_matmul", dtype=str(dtype)[6:],
        shape=dict(M=M, K=K, N=N, product=name, stale_nan=stale_nan),
        route=route, plan=dict(n_split=n_split, k_chunk=k_chunk),
        max_abs_err=err, bit_identical_rerun=same, tol=TOL[dtype],
        ok=ok and same and route == (want_route or route))
    if want_route:
        row["want_route"] = want_route
    del plain, again
    if route != "ffma":
        guard = torch.full((M + 128, N), 7.0, dtype=dtype, device="cuda")
        _launch_route(x, w, route, guard)
        row["rows_past_m_untouched"] = bool(
            (guard[M:] == 7).all().item() and torch.equal(guard[:M], out))
        row["ok"] = row["ok"] and row["rows_past_m_untouched"]
        del guard
    if K * N * x.element_size() >= 1 << 31:
        sel = torch.zeros_like(x)
        sel[:, -1] = 1
        last_row = ops.tiered_matmul(sel, w)
        col = (x.double() @ w[:, -1].double()).to(dtype)
        col_err, col_ok = _compare(out[:, -1], col, dtype)
        row["far_end"] = dict(
            w_bytes=K * N * x.element_size(),
            last_row_exact=torch.equal(last_row, w[-1:].expand(M, N)),
            last_column_max_abs_err=col_err, last_column_ok=col_ok)
        row["ok"] = (row["ok"] and row["far_end"]["last_row_exact"]
                     and col_ok)
        del sel, last_row
    if timer is None:
        return row
    size = x.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(
        (M * K + K * N + M * N) * size, 2.0 * M * N * K, dtype)
    row["ms"] = timer(lambda: ops.tiered_matmul(x, w))
    row["plain_ms"] = timer(lambda: mm.tiered_matmul_plain(x, w))
    row["library_ms"] = timer(lambda: torch.matmul(x, w))
    # 100 calls above 256 MB of weight: each call streams it all, and 1000
    # of nemotron's 2.7 GB products would take ~1 s of the card each
    row["host_us"] = _host_us(lambda: ops.tiered_matmul(x, w),
                              1000 if K * N * size <= 1 << 28 else 100)
    return row


# tiered_matmul shapes checked untimed: the card tests' smallest and most
# ragged ones; M = 1, 4, 8 and 9 (one block of 8 rows of x, and from 9 on
# the "wgmma" route) at gemma-2b's w_down and zamba2-1.2b's in_proj; K not
# a multiple of the ring's 64-row stage, one of them under one stage, one
# whose K splits (2560 rows) outgrow the "mma" kernel's 2048-k window of x;
# N a multiple of 8 but not of 64.  (M, K, N)
MATMUL_EDGE_CASES = [
    (1, 3, 5), (5, 100, 13),
    *((M, 16384, 2048) for M in (1, 4, 8, 9)),
    *((M, 2048, 8384) for M in (1, 4, 8, 9)),
    (4, 2000, 2048), (3, 100, 264), (3, 40, 264), (4, 20000, 2048)]
# tiered_matmul shapes run behind a NaN fill of shared memory (bf16, the
# "mma" route): zamba2's in_proj, whose last tile loads one box of its 4,
# and a ragged K and N; on the "wgmma" route, the same in_proj at M 128,
# and ragged M, K and N together.  (M, K, N)
MATMUL_STALE_CASES = [(4, 2048, 8384), (3, 100, 264)]
WGMMA_STALE_CASES = [(128, 2048, 8384), (129, 2000, 264)]


def _wgmma_edge_cases() -> list:
    """(M, K, N, route) of the two tensor-core routes' untimed checks
    round the "wgmma" route, bf16: its threshold and one row below it (the
    "mma" route), and ragged M (65, 129, 200: a second 128-row tile, zeros
    past M), at gemma-2b's w_gate and chatglm3-6b's w_down; at M = 128, K =
    2000 (its last stage past K) and N = 264 (its last tile loads one box,
    8 columns of it inside N); two blocks of 8 rows on the "mma" route (K
    no multiple of 8: x's rows are no TMA rows)."""
    t = mm.WGMMA_MIN_M
    return [(M, K, N, "wgmma" if M >= t else "mma")
            for M in (t - 1, t, 65, 129, 200)
            for K, N in ((2048, 16384), (13696, 4096))] + [
        (128, 2000, 2048, "wgmma"), (128, 2048, 264, "wgmma"),
        (12, 2004, 264, "mma")]


def _matmul_edge_cases(gen) -> list:
    rows = [_matmul_case(None, dt, M, K, N, gen)
            for dt in (torch.float32, torch.bfloat16)
            for M, K, N in MATMUL_EDGE_CASES]
    rows += [_matmul_case(None, torch.bfloat16, M, K, N, gen,
                          stale_nan=True)
             for M, K, N in MATMUL_STALE_CASES]
    # the "wgmma" route's cases draw from a generator of their own, so that
    # every check after them draws what it drew before the route existed
    own = torch.Generator(device="cuda").manual_seed(32)
    rows += [_matmul_case(None, torch.bfloat16, M, K, N, own, want_route=r)
             for M, K, N, r in _wgmma_edge_cases()]
    return rows + [_matmul_case(None, torch.bfloat16, M, K, N, own,
                                stale_nan=True, want_route="wgmma")
                   for M, K, N in WGMMA_STALE_CASES]


# where the "wgmma" route starts to win: both tensor-core routes timed at
# these M on gemma-2b's w_gate and chatglm3-6b's w_down.  (label, K, N)
THRESHOLD_MS = (4, 8, 9, 12, 16, 32, 64, 128)
THRESHOLD_PRODUCTS = [("gemma-2b:w_gate", 2048, 16384),
                      ("chatglm3-6b:w_down", 13696, 4096)]


def _matmul_threshold_rows(timer) -> list:
    """Both tensor-core routes of tiered_matmul (the C entry point, each
    with the wrapper's plan for it) at each M of THRESHOLD_MS on
    THRESHOLD_PRODUCTS, bf16: each against the plain version, timed, with
    the host us a call of the same launch (what encoding x's tensor map at
    every call costs the "wgmma" route), and the route the wrapper takes
    there.  Its inputs come from a generator of its own (the checks after
    it draw what they drew before it existed)."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    rows = []
    for label, K, N in THRESHOLD_PRODUCTS:
        w = (torch.randn((K, N), generator=gen, device="cuda")
             * 0.1).bfloat16()
        for M in THRESHOLD_MS:
            x = (torch.randn((M, K), generator=gen, device="cuda")
                 * 0.1).bfloat16()
            plain = mm.tiered_matmul_plain(x, w)
            row = dict(phase="check", kernel="tiered_matmul",
                       dtype="bfloat16",
                       shape=dict(M=M, K=K, N=N,
                                  product="threshold:" + label),
                       wrapper_route=mm.route(x, w), by_route={})
            errs = []
            for r in ("mma", "wgmma"):
                y = torch.empty((M, N), dtype=x.dtype, device="cuda")
                _launch_route(x, w, r, y)
                err, ok = _compare(y, plain, torch.bfloat16)
                errs.append(err)
                row["by_route"][r] = dict(
                    max_abs_err=err, ok=ok,
                    ms=timer(lambda: _launch_route(x, w, r, y)),
                    host_us=_host_us(lambda: _launch_route(x, w, r, y),
                                     200))
            row["max_abs_err"] = max(errs)
            row["ok"] = all(v["ok"] for v in row["by_route"].values())
            rows.append(row)
            del x, plain, y
        del w
        torch.cuda.empty_cache()
    return rows


def _decode_experts(B: int, k: int, E: int, gen) -> torch.Tensor:
    """Expert indices of a decode step's B k rows, int32 on the card: each
    token's k distinct experts drawn at random (row b k + j: token b's
    j-th), as the router's top-k gives them."""
    scores = torch.rand((B, E), generator=gen, device="cuda")
    return scores.topk(k, dim=-1).indices.reshape(-1).to(torch.int32)


def _experts_case(timer, dtype, R, E, K, N, gen, expert, name=None,
                  tokens=None):
    """The expert route against its plain version, on rows whose experts
    are ``expert`` (R,); the same inputs again must give the same bits.
    Timed beside the plain version and, at a decode shape (``tokens`` =
    B), ``torch.bmm`` over all E experts on the reference's dense (E, B C,
    K) buffer (C = 8, each token in its slot 0 of each routed expert):
    the one call that computes the reference's expert product.  The bound
    counts the routed experts' weights, each read once."""
    x = (torch.randn((R, K), generator=gen, device="cuda") * 0.1).to(dtype)
    w = (torch.randn((E, K, N), generator=gen, device="cuda")
         * 0.1).to(dtype)
    out = ops.tiered_matmul_experts(x, w, expert)
    again = ops.tiered_matmul_experts(x, w, expert)
    plain = mm.tiered_matmul_experts_plain(x, w, expert)
    torch.cuda.synchronize()
    err, ok = _compare(out, plain, dtype)
    same = torch.equal(out, again)
    per = torch.bincount(expert.long(), minlength=E)
    routed = int((per > 0).sum().item())
    route = mm.route(x, w[0], experts=True)
    n_split, k_chunk = mm.plan(
        mm._expert_rows(R, E, route), N, K, route,
        torch.cuda.get_device_properties(0).multi_processor_count)
    row = dict(
        phase="check", kernel="tiered_matmul_experts", dtype=str(dtype)[6:],
        shape=dict(R=R, E=E, K=K, N=N, product=name, routed=routed,
                   most_rows_an_expert=int(per.max().item()),
                   tokens=tokens),
        route=route, plan=dict(n_split=n_split, k_chunk=k_chunk),
        max_abs_err=err, bit_identical_rerun=same, tol=TOL[dtype],
        ok=ok and same)
    del plain, again
    if timer is None:
        return row
    size = x.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(
        (R * K + routed * K * N + R * N) * size, 2.0 * R * N * K, dtype)
    row["ms"] = timer(lambda: ops.tiered_matmul_experts(x, w, expert))
    row["plain_ms"] = timer(
        lambda: mm.tiered_matmul_experts_plain(x, w, expert))
    row["library_ms"] = None
    if tokens:
        C = 8
        buf = torch.zeros((E, tokens * C, K), dtype=dtype, device="cuda")
        k = R // tokens
        buf[expert.long(), torch.arange(R, device="cuda") // k * C] = x
        row["library_ms"] = timer(lambda: torch.bmm(buf, w))
        row["library"] = ("torch.bmm over all E experts on the reference's "
                          "dense (E, B C, K) buffer, C = 8")
    row["host_us"] = _host_us(lambda: ops.tiered_matmul_experts(x, w, expert),
                              200)
    return row


def _moe_layer_products(cfg) -> list:
    """An MoE layer's decode products through ``tiered_matmul``, (name, K,
    N): its attention's 4 and, with shared experts, their 3."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out = [("wq", d, cfg.n_heads * hd), ("wk", d, cfg.n_kv_heads * hd),
           ("wv", d, cfg.n_kv_heads * hd), ("wo", cfg.n_heads * hd, d)]
    fs = cfg.moe_d_ff * cfg.moe_shared_experts
    if fs:
        out += [("shared_gate", d, fs), ("shared_up", d, fs),
                ("shared_down", fs, d)]
    return out


def _moe_products(cfg) -> list:
    """An MoE layer's routed decode products, (name, K, N): w_gate, w_up
    (d x f) and w_down (f x d) of each expert."""
    d, f = cfg.d_model, cfg.moe_d_ff
    return [("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]


def _experts_cases(timer, gen) -> list:
    """The expert route at moonshot-v1-16b-a3b's and dbrx-132b's decode
    shapes (batch 4: 24 rows over 64 experts of 2048 x 1408 and 1408 x
    2048; 16 rows over 16 of 6144 x 10752 and 10752 x 6144), bf16 timed
    and fp32 untimed; then untimed edge cases: every row on one expert
    (more than 8 rows: 8-row tiles, 4-row tiles in the FFMA kernel), R no
    multiple of 8 with experts no row picks, K and N multiples of no tile,
    N no multiple of 8 (bf16 on the FFMA kernel), R above 32 (the kernel
    ranks rows a warp-wide chunk of 32 at a time)."""
    rows = []
    for arch in ("moonshot-v1-16b-a3b", "dbrx-132b"):
        acfg = get_config(arch)
        B, E, k = 4, acfg.moe_experts, acfg.moe_top_k
        for dtype in (torch.bfloat16, torch.float32):
            for name, K, N in _moe_products(acfg):
                rows.append(_experts_case(
                    timer if dtype == torch.bfloat16 else None, dtype, B * k,
                    E, K, N, gen, _decode_experts(B, k, E, gen),
                    f"{arch}:{name}", B))
                torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        for R, E, K, N, expert in (
                (20, 16, 2048, 1408, [5] * 20),
                (9, 4, 1408, 2048, [3] * 9),
                (13, 8, 2048, 1408, [i % 7 for i in range(13)]),
                (13, 8, 100, 264, [6 - i % 5 for i in range(13)]),
                (5, 3, 1000, 13, [2, 0, 2, 2, 0]),
                (40, 64, 2048, 1408, [i * 7 % 64 for i in range(40)]),
                # 20 rows an expert, spread over two warp-wide chunks of 32
                (40, 2, 256, 264, [i % 2 for i in range(40)])):
            ex = torch.tensor(expert, dtype=torch.int32, device="cuda")
            rows.append(_experts_case(None, dtype, R, E, K, N, gen, ex))
    return rows


def _visible_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through: the work this input
    needs, not the padded maximum."""
    if not causal:
        return S * T
    return sum(min(s + 1, T) for s in range(S))


def _flash_case(timer, dtype, B, K, G, S, T, D, causal, gen, peak=1.0):
    """Forward kernel against the plain forward (output and log-sum-exp);
    backward kernel against autograd through the plain forward; q scaled by
    ``peak`` (8: peaked scores, so the running max moves between key tiles
    and a missing rescale shows).  Float64 columns and times at
    TIMED_FLASH_SHAPES only, and only given a ``timer``."""
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda").to(dtype)
    q, k, v = (mk(B, K, G, S, D) * peak).to(dtype), mk(B, K, T, D), mk(
        B, K, T, D)
    dout = mk(B, K, G, S, D)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain, plain_lse = fa.flash_attention_plain(*leaves, causal)
    grads = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal)
    want = torch.autograd.grad(plain, leaves, dout)
    torch.cuda.synchronize()
    err, ok = _compare(out, plain.detach(), dtype)
    lse_err, lse_ok = _compare(lse, plain_lse.detach(), torch.float32)
    g_err = [_compare(g, w, dtype, BWD_TOL) for g, w in zip(grads, want)]
    shape = dict(B=B, K=K, G=G, S=S, T=T, D=D, causal=causal, peak=peak)
    fwd = dict(phase="check", kernel="flash_attention", dtype=str(dtype)[6:],
               shape=shape, max_abs_err=err, lse_max_abs_err=lse_err,
               tol=TOL[dtype], ok=ok and lse_ok)
    bwd = dict(phase="check", kernel="flash_attention_bwd",
               dtype=str(dtype)[6:], shape=shape,
               max_abs_err=max(e for e, _ in g_err),
               dq_dk_dv_max_abs_err=[e for e, _ in g_err],
               tol=BWD_TOL[dtype], ok=all(o for _, o in g_err))
    del leaves, plain, plain_lse, want
    if timer is not None and (B, K, G, S, T, D) in TIMED_FLASH_SHAPES:
        size = q.element_size()
        pairs = B * K * G * _visible_pairs(S, T, causal)
        io = (2 * q.numel() + 2 * k.numel()) * size + lse.numel() * 4
        flops = 4.0 * D * pairs
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(io, flops, dtype)
        # backward: reads q, k, v, out, dout, lse; writes dq, dk, dv
        bwd["bound_ms"], bwd["bound_by"] = bound_ms(
            (3 * q.numel() + 4 * k.numel()) * size + lse.numel() * 4,
            2.5 * flops, dtype)
        fwd["ms"] = timer(lambda: fa.flash_attention_fwd(q, k, v, causal), 20)
        fwd["plain_ms"] = timer(
            lambda: fa.flash_attention_plain(q, k, v, causal), 10)
        bwd["ms"] = timer(lambda: fa.flash_attention_bwd(
            q, k, v, out, dout, lse, causal), 20)
        bwd["plain_ms"] = timer(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, dout, lse, causal), 10)
        # yardstick only: SDPA over the G heads with K/V repeated per head
        q4 = q.view(B, K * G, S, D).detach().requires_grad_()
        k4, v4 = (t.repeat_interleave(G, dim=1).requires_grad_()
                  for t in (k, v))
        do4 = dout.view(B, K * G, S, D)
        fwd["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), 20)
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        bwd["library_ms"] = timer(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True), 20)
        f64 = _f64_errors(q, k, v, dout, out, grads, causal)
        fwd.update(f64["fwd"])
        bwd.update(f64["bwd"])
    return [fwd, bwd]


def _f64_errors(q, k, v, dout, out, grads, causal) -> dict:
    """Distance of the kernel's and the plain version's output and
    gradients (dq, dk, dv) from a float64 reference on the same inputs, one
    (b, k) slab at a time: the measure of BWD_TOL's reason in fp32, and of
    what rounding P and dS to bf16 costs in bf16."""
    S, T, D = q.shape[3], k.shape[2], q.shape[-1]
    mask = (torch.arange(T, device="cuda")[None, :]
            > torch.arange(S, device="cuda")[:, None])
    err = {w: [0.0] * 4 for w in ("kernel", "plain")}
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            sl = (slice(b, b + 1), slice(h, h + 1))
            leaves = [t[sl].detach().double().requires_grad_()
                      for t in (q, k, v)]
            s = torch.einsum("bkgsd,bktd->bkgst", leaves[0] / D ** 0.5,
                             leaves[1])
            if causal:
                s = s.masked_fill(mask, -1e30)
            o = torch.einsum("bkgst,bktd->bkgsd", torch.softmax(s, -1),
                             leaves[2])
            gold = [o.detach()] + list(torch.autograd.grad(
                o, leaves, dout[sl].double()))
            del s, o
            plain_leaves = [t[sl].detach().clone().requires_grad_()
                            for t in (q, k, v)]
            plain, _ = fa.flash_attention_plain(*plain_leaves, causal)
            plain_g = [plain.detach()] + list(torch.autograd.grad(
                plain, plain_leaves, dout[sl]))
            mine = [out[sl]] + [g[sl] for g in grads]
            for who, got in (("kernel", mine), ("plain", plain_g)):
                for i, (x, w) in enumerate(zip(got, gold)):
                    err[who][i] = max(err[who][i],
                                      (x.double() - w).abs().max().item())
    return dict(fwd=dict(kernel_vs_f64=err["kernel"][0],
                         plain_vs_f64=err["plain"][0]),
                bwd=dict(kernel_vs_f64=err["kernel"][1:],
                         plain_vs_f64=err["plain"][1:]))


def _ssd_work(B, H, S, N, P, chunk) -> tuple:
    """Useful flops of the forward and of the backward for these shapes:
    the causal pairs of each chunk (a ragged last chunk counted as it is),
    the inter-chunk products and the state update (the same count on
    either route: the wide route's scores are formed once a chunk)."""
    pairs = sum(q * (q + 1) // 2
                for q in (min(chunk, S - s0) for s0 in range(0, S, chunk)))
    fwd = B * H * (pairs * 2 * (N + P) + S * 4 * N * P)
    bwd = B * H * (pairs * 2 * (2 * P + 3 * N) + S * 8 * N * P)
    return float(fwd), float(bwd)


def _kernels_a_call(fn, calls: int = 4) -> tuple:
    """Kernels that a call of ``fn`` launches, each of another name: the
    distinct kernel names torch.profiler records over ``calls`` calls (it
    may drop an event, so counting events would undercount); and each
    kernel's device ms a call, by name (back to back, no L2 flush)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_GUARD_S)      # see _device_profile
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names, ms = set(), {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or "emcpy" in e.name or "emset" in e.name):
            continue
        names.add(e.name)
        short = next((w for w in e.name.replace("(", " ").replace(
            ":", " ").split() if w.endswith("_kernel")), e.name[:48])
        ms[short] = ms.get(short, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / calls
    return len(names), ms


def _ssd_case(timer, B, H, S, N, P, chunk, bcast, decay, gen,
              stale_nan=False, v_row=None) -> list:
    """Forward kernel against the plain forward (y, final state, chunk
    states) and backward kernel against autograd through the plain
    forward, with an initial state and a final-state gradient; in the
    model's layout, (B, S, H, .) seen as (B, H, S, .), k and q broadcast
    over H where ``bcast``; decays ``decay`` ("strong" or "near1", see
    SSD_DECAY_RANGE); v's rows ``v_row`` floats apart (P where None).
    Each kernel must give the same bits from a second call; with
    ``stale_nan`` every SM's shared memory is filled with NaN just before
    each kernel's first call, so a read of a ring slot or tile that no copy
    wrote shows.  The forward's states and final state are
    also set beside the float64 model of its order (``_entry_states``), as
    are the fp32 plain version's.  Float64 columns of the backward at the
    training shapes (TIMED_SSD_SHAPES); timed there with decays near 1
    only.  At xlstm-350m's shape every gradient is held against the plain
    version run in float64, under both decays: there the fp32 plain
    version sums 512- and 513-deep products and itself lies up to 3e-4
    from float64 (dq, dv; 1.8e-3 in d(log a) through autograd), so it is
    no yardstick to 1e-4 (H100)."""
    r = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                   device="cuda")
    if decay == "near1":
        lo, hi = SSD_DECAY_RANGE
        a = torch.exp(-(lo + (hi - lo) * torch.rand(
            (B, S, H), generator=gen, device="cuda")))
    else:
        a = torch.sigmoid(r(B, S, H))
    if bcast:
        k, q = (r(B, S, N)[:, :, None].expand(B, S, H, N) * 0.3
                for _ in range(2))
    else:
        k, q = r(B, S, H, N) * 0.3, r(B, S, H, N) * 0.3
    v = (r(B, S, H, v_row or P) * 0.3)[..., :P]
    a, k, v, q = (t.transpose(1, 2) for t in (a, k, v, q))
    s0, dy, dfin = r(B, H, N, P) * 0.3, r(B, H, S, P), r(B, H, N, P)
    if stale_nan:
        fill_shared_memory_nan(a.device)
    y, fin, states = ssd.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    again = ssd.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    fwd_same = all(torch.equal(x, x2) for x, x2 in zip((y, fin, states),
                                                       again))
    del again
    if stale_nan:
        fill_shared_memory_nan(a.device)
    grads = ssd.ssd_scan_bwd(a, k, v, q, dy, states, fin, dfin, chunk, True)
    again = ssd.ssd_scan_bwd(a, k, v, q, dy, states, fin, dfin, chunk, True)
    same = all(torch.equal(x, x2) for x, x2 in zip(grads, again))
    del again
    leaves = [t.detach().clone().requires_grad_() for t in (a, k, v, q, s0)]
    py, pfin, pstates = ssd._plain_forward(*leaves[:4], chunk, leaves[4])
    want = torch.autograd.grad([py, pfin], leaves, [dy, dfin])
    torch.cuda.synchronize()
    errs = [_compare(x, w.detach(), torch.float32, {torch.float32: SSD_TOL})
            for x, w in ((y, py), (fin, pfin), (states, pstates))]
    st64, fin64 = ssd._entry_states(ssd._log_decay(a.double()), k, v, chunk,
                                    s0)
    f64 = [[(x.double() - w).abs().max().item()
            for x, w in ((st, st64), (fi, fin64))]
           for st, fi in ((states, fin), (pstates.detach(), pfin.detach()))]
    # d(log a) = da * a for the decays; dk, dq per head
    g_cmp = [(g * a if i == 0 else g, w * a if i == 0 else w)
             for i, (g, w) in enumerate(zip(grads, want))]
    xlstm = (B, H, S, N, P, chunk) == XLSTM_SSD_SHAPE
    if xlstm:                       # every gradient against float64
        gold = _ssd_grads(torch.float64, a, k, v, q, s0, dy, dfin, chunk)
        g_cmp = [(g.double(), w) for (g, _), w in zip(g_cmp, gold)]
        del gold
    elif decay == "near1":          # d(log a) against float64
        g_cmp[0] = (g_cmp[0][0].double(),
                    _ssd_grads(torch.float64, a, k, v, q, s0, dy, dfin,
                               chunk)[0])
    g_err = [_compare(g, w, torch.float32, {torch.float32: SSD_TOL})
             for g, w in g_cmp]
    shape = dict(B=B, H=H, S=S, N=N, P=P, chunk=chunk, bcast=bcast,
                 decay=decay, stale_nan=stale_nan, v_row=v_row or P)
    fwd = dict(phase="check", kernel="ssd_scan", dtype="float32", shape=shape,
               max_abs_err=max(e for e, _ in errs),
               y_final_states_max_abs_err=[e for e, _ in errs],
               states_final_vs_f64=dict(kernel=f64[0], plain=f64[1]),
               bit_identical_rerun=fwd_same, tol=SSD_TOL,
               ok=all(o for _, o in errs) and fwd_same)
    bwd = dict(phase="check", kernel="ssd_scan_bwd", dtype="float32",
               shape=shape, max_abs_err=max(e for e, _ in g_err),
               dloga_dk_dv_dq_dinit_max_abs_err=[e for e, _ in g_err],
               dloga_against=("float64" if decay == "near1" or xlstm
                              else "float32"),
               grads_against="float64" if xlstm else "float32",
               bit_identical_rerun=same, tol=SSD_TOL,
               ok=all(o for _, o in g_err) and same)
    del leaves, py, pfin, pstates, want
    if (B, H, S, N, P, chunk) not in TIMED_SSD_SHAPES:
        return [fwd, bwd]
    bwd.update(_ssd_f64_errors(a, k, v, q, s0, dy, dfin, chunk, grads))
    # the kernel's d(log a) no further from float64 than the reference's
    # arithmetic, the fp32 plain version (zamba2's shape); within SSD_TOL
    # of float64 (xlstm's, where the check above already compared it)
    bwd["dloga_kernel_le_plain"] = (bwd["kernel_vs_f64"][0]
                                    <= bwd["plain_vs_f64"][0])
    if not xlstm:
        bwd["ok"] = bwd["ok"] and bwd["dloga_kernel_le_plain"]
    if decay == "near1":
        nc = -(-S // chunk)
        kq = 2 * (k[:, 0].numel() if bcast else k.numel()) * 4
        io = (a.numel() + v.numel()) * 4 + kq
        f_flops, b_flops = _ssd_work(B, H, S, N, P, chunk)
        # forward: reads a, k, q, v; writes y, the final and chunk states
        f_bytes = io + (v.numel() + B * H * (nc + 1) * N * P) * 4
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(f_bytes, f_flops,
                                                    torch.float32)
        fwd["bound_tc_ms"] = 3 * f_flops / TF32_PEAK * 1e3
        fwd["bytes_bound_ms"] = f_bytes / HBM_BW * 1e3
        # backward: reads a, k, q, v, dy and the states; writes da, dv and
        # the per-head dk, dq
        b_bytes = io + (2 * v.numel() + B * H * (nc + 1) * N * P + a.numel()
                        + 2 * B * H * S * N) * 4
        bwd["bound_ms"], bwd["bound_by"] = bound_ms(b_bytes, b_flops,
                                                    torch.float32)
        # ... and the same flops on the tensor cores at fp32 accuracy: three
        # TF32 products each
        bwd["bound_tc_ms"] = 3 * b_flops / TF32_PEAK * 1e3
        bwd["bytes_bound_ms"] = b_bytes / HBM_BW * 1e3
        _, fin0, st0 = ssd.ssd_scan_fwd(a, k, v, q, chunk, save_states=True)
        fwd["ms"] = timer(lambda: ssd.ssd_scan_fwd(a, k, v, q, chunk,
                                                   save_states=True), 20)
        fwd["plain_ms"] = timer(lambda: ssd._plain_forward(a, k, v, q, chunk),
                                10)
        bwd["ms"] = timer(lambda: ssd.ssd_scan_bwd(
            a, k, v, q, dy, st0, fin0, None, chunk, False), 20)
        bwd["plain_ms"] = timer(lambda: ssd.ssd_scan_bwd_plain(
            a, k, v, q, dy, st0, fin0, None, chunk, False), 10)
        fwd["kernels_a_call"], fwd["kernel_ms_a_call"] = _kernels_a_call(
            lambda: ssd.ssd_scan_fwd(a, k, v, q, chunk, save_states=True))
        bwd["kernels_a_call"], bwd["kernel_ms_a_call"] = _kernels_a_call(
            lambda: ssd.ssd_scan_bwd(a, k, v, q, dy, st0, fin0, None, chunk,
                                     False))
        # no single PyTorch call computes the scan or its gradient
        fwd["library_ms"] = bwd["library_ms"] = None
    return [fwd, bwd]


# SSD shapes of the kernels' wide route (N or P above 64), untimed: the
# one-head reduced xlstm's state (N 128, P 129) over 600 positions, the
# last chunk ragged; N above 64 with P below it, k and q broadcast over H;
# P above 64 with N below it (the backward's wide route only), P no
# multiple of 4.  (B, H, S, N, P, chunk, bcast)
SSD_WIDE_CASES = [(2, 1, 600, 128, 129, 256, False),
                  (1, 2, 130, 96, 40, 64, True),
                  (1, 2, 200, 40, 101, 64, False)]


def _ssd_stale_cases() -> list:
    """SSD shapes checked behind a NaN fill of shared memory: (B, H, S, N,
    P, chunk, bcast), the reduced configs' and the wide route's among
    them."""
    zr = get_config("zamba2-1.2b").reduced()
    xr = get_config("xlstm-350m").reduced()
    d_in = xr.ssm_expand * xr.d_model
    return [(2, 3, 300, 32, 64, 128, False), (1, 4, 1000, 64, 64, 256, True),
            (1, 2, 130, 6, 12, 64, True),
            (2, zr.ssm_expand * zr.d_model // zr.ssm_head_dim, 64,
             zr.ssm_state, zr.ssm_head_dim, 64, True),
            (2, xr.n_heads, 64, d_in // xr.n_heads, d_in // xr.n_heads + 1,
             64, False)] + SSD_WIDE_CASES


def _ssd_grads(dtype, a, k, v, q, s0, dy, dfin, chunk) -> list:
    """Gradients (d(log a), dk, dv, dq, d s0) of the plain forward run in
    ``dtype`` on the same inputs, dk and dq per head."""
    leaves = [t.detach().to(dtype).clone().requires_grad_()
              for t in (a, k, v, q, s0)]
    y, fin, _ = ssd._plain_forward(*leaves[:4], chunk, leaves[4])
    g = torch.autograd.grad([y, fin], leaves, [dy.to(dtype), dfin.to(dtype)])
    return [x * leaves[0].detach() if i == 0 else x for i, x in enumerate(g)]


def _ssd_f64_errors(a, k, v, q, s0, dy, dfin, chunk, grads) -> dict:
    """Distance of the kernel's and the fp32 plain version's gradients
    (d(log a), dk, dv, dq, d s0) from the plain version's in float64, and
    whether each one's d(log a) meets allclose(SSD_TOL) there."""
    gold = _ssd_grads(torch.float64, a, k, v, q, s0, dy, dfin, chunk)
    plain = _ssd_grads(torch.float32, a, k, v, q, s0, dy, dfin, chunk)
    mine = [g * a if i == 0 else g for i, g in enumerate(grads)]
    tol = {torch.float32: SSD_TOL}
    return dict(
        kernel_vs_f64=[(x.double() - w).abs().max().item()
                       for x, w in zip(mine, gold)],
        plain_vs_f64=[(x.double() - w).abs().max().item()
                      for x, w in zip(plain, gold)],
        dloga_allclose_f64=dict(
            kernel=_compare(mine[0].double(), gold[0], torch.float32, tol)[1],
            plain=_compare(plain[0].double(), gold[0], torch.float32,
                           tol)[1]))


def _layer_products(cfg) -> list:
    """One attention layer's products of a dense config, (name, K, N): 7
    with a gated MLP, 6 with the plain one (no w_gate)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    gate = [] if cfg.mlp_type == "mlp" else [("w_gate", d, f)]
    return [("wq", d, cfg.n_heads * hd), ("wk", d, cfg.n_kv_heads * hd),
            ("wv", d, cfg.n_kv_heads * hd), ("wo", cfg.n_heads * hd, d),
            *gate, ("w_up", d, f), ("w_down", f, d)]


def _path_products():
    """The serving paths' products, (name, K, N): one gemma-2b layer's 7,
    and zamba2-1.2b's Mamba-2 in_proj (N = 8384, a multiple of no tile)
    and out_proj and three of its shared block's."""
    gemma = _layer_products(get_config("gemma-2b"))
    zcfg = get_config("zamba2-1.2b")
    zd, d_in = zcfg.d_model, zcfg.ssm_expand * zcfg.d_model
    zproj = 2 * d_in + 2 * zcfg.ssm_state + d_in // zcfg.ssm_head_dim
    zamba = [("in_proj", zd, zproj), ("out_proj", d_in, zd),
             ("wq", zd, zd), ("w_gate", zd, zcfg.d_ff),
             ("w_down", zcfg.d_ff, zd)]
    return gemma, zamba


def _xlstm_products(cfg) -> list:
    """xlstm-350m's decode products, (name, K, N): an mLSTM layer's 3
    (in_proj, o_gate, out_proj), then an sLSTM layer's 2 (w_gates,
    out_proj)."""
    d, d_in = cfg.d_model, cfg.ssm_expand * cfg.d_model
    return [("in_proj", d, 3 * d_in + 2 * cfg.n_heads), ("o_gate", d, d_in),
            ("out_proj", d_in, d), ("w_gates", d, 4 * d),
            ("slstm_out_proj", d, d)]


def _m128_products() -> list:
    """(label, K, N) of the decode products that the dry run's
    decode_32k cells run at M = 128: gemma-2b's and chatglm3-6b's 7 a
    layer, xlstm-350m's 5."""
    return [(f"m128:{arch}:{name}", K, N)
            for arch, products in (
                ("gemma-2b", _layer_products(get_config("gemma-2b"))),
                ("chatglm3-6b", _layer_products(get_config("chatglm3-6b"))),
                ("xlstm-350m", _xlstm_products(get_config("xlstm-350m"))))
            for name, K, N in products]


def _m1_products() -> list:
    """(label, K, N) of the decode products that the dry run's long_500k
    cells run at M = 1: zamba2-1.2b's Mamba-2 in_proj and out_proj and its
    shared block's 7, xlstm-350m's 5."""
    zcfg = get_config("zamba2-1.2b")
    _, zamba = _path_products()
    return [(f"m1:{arch}:{name}", K, N)
            for arch, products in (
                ("zamba2-1.2b", zamba[:2] + _layer_products(zcfg)),
                ("xlstm-350m", _xlstm_products(get_config("xlstm-350m"))))
            for name, K, N in products]


def _knapsack_reference_draw(n_items: int = 800):
    """The reference's device-DP test draw (its tests/test_planner_scale.py:
    random.Random(7), values U(-0.5, 2), sizes 1-4 MiB, a 256 MiB fast
    tier) grown from 600 to 800 items, filtered and quantized as
    ``solve_arrays`` does: (values, qsizes, qcap)."""
    rng = random.Random(7)
    draws = [(rng.uniform(-0.5, 2.0), rng.randint(1, 4) * MB)
             for _ in range(n_items)]
    values = np.array([v for v, _ in draws], dtype=np.float64)
    sizes = np.array([s for _, s in draws], dtype=np.int64)
    keep = (values > 0.0) & (sizes <= 256 * MB)
    qsizes, qcap = knapsack._quantize(sizes[keep], 256 * MB, 1 << 14)
    return values[keep], qsizes, qcap


def _knapsack_inputs(kind: str, n: int, qcap: int, seed: int,
                     width: int = None):
    """(values float64, qsizes int64) numpy draws: "planner" values U(0, 1)
    over sizes of 16-256 quanta (0.25-4 MiB at qcap 16,384); "ties"
    integer values from {1, 2, 3} over sizes from {1, 2, 3}, so that the
    strict comparison decides most rows; "edges" small sizes with items
    past the capacity (qcap + 1, qcap + 2, 10^6, 2^31 + 7, 2^32 + 3: a
    size narrowed to int without the guard is applied or read out of
    range) and of size 0; "wide" sizes uniform over 1,000 to qcap, so that
    route 1's reads of c - s cross one and two ranks; "widths" sizes at a
    rank's width W and around it (W - 1, W, W + 1, 2 W, 2 W + 5, 0, 1 in
    turn; W route 1's by default, or ``width``)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return (rng.integers(1, 4, n).astype(np.float64),
                rng.integers(1, 4, n).astype(np.int64))
    values = rng.uniform(1e-3, 1.0, n)
    if kind == "planner":
        return values, rng.integers(16, 257, n).astype(np.int64)
    if kind == "wide":
        return values, rng.integers(1000, qcap + 1, n).astype(np.int64)
    if kind == "widths":
        w = width or kdp.cluster_plan(qcap).width
        cycle = (w - 1, w, w + 1, 2 * w, 2 * w + 5, 0, 1)
        return values, np.array([cycle[i % 7] for i in range(n)],
                                dtype=np.int64)
    sizes = rng.integers(0, max(qcap // 4, 1), n).astype(np.int64)
    for i, s in enumerate((qcap + 1, 0, qcap + 2, 10 ** 6, 0, 2 ** 31 + 7,
                           2 ** 32 + 3)):
        sizes[(i * 37 + 3) % n] = s
    return values, sizes


def _knapsack_case(timer, case: str, values, qsizes, qcap: int,
                   route=None, stale_nan=False, line=False, ranks=None,
                   both_routes=False, sweep=False) -> dict:
    """The kernel's keep table against its plain version on the card and
    the numpy DP (``core/knapsack.py`` ``_numpy_dp``) on the host, byte for
    byte, a second call's bytes against the first, one launch a call, and
    on route 1 the cluster's layout as the built kernel computes it
    against ``kdp.cluster_plan`` (``ranks``: the cluster's size, by default
    the grid's); also against the other route where ``route`` is 2 on a
    grid route 1 takes, or ``both_routes``.  Timed (``timer``): kernel,
    plain, the numpy DP on the host, the keep table's copy to the host, ns
    an item, the bound and, on route 1, the chain floor (the same cluster's
    item loop with no table work); ``sweep`` rows time the kernel alone."""
    dev = torch.device("cuda")
    v, s = torch.from_numpy(values).to(dev), torch.from_numpy(qsizes).to(dev)
    r = route or kdp.pick_route(qcap)
    plan = kdp.cluster_plan(qcap, ranks) if r == 1 else None
    R = plan.ranks if plan else None
    if stale_nan:
        fill_shared_memory_nan(dev)
    before = kdp.launches
    out = kdp.knapsack_dp(v, s, qcap, route=r, ranks=R)
    again = kdp.knapsack_dp(v, s, qcap, route=r, ranks=R)
    launched = kdp.launches - before
    plain = kdp.knapsack_dp_plain(v, s, qcap)
    torch.cuda.synchronize()
    host = knapsack._numpy_dp(values, qsizes, qcap)
    n = len(values)
    err = (out.int() - plain.int()).abs().max().item() if n else 0
    same_plain = torch.equal(out, plain)
    same_numpy = np.array_equal(out.cpu().numpy(), host)
    same = torch.equal(out, again)
    row = dict(kernel="knapsack_dp", dtype="float64",
               shape=dict(case=case, n=n, qcap=qcap, route=r,
                          cells=n * qcap, stale_nan=stale_nan, ranks=R,
                          width=plan.width if plan else None,
                          threads=plan.threads if plan else None),
               max_abs_err=err, same_as_plain=same_plain,
               same_as_numpy_dp=same_numpy, bit_identical_rerun=same,
               launches_a_call=launched / 2,
               ok=same_plain and same_numpy and same and launched == 2)
    if plan:
        row["layout_as_planned"] = kdp.kernel_layout(qcap, R) == plan
        row["ok"] = row["ok"] and row["layout_as_planned"]
    if both_routes or (r == 2 and qcap + 1 <= kdp.ROUTE1_CELLS):
        other = kdp.knapsack_dp(v, s, qcap, route=3 - r)
        row["same_as_route_" + str(3 - r)] = torch.equal(out, other)
        row["ok"] = row["ok"] and torch.equal(out, other)
    if timer is None:
        return row
    row["ms"] = timer(lambda: kdp.knapsack_dp(v, s, qcap, route=r, ranks=R))
    row.update(ns_per_item=row["ms"] * 1e6 / n, sweep=sweep, line=line)
    if plan:
        row["chain_floor_ms"] = timer(lambda: kdp.chain_floor(n, qcap, R))
        row["chain_floor_cluster_barrier_ms"] = timer(
            lambda: kdp.chain_floor(n, qcap, R, cluster_barrier=True))
    if sweep:
        return row
    row["plain_ms"] = timer(lambda: kdp.knapsack_dp_plain(v, s, qcap), n=3,
                            warmup=1)
    host_s, copy_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        knapsack._numpy_dp(values, qsizes, qcap)
        host_s.append(time.perf_counter() - t0)
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.cpu()
        copy_s.append(time.perf_counter() - t0)
    fits = qsizes[(qsizes >= 0) & (qsizes <= qcap)]
    adds = float(np.sum(qcap + 1 - fits))
    nbytes = values.nbytes + qsizes.nbytes + out.numel()
    t_bytes, t_ops = nbytes / HBM_BW, adds / FP64_PEAK
    row.update(numpy_dp_ms=statistics.median(host_s) * 1e3,
               copy_to_host_ms=statistics.median(copy_s) * 1e3,
               keep_bytes=out.numel(),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               fp64_adds=adds, library_ms=None)
    return row


def _knapsack_cases(timer) -> list:
    """The knapsack DP kernel's checks: the reference test's draw grown to
    800 items (above the device threshold, asserted), the planner's range
    of item counts at qcap 16,384 (timed, with the chain floor), route 1
    at qcap 100,000 against route 2 (timed) and route 2 past route 1's
    cells at qcap 250,000 (timed); grids of qcap + 1 no multiple of 8, n
    1, sizes past the capacity and of 0, a tie-heavy case, route 2 forced
    where route 1 runs (the same bits); sizes that cross one and two
    ranks ("wide", and "widths" at a rank's width W, 2 W and around them)
    at 16, 8 and 2 ranks, grids whose last rank is full (qcap 16,383) or
    short (16,415), grids on one rank and on clusters smaller than the
    grid's, route 1 behind a NaN fill of shared memory at 16 ranks and at
    1, and the cluster's size swept (KNAPSACK_SWEEPS; timed: the kernel and
    the chain floor)."""
    rows = []
    values, qsizes, qcap = _knapsack_reference_draw()
    require(len(values) * qcap >= knapsack._DEVICE_MIN_WORK,
            f"the reference draw's {len(values)} x {qcap} cells reach the "
            "device DP's threshold")
    rows.append(_knapsack_case(timer, "reference_draw_800", values, qsizes,
                               qcap))
    rows.append(_knapsack_case(None, "reference_draw_800", values, qsizes,
                               qcap, route=2))
    rows.append(_knapsack_case(None, "reference_draw_800", values, qsizes,
                               qcap, stale_nan=True))
    for i, n in enumerate(KNAPSACK_NS):
        rows.append(_knapsack_case(
            timer, "planner", *_knapsack_inputs("planner", n, KNAPSACK_QCAP,
                                                10 + i),
            KNAPSACK_QCAP, line=n == KNAPSACK_LINE_N))
    for case, n, qcap, sizes in KNAPSACK_SWEEPS:   # the cluster's size
        inputs = _knapsack_inputs(case, n, qcap,
                                  10 + KNAPSACK_NS.index(KNAPSACK_LINE_N))
        for R in sizes:
            rows.append(_knapsack_case(timer, case, *inputs, qcap, ranks=R,
                                       sweep=True))
    rows.append(_knapsack_case(                            # both routes
        timer, "planner", *_knapsack_inputs("planner", 400, 100_000, 20),
        100_000, both_routes=True))
    rows.append(_knapsack_case(                            # route 2
        timer, "planner", *_knapsack_inputs("planner", 400, 250_000, 28),
        250_000))
    for case, n, qcap, seed, route, stale in (
            ("planner", 700, 16_380, 21, None, False),      # 16,381 cells
            ("edges", 300, 1000, 22, None, False),          # 1,001 cells
            ("edges", 300, 1000, 22, 2, False),
            ("edges", 300, 1000, 22, None, True),
            ("edges", 40, 0, 23, None, False),              # one cell
            ("planner", 1, KNAPSACK_QCAP, 24, None, False),
            ("edges", 1, 7, 25, None, False),
            ("ties", 2000, 1500, 26, None, False),
            ("ties", 2000, 1500, 26, 2, False),
            ("ties", 2000, 1500, 26, None, True),
            ("ties", 3000, KNAPSACK_QCAP, 27, None, False),
            ("planner", 2000, KNAPSACK_QCAP, 12, None, True),
            ("planner", 500, 16_383, 32, None, False),      # 16 full ranks
            ("planner", 500, 16_415, 33, None, False),      # the last short
            ("edges", 300, 16_415, 34, None, False),
            ("wide", 300, 100_000, 35, None, False)):
        rows.append(_knapsack_case(
            None, case, *_knapsack_inputs(case, n, qcap, seed), qcap,
            route=route, stale_nan=stale))
    for R in (16, 8, 2):                      # reads across ranks
        for case, seed in (("wide", 30), ("widths", 31)):
            w = kdp.cluster_plan(KNAPSACK_QCAP, R).width
            rows.append(_knapsack_case(
                None, case, *_knapsack_inputs(case, 500, KNAPSACK_QCAP, seed,
                                              width=w),
                KNAPSACK_QCAP, ranks=R))
    for case, n, qcap, seed, R, stale in (    # smaller clusters
            ("ties", 2000, 1500, 26, 1, False),
            ("ties", 2000, 1500, 26, 1, True),
            ("edges", 300, 1000, 22, 1, False),
            ("edges", 40, 0, 23, 16, False),                # 15 empty ranks
            ("edges", 300, 1000, 22, 16, False),
            ("widths", 500, 4095, 36, 3, False),
            ("planner", 2000, 4095, 37, None, False)):
        rows.append(_knapsack_case(
            None, case, *_knapsack_inputs(
                case, n, qcap, seed, width=kdp.cluster_plan(qcap, R).width),
            qcap, ranks=R, stale_nan=stale))
    return rows


def _prefill_flash_shapes() -> list:
    """(cell, (B, K, G, S, D)): the flash forward's shape at each prefill
    cell of DRYRUN_STEP_CELLS, at the batch it runs (S: the shape's
    positions and the config's frontend positions)."""
    out = []
    for arch, shape, cuts in DRYRUN_STEP_CELLS:
        if shape != "prefill_32k":
            continue
        acfg = get_config(arch)
        K = acfg.n_kv_heads
        out.append((f"{arch}:{shape}", (
            cuts["batch"], K, acfg.n_heads // K,
            dryrun.SHAPES[shape].seq_len + acfg.frontend_tokens,
            acfg.resolved_head_dim)))
    return out


def _flash_long_case(timer, gen, cell, B, K, G, S, D) -> dict:
    """The flash forward of prefill cell ``cell`` at (B, K, G, S, D) in
    bf16, q x 8 (peaked scores: the running max moves across the key
    tiles), against its plain version on three query tiles
    (``flash_attention_plain_rows``): the first, one in the middle and the
    last, ragged where S is no multiple of LONG_FLASH_TILE; timed with its
    bound, SDPA beside it and the plain version's ms over the three
    tiles."""
    tile = LONG_FLASH_TILE
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
    q = (mk(B, K, G, S, D) * 8.0).to(torch.bfloat16)
    k, v = mk(B, K, S, D), mk(B, K, S, D)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    tiles = [(r0, min(r0 + tile, S))
             for r0 in (0, (S // 2 // tile) * tile, (S - 1) // tile * tile)]
    errs, lse_errs, oks = [], [], []
    for r0, r1 in tiles:
        p_out, p_lse = fa.flash_attention_plain_rows(q, k, v, r0, r1)
        e, ok = _compare(out[..., r0:r1, :], p_out, torch.bfloat16)
        le, lok = _compare(lse[..., r0:r1], p_lse, torch.float32)
        errs.append(e)
        lse_errs.append(le)
        oks.append(ok and lok)
        del p_out, p_lse
    torch.cuda.synchronize()
    shape = dict(B=B, K=K, G=G, S=S, T=S, D=D, causal=True, peak=8.0,
                 tiles=[list(t) for t in tiles])
    row = dict(phase="check", kernel="flash_attention", dtype="bfloat16",
               shape=shape, prefill_cell=cell, max_abs_err=max(errs),
               tile_max_abs_err=errs,
               lse_max_abs_err=max(lse_errs), tol=TOL[torch.bfloat16],
               against="the plain version on the sampled query tiles",
               ok=all(oks))
    pairs = B * K * G * _visible_pairs(S, S, True)
    io = (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4
    row["bound_ms"], row["bound_by"] = bound_ms(io, 4.0 * D * pairs,
                                                torch.bfloat16)
    row["ms"] = timer(lambda: fa.flash_attention_fwd(q, k, v, True), 5, 1)
    row["plain_ms_sampled_tiles"] = timer(lambda: [
        fa.flash_attention_plain_rows(q, k, v, r0, r1)
        for r0, r1 in tiles], 3, 1)
    q4 = q.view(B, K * G, S, D)
    k4, v4 = (t.repeat_interleave(G, dim=1) for t in (k, v))
    row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 5, 1)
    del q, k, v, out, lse, q4, k4, v4
    return row


def _ssd_prefill_case(timer, gen) -> dict:
    """The SSD forward at SSD_PREFILL_SHAPE (zamba2-1.2b's prefill_32k at
    batch 1, decays near 1, k and q broadcast over the heads, no initial
    state) against its plain version at SSD_TOL: y, the final state and
    the chunk states; also without the chunk states, as the model's
    forward without gradients calls it.  Timed with its bound."""
    B, H, S, N, P, chunk = SSD_PREFILL_SHAPE
    lo, hi = SSD_DECAY_RANGE
    a = torch.exp(-(lo + (hi - lo) * torch.rand((B, S, H), generator=gen,
                                                device="cuda")))
    k, q = (torch.randn((B, S, N), generator=gen, device="cuda")[
        :, :, None].expand(B, S, H, N) * 0.3 for _ in range(2))
    v = torch.randn((B, S, H, P), generator=gen, device="cuda") * 0.3
    a, k, v, q = (t.transpose(1, 2) for t in (a, k, v, q))
    y, fin, states = ssd.ssd_scan_fwd(a, k, v, q, chunk, save_states=True)
    y2, fin2 = ssd.ssd_scan_fwd(a, k, v, q, chunk)[:2]
    py, pfin, pstates = ssd._plain_forward(a, k, v, q, chunk)
    torch.cuda.synchronize()
    errs = [_compare(x, w, torch.float32, {torch.float32: SSD_TOL})
            for x, w in ((y, py), (fin, pfin), (states, pstates),
                         (y2, py), (fin2, pfin))]
    shape = dict(B=B, H=H, S=S, N=N, P=P, chunk=chunk, bcast=True,
                 decay="near1", stale_nan=False, v_row=P)
    row = dict(phase="check", kernel="ssd_scan", dtype="float32",
               shape=shape, prefill_cell="zamba2-1.2b:prefill_32k",
               max_abs_err=max(e for e, _ in errs),
               y_final_states_max_abs_err=[e for e, _ in errs[:3]],
               no_states_max_abs_err=[e for e, _ in errs[3:]],
               tol=SSD_TOL, ok=all(o for _, o in errs))
    nc = -(-S // chunk)
    f_flops, _ = _ssd_work(B, H, S, N, P, chunk)
    f_bytes = ((a.numel() + 2 * v.numel() + B * H * (nc + 1) * N * P) * 4
               + 2 * k[:, 0].numel() * 4)
    row["bound_ms"], row["bound_by"] = bound_ms(f_bytes, f_flops,
                                                torch.float32)
    row["bound_tc_ms"] = 3 * f_flops / TF32_PEAK * 1e3
    row["ms"] = timer(lambda: ssd.ssd_scan_fwd(a, k, v, q, chunk,
                                               save_states=True), 10)
    row["plain_ms"] = timer(lambda: ssd._plain_forward(a, k, v, q, chunk),
                            3, 1)
    row["library_ms"] = None
    del a, k, v, q, y, fin, states, py, pfin, pstates, y2, fin2
    return row


def _fitted_flash_shapes() -> list:
    """The flash pair's shape at each dry-run train cell's fitted
    microbatch on this card (B // microbatches sequences of seq_len +
    frontend_tokens positions), from the fit's prediction."""
    hbm = torch.cuda.get_device_properties(0).total_memory
    out = []
    for arch, shape, _ in DRYRUN_STEP_CELLS:
        if shape != "train_4k":
            continue
        acfg = get_config(arch)
        rec = dryrun.run_cell(arch, shape, hbm_bytes=hbm, predict_only=True)
        if not rec["fits_hbm"]:
            continue
        b = rec["batch"] // rec["microbatches"]
        S = rec["seq_len"] + acfg.frontend_tokens
        K = acfg.n_kv_heads
        out.append((b, K, acfg.n_heads // K, S, S,
                    acfg.resolved_head_dim))
    return out


def phase_check(timer) -> list:
    """Every kernel against its plain version; returns all check rows."""
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 stays fp32
    gen = torch.Generator(device="cuda").manual_seed(42)
    cfg = get_config("gemma-2b")
    hd = cfg.resolved_head_dim
    products, zamba_products = _path_products()
    zcfg = get_config("zamba2-1.2b")
    # the launch floor: an empty kernel, timed as every kernel is
    floor_ms = timer(lambda: torch.cuda._sleep(0))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for T, length in ((1024, 700), (512, 512), (2048, 1), (700, 650),
                          (512, 0)):
            rows.append(_decode_case(timer, dtype, 2, 2, 4, 128, T, length,
                                     False, gen))
        G = cfg.n_heads // cfg.n_kv_heads
        for length in (0, 1, 160, 1024):
            rows.append(_decode_case(timer, dtype, 4, cfg.n_kv_heads, G, hd,
                                     1024, length, True, gen))
        for M, K, N in ((256, 512, 256), (300, 700, 500), (128, 128, 128)):
            rows.append(_matmul_case(timer, dtype, M, K, N, gen))
        for name, K, N in products:
            rows.append(_matmul_case(timer, dtype, 4, K, N, gen, name))
        # zamba2-1.2b's decode: the shared block (G = 1, K = 32, D = 64)
        # and its products, and each Mamba-2 layer's in_proj (N = 8384, a
        # multiple of no tile) and out_proj
        for length in (0, 1, 160, 1024):
            rows.append(_decode_case(timer, dtype, 4, zcfg.n_kv_heads, 1,
                                     zcfg.resolved_head_dim, 1024, length,
                                     True, gen))
        # the largest G the kernel takes, at D = 128
        for length in (1, 33, 161, 1024):
            rows.append(_decode_case(timer, dtype, 2, 2, 16, 128, 1024,
                                     length, True, gen))
        for name, K, N in zamba_products:
            rows.append(_matmul_case(timer, dtype, 4, K, N, gen,
                                     "zamba2:" + name))
        # yi-6b's and chatglm3-6b's decode (G 8 and 16, D 128) over one
        # layer's (4, 1024, K, 128) cache view, and each layer's 7 products
        for arch in ("yi-6b", "chatglm3-6b"):
            acfg = get_config(arch)
            for length in (0, 1, 160, 1024):
                rows.append(_decode_case(
                    timer, dtype, 4, acfg.n_kv_heads,
                    acfg.n_heads // acfg.n_kv_heads,
                    acfg.resolved_head_dim, 1024, length, True, gen))
            for name, K, N in _layer_products(acfg):
                rows.append(_matmul_case(timer, dtype, 4, K, N, gen,
                                         f"{arch}:{name}"))
        # xlstm-350m's decode products (batch 4)
        for name, K, N in _xlstm_products(get_config("xlstm-350m")):
            rows.append(_matmul_case(timer, dtype, 4, K, N, gen,
                                     "xlstm-350m:" + name))
        # moonshot-v1-16b-a3b's decode (G 1, K 16, D 128) and dbrx-132b's
        # (G 6: the kernel's block of 8 heads with 2 masked; K 8, D 128)
        # over one layer's cache view, and each layer's attention and
        # shared-expert products
        for arch in ("moonshot-v1-16b-a3b", "dbrx-132b"):
            acfg = get_config(arch)
            for length in (0, 1, 160, 1024):
                rows.append(_decode_case(
                    timer, dtype, 4, acfg.n_kv_heads,
                    acfg.n_heads // acfg.n_kv_heads,
                    acfg.resolved_head_dim, 1024, length, True, gen))
            for name, K, N in _moe_layer_products(acfg):
                rows.append(_matmul_case(timer, dtype, 4, K, N, gen,
                                         f"{arch}:{name}"))
        # phi-3-vision-4.2b's decode (G 1, K 32, D 96) and nemotron-4-
        # 340b's (G 12: a block of 8 heads and one of 4 with 4 masked; K
        # 8, D 192) over one layer's cache view (musicgen-large's, K 32, G
        # 1, D 64, is zamba2's shared block's, above), and each layer's
        # products: musicgen's and nemotron's plain MLP 2, phi-3-vision's
        # SwiGLU 3; nemotron's w_up and w_down (2.7 GB each in bf16) with
        # the far end of the weight checked
        for arch in ("musicgen-large", "phi-3-vision-4.2b",
                     "nemotron-4-340b"):
            acfg = get_config(arch)
            if arch != "musicgen-large":
                for length in (0, 1, 160, 1024):
                    rows.append(_decode_case(
                        timer, dtype, 4, acfg.n_kv_heads,
                        acfg.n_heads // acfg.n_kv_heads,
                        acfg.resolved_head_dim, 1024, length, True, gen))
            for name, K, N in _layer_products(acfg):
                rows.append(_matmul_case(timer, dtype, 4, K, N, gen,
                                         f"{arch}:{name}"))
                torch.cuda.empty_cache()
        for case in (
                (1, 1, 1, 128, 128, 128, True), (1, 1, 1, 128, 128, 128, False),
                (2, 2, 2, 256, 256, 128, True), (2, 2, 2, 256, 256, 128, False),
                (1, 2, 4, 128, 384, 128, True), (1, 2, 4, 128, 384, 128, False),
                (1, 2, 4, 128, 300, 128, False),    # T % 128 != 0 (R1)
                (2, 1, 4, 24, 24, 16, True),        # the reduced config
                # S and T multiples of no tile, at gemma-2b's G and D
                (1, 1, 8, 300, 300, 256, True),
                (1, 1, 8, 128, 384, 256, True),     # S != T at D = 256
                (1, 32, 1, 512, 512, 64, True),     # zamba2's G, K, D
                # chatglm3-6b's G 16 at D 128, S and T multiples of no tile
                (1, 2, 16, 300, 300, 128, True),
                # dbrx-132b's G 6 (no power of 2), causal and not
                (1, 2, 6, 300, 300, 128, True),
                (1, 2, 6, 256, 384, 128, False),
                # phi-3-vision-4.2b's D 96 (the D 128 instantiation) and
                # nemotron-4-340b's G 12 at D 192 (the D 256 one), S and T
                # multiples of no tile, causal and not
                (1, 4, 1, 300, 300, 96, True),
                (1, 2, 12, 300, 300, 192, True),
                (1, 2, 12, 256, 384, 192, False),
                # peaked scores (q x 8): the running max moves
                (1, 1, 8, 300, 300, 256, True, 8.0),
                (1, 32, 1, 512, 512, 64, True, 8.0),
                (1, 2, 4, 128, 300, 128, False, 8.0),
                (1, 2, 16, 300, 300, 128, True, 8.0),
                (1, 2, 6, 300, 300, 128, True, 8.0),
                (1, 4, 1, 300, 300, 96, True, 8.0),
                (1, 2, 12, 300, 300, 192, True, 8.0),
                TRAIN_SHAPE + (True,)):
            if len(case) > 7 and dtype not in PEAKED_DTYPES:
                continue
            rows += _flash_case(timer, dtype, *case[:7], gen, *case[7:])
            torch.cuda.empty_cache()
    # zamba2's serving shape with peaked scores (q x 8): the running max
    # moves between tiles and between splits
    for length in (160, 1024):
        rows.append(_decode_case(None, torch.bfloat16, 4, zcfg.n_kv_heads, 1,
                                 zcfg.resolved_head_dim, 1024, length, True,
                                 gen, peak=8.0, against="float64"))
    rows += _stale_shared_cases(gen)
    rows += _matmul_edge_cases(gen)
    rows += _experts_cases(timer, gen)
    # the e4m3 route, and the decode products at M = 128 (a decode_32k
    # cell's batch): gemma-2b's and chatglm3-6b's 7 a layer and xlstm-
    # 350m's 5, bf16, as the dry run's cells run them
    rows += _e4m3_cases(timer, gen)
    rows += _long_decode_cases(timer, gen)
    rows += [_matmul_case(timer, torch.bfloat16, 128, K, N, gen, label,
                          want_route="wgmma")
             for label, K, N in _m128_products()]
    # ... and each again, untimed, behind a NaN fill of shared memory (a
    # generator of its own: the checks after them keep their draws)
    own = torch.Generator(device="cuda").manual_seed(34)
    rows += [_matmul_case(None, torch.bfloat16, 128, K, N, own, label,
                          stale_nan=True, want_route="wgmma")
             for label, K, N in _m128_products()]
    # the long_500k cells' decode products at M = 1 (batch 1), bf16
    rows += [_matmul_case(timer, torch.bfloat16, 1, K, N, gen, label,
                          want_route="mma")
             for label, K, N in _m1_products()]
    rows += _matmul_threshold_rows(timer)
    for r in rows:
        if r["kernel"] == "decode_attention" and "ms" in r:
            r["launch_floor_ms"] = floor_ms
    # zamba2's shared attention in training, then yi-6b's, chatglm3-6b's,
    # dbrx-132b's, musicgen-large's, phi-3-vision-4.2b's (also with its 144
    # patch positions) and nemotron-4-340b's attention, bf16 as the paths
    # run them; musicgen's with its 64 frames untimed (the last key tile
    # ragged at D 64)
    for shape in (ZAMBA_FLASH_SHAPE, YI_FLASH_SHAPE, GLM_FLASH_SHAPE,
                  DBRX_FLASH_SHAPE, MUSICGEN_FLASH_SHAPE, PHI3V_FLASH_SHAPE,
                  PHI3V_FRONT_FLASH_SHAPE, NEMOTRON_FLASH_SHAPE,
                  (2, 32, 1, 2112, 2112, 64)):
        rows += _flash_case(timer, torch.bfloat16, *shape, True, gen)
        torch.cuda.empty_cache()
    # the dry run's train cells' fitted microbatches, q x 8 (the flash pair
    # at each shape, once: at these lengths a bf16 output of unit-variance
    # scores is about as small as TOL, and peaked scores make a lost key
    # tile show), its prefill cells' 32,768 positions and more
    for shape in dict.fromkeys(_fitted_flash_shapes()):
        rows += [dict(r, fitted_microbatch=True) for r in _flash_case(
            None, torch.bfloat16, *shape, True, gen, peak=8.0)]
        torch.cuda.empty_cache()
    for cell, shape in _prefill_flash_shapes():
        rows.append(_flash_long_case(timer, gen, cell, *shape))
        torch.cuda.empty_cache()
    rows.append(_ssd_prefill_case(timer, gen))
    torch.cuda.empty_cache()
    zr = zcfg.reduced()
    for decay in ("strong", "near1"):
        for B, H, S, N, P, chunk, bcast in (
                (2, 3, 512, 64, 64, 256, False),      # tests/test_kernels.py
                (2, 3, 300, 32, 64, 128, False),
                (2, 3, 256, 16, 16, 256, False),
                (2, zr.ssm_expand * zr.d_model // zr.ssm_head_dim, 64,
                 zr.ssm_state, zr.ssm_head_dim, 64, True),  # reduced config
                (1, 4, 1000, 64, 64, 256, True),      # ragged last chunk
                # N and P no multiple of 4: the 4-byte copies
                (1, 2, 130, 6, 12, 64, True),
                *SSD_WIDE_CASES,
                SSD_TRAIN_SHAPE + (True,), XLSTM_SSD_SHAPE + (False,)):
            padded = (B, H, S, N, P, chunk) == XLSTM_SSD_SHAPE
            rows += _ssd_case(timer, B, H, S, N, P, chunk, bcast, decay, gen,
                              v_row=XLSTM_V_ROW if padded else None)
            torch.cuda.empty_cache()
    # xlstm's shape once more with v's rows unpadded (P floats apart, the
    # 4-byte copies): the wrapper takes any strides, timed beside the
    # model's layout
    rows += _ssd_case(timer, *XLSTM_SSD_SHAPE, False, "near1", gen)
    torch.cuda.empty_cache()
    for case in _ssd_stale_cases():
        rows += _ssd_case(None, *case, "near1", gen, stale_nan=True)
    for r in _knapsack_cases(timer):
        if "ms" in r:
            r["launch_floor_ms"] = floor_ms
        rows.append(r)
    for r in rows:
        emit(r)
    bad = [r for r in rows if not r["ok"]]
    require(not bad, f"{len(bad)} kernel checks outside tolerance")
    return rows


def _copy_rates(total: int) -> list:
    """Host<->device copy rates with the total split over 1, 2, 4 copy
    streams, pinned host memory, event-timed (median of 5)."""
    out = []
    for ch in (1, 2, 4):
        part = total // ch
        hosts = [torch.empty(part, dtype=torch.uint8, pin_memory=True)
                 for _ in range(ch)]
        devs = [torch.empty(part, dtype=torch.uint8, device="cuda")
                for _ in range(ch)]
        streams = [torch.cuda.Stream() for _ in range(ch)]
        row = dict(channels=ch, bytes=part * ch)
        for direction in ("h2d", "d2h"):
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for s, h, dv in zip(streams, hosts, devs):
                    s.wait_event(start)
                    with torch.cuda.stream(s):
                        if direction == "h2d":
                            dv.copy_(h, non_blocking=True)
                        else:
                            h.copy_(dv, non_blocking=True)
                for s in streams:
                    torch.cuda.current_stream().wait_stream(s)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            row[f"{direction}_GBps"] = part * ch / statistics.median(times) / 1e9
        out.append(row)
    return out


def _small_copy_latency(timer) -> dict:
    """Event-timed duration of one 128-byte copy (one cacheline of the
    H100 profile): device to device, and pinned host to device."""
    src_d = torch.empty(128, dtype=torch.uint8, device="cuda")
    dst_d = torch.empty(128, dtype=torch.uint8, device="cuda")
    src_h = torch.empty(128, dtype=torch.uint8, pin_memory=True)
    return dict(
        hbm_us=timer(lambda: dst_d.copy_(src_d, non_blocking=True)) * 1e3,
        host_us=timer(lambda: dst_d.copy_(src_h, non_blocking=True)) * 1e3)


def phase_runtime(timer) -> dict:
    """The reference's tiered_offload_demo scaled up: three real objects
    (256, 256, 512 MiB) start in pinned host memory; the fast tier holds
    640 MiB, so the planner must choose.  The cold object's accesses are
    set low enough that the planner keeps it on the host."""
    cap = 640 * MB
    rt = UnimemRuntime(H100_HBM_HOST, RuntimeConfig(
        backend="torch_async", enable_partitioning=False,
        fast_capacity_bytes=cap))
    gen = torch.Generator().manual_seed(7)
    golden, objs = {}, {}
    for name, mbs in (("weights_hot", 256), ("kv_block", 256),
                      ("opt_state_cold", 512)):
        data = torch.randint(0, 256, (mbs * MB,), dtype=torch.uint8,
                             generator=gen)
        golden[name] = data
        objs[name] = rt.register(name, data.pin_memory())
    tiers = []
    for it in range(4):
        with rt.iteration():
            with rt.phase("compute", elapsed=0.05,
                          accesses={"weights_hot": 4e5, "kv_block": 3e5}):
                pass
            with rt.phase("update", elapsed=0.02,
                          accesses={"opt_state_cold": 5e2}):
                pass
        tiers.append({n: o.tier for n, o in objs.items()})
    rt.mover.drain()
    torch.cuda.synchronize()
    rt.backend.settle()
    where = {n: ("cuda" if o.payload.is_cuda else
                 "pinned_host" if o.payload.is_pinned() else "pageable_host")
             for n, o in objs.items()}
    require(where["weights_hot"] == "cuda" and where["kv_block"] == "cuda",
            f"hot objects in HBM ({where})")
    require(where["opt_state_cold"] == "pinned_host",
            f"cold object in pinned host memory ({where})")
    require(all(o.tier == ("fast" if where[n] == "cuda" else "slow")
                for n, o in objs.items()), "tiers agree with placement")
    # round trips on the same backend: both hot objects out to the host,
    # the cold one in chained behind the eviction (after=), then back
    be = rt.backend
    trips = []
    for out_names, in_name in ((("weights_hot", "kv_block"),
                                "opt_state_cold"),
                               (("opt_state_cold",), "weights_hot")):
        last = None
        for n in out_names:
            last = be.start_move(objs[n], "slow", after=last)
        h = be.start_move(objs[in_name], "fast", after=last)
        be.wait(h)
        torch.cuda.synchronize()
        be.settle()
        trips.append({n: o.tier for n, o in objs.items()})
    for n, o in objs.items():
        require(torch.equal(o.payload.cpu(), golden[n]),
                f"bytes of {n} intact after its moves")
    require(objs["weights_hot"].payload.is_cuda
            and objs["opt_state_cold"].payload.is_pinned(),
            "round trips landed where they were sent")
    stats = rt.stats()
    res = dict(
        phase="runtime", profile=H100_HBM_HOST.name, capacity_bytes=cap,
        tiers_per_iteration=tiers, placement=where, round_trips=trips,
        plan_moves=[dict(obj=m.obj, dst=m.dst, trigger=m.trigger_phase,
                         needed_by=m.needed_by, bytes=m.size_bytes)
                    for m in rt.plan.moves],
        stats=stats,
        bytes_intact=True, copy_rates=_copy_rates(1024 * MB),
        small_copy_latency=_small_copy_latency(timer),
        host_memory_bytes=os.sysconf("SC_PAGE_SIZE")
        * os.sysconf("SC_PHYS_PAGES"))
    print(json.dumps(res, default=str), flush=True)
    return res


def _decode_errors(cfg, cpu, gpu, prompts, S, window=None,
                   kv=torch.bfloat16) -> dict:
    """Largest card-vs-CPU distance of the logits over one decode step per
    prompt token and, for zamba2, of each layer's SSM state and conv window
    after them; ``window`` replaces the conv window's dtype on both sides,
    ``kv`` is the KV cache's."""
    B, P = prompts.shape
    caches = {d: lm.init_cache(cfg, B, S, device=d, kv_dtype=kv)
              for d in ("cpu", "cuda")}
    if window is not None:
        for c in caches.values():
            c["mamba"]["conv"] = c["mamba"]["conv"].to(window)
    err = 0.0
    for i in range(P):
        a = lm.decode_step(cpu, cfg, caches["cpu"], prompts[:, i], i)
        b = lm.decode_step(gpu, cfg, caches["cuda"], prompts[:, i].cuda(), i)
        err = max(err, (a - b.cpu()).abs().max().item())
    out = dict(logits=err)
    for name, t in caches["cuda"].get("mamba", {}).items():
        out[name] = (t.float().cpu()
                     - caches["cpu"]["mamba"][name].float()).abs().max().item()
    return out


def _kv_rounding(cfg, params, prompts, S, kv=torch.bfloat16) -> float:
    """Largest distance, on the CPU, between the logits of one decode step
    per prompt token with a ``kv`` (bf16 or e4m3) KV cache and with an fp32
    one: how far rounding the cache to ``kv`` moves the logits."""
    B, P = prompts.shape
    caches = [lm.init_cache(cfg, B, S, device="cpu", kv_dtype=d)
              for d in (kv, torch.float32)]
    err = 0.0
    for i in range(P):
        a, b = (lm.decode_step(params, cfg, c, prompts[:, i], i)
                for c in caches)
        err = max(err, (a - b).abs().max().item())
    return err


def _attribution(cfg, params, prompts, S, device: str):
    """The attribution (OperandAttributionSource, 64 bins) of the fourth
    decode step over an e4m3 cache, after three, on ``device``."""
    B = prompts.shape[0]
    toks = prompts.to(device)
    cache = lm.init_cache(cfg, B, S, device=device, kv_dtype=E4M3)
    for p in range(3):
        lm.decode_step(params, cfg, cache, toks[:, p], p)
    sess = Session(H100_HBM_HOST)
    sess.register("params", params)
    sess.register("kv_cache", cache, chunkable=True)
    src = OperandAttributionSource(sess)
    with src.record("step"):
        lm.decode_step(params, cfg, cache, toks[:, 3], 3)
    return src.collect("step")


def phase_parity(arch: str, heads: int = None, head_dim: int = None
                 ) -> dict:
    """A reduced config with the same fp32 weights on the card and on the
    CPU: identical greedy tokens, logits within PARITY_TOL after each
    decode step and after ``forward`` over 600 positions (zamba2: three
    chunks of the SSD scan, the last ragged; an attention config: the
    flash kernel on every layer, ten key tiles, the last ragged).  zamba2's
    decode runs twice: with its bf16 conv window (ZAMBA_DECODE_TOL on the
    logits) and with the window in fp32 on both sides (PARITY_TOL on the
    logits, the SSM state and the window).  ``heads``: that many query
    heads over one KV head, so that the kernels run the config's real G
    (``reduced()`` leaves G = 4); for xlstm-350m one head makes the mLSTM's
    state N 128 x P 129, so that the 600-position forward runs the SSD
    forward's wide route (``reduced()`` gives N 32, P 33).  ``head_dim``:
    the config's real head width (``reduced()`` sets 16), so that the
    kernels run its D inside the model (phi-3-vision-4.2b's 96,
    nemotron-4-340b's 192).  A config with a frontend also runs
    ``forward`` with its reduced frontend embeddings (4 positions before
    the tokens) on both sides, within PARITY_TOL."""
    cfg = get_config(arch).reduced()
    if heads is not None:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-g{heads}",
                                  n_heads=heads, n_kv_heads=1)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-d{head_dim}",
                                  head_dim=head_dim)
    # the same draws from one CPU generator, placed on either device
    cpu, gpu = (lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=d, dtype=torch.float32)
                for d in ("cpu", "cuda"))
    B, P, n_new, S = 4, 12, 8, 64
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1))
    toks = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        ops.reset_launch_counts()
        eng = ServeEngine(cfg, params, max_seq=S, batch=B, device=dev)
        toks[dev] = eng.generate(prompts, n_new).cpu()
    generate_launches = ops.launch_counts()     # the card's
    same = torch.equal(toks["cpu"], toks["cuda"])
    hybrid = cfg.block_pattern == "mamba_shared_attn"
    xlstm = cfg.block_pattern == "xlstm"
    dec = _decode_errors(cfg, cpu, gpu, prompts, S)
    kv_rounding = arch in KV_ROUNDING_ARCHS
    res = dict(phase="parity", arch=cfg.name, params="float32",
               G=cfg.n_heads // cfg.n_kv_heads, D=cfg.resolved_head_dim,
               tokens_identical=same, logits_max_abs_err=dec["logits"],
               generate_launches=generate_launches,
               tol=(ZAMBA_DECODE_TOL if hybrid else
                    MOE_DECODE_TOL if cfg.is_moe else PARITY_TOL),
               forward_tol=PARITY_TOL)
    if kv_rounding:
        res["cpu_bf16_kv_rounding"] = _kv_rounding(cfg, cpu, prompts, S)
        res["tol"] = max(PARITY_TOL, res["cpu_bf16_kv_rounding"])
    if cfg.is_moe or kv_rounding:
        res["decode_fp32_kv_logits_max_abs_err"] = _decode_errors(
            cfg, cpu, gpu, prompts, S, kv=torch.float32)["logits"]
    e4m3 = (arch, heads) in E4M3_PARITY and head_dim is None
    if e4m3:
        rounding = _kv_rounding(cfg, cpu, prompts, S, kv=E4M3)
        a, b = (_attribution(cfg, p, prompts, S, d)
                for p, d in ((cpu, "cpu"), (gpu, "cuda")))
        res["e4m3"] = dict(
            logits_max_abs_err=_decode_errors(
                cfg, cpu, gpu, prompts, S,
                torch.float32 if hybrid else None, kv=E4M3)["logits"],
            tol=PARITY_TOL, cpu_e4m3_kv_rounding=rounding,
            rounding_floor=E4M3_ROUNDING_FLOOR,
            attribution_same=a.accesses == b.accesses
            and a.access_bins == b.access_bins,
            attribution_accesses=a.accesses)
        if hybrid:
            res["e4m3"]["window"] = "float32"
            res["e4m3"]["bf16_window_logits_max_abs_err"] = _decode_errors(
                cfg, cpu, gpu, prompts, S, kv=E4M3)["logits"]
            res["e4m3"]["bf16_window_tol"] = ZAMBA_DECODE_TOL
    if xlstm:
        d_in = cfg.ssm_expand * cfg.d_model
        res["mlstm_state"] = dict(N=d_in // cfg.n_heads,
                                  P=d_in // cfg.n_heads + 1)
    if hybrid:
        res["decode_bf16_window_max_abs_err"] = dec
        res["decode_fp32_window_max_abs_err"] = _decode_errors(
            cfg, cpu, gpu, prompts, S, torch.float32)
    seq = torch.randint(0, cfg.vocab_size, (B, 600),
                        generator=torch.Generator().manual_seed(2))
    ops.reset_launch_counts()
    want, _ = lm.forward(cpu, cfg, seq)
    got, _ = lm.forward(gpu, cfg, seq.cuda())
    res["forward_launches"] = ops.launch_counts()
    res["forward_logits_max_abs_err"] = (got.cpu() - want).abs().max().item()
    if cfg.frontend:
        fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                         generator=torch.Generator().manual_seed(3))
        want, _ = lm.forward(cpu, cfg, seq, fe)
        got, _ = lm.forward(gpu, cfg, seq.cuda(), fe.cuda())
        res["frontend"] = dict(
            kind=cfg.frontend, positions=cfg.frontend_tokens,
            logits_shape=list(got.shape),
            logits_max_abs_err=(got.cpu() - want).abs().max().item())
    emit(res)
    require(same, "greedy tokens identical on card and CPU")
    require(res["logits_max_abs_err"] <= res["tol"], "logits within tolerance")
    if e4m3:
        require(res["e4m3"]["logits_max_abs_err"] <= PARITY_TOL,
                "with an e4m3 cache, decode logits within PARITY_TOL")
        require(rounding >= E4M3_ROUNDING_FLOOR,
                "rounding the cache to e4m3 moves the CPU's logits at "
                "least E4M3_ROUNDING_FLOOR, so the parity check sees a "
                "cache kept wider than e4m3")
        if hybrid:
            require(res["e4m3"]["bf16_window_logits_max_abs_err"]
                    <= ZAMBA_DECODE_TOL, "with an e4m3 cache and the bf16 "
                    "conv window, decode logits within ZAMBA_DECODE_TOL")
        require(res["e4m3"]["attribution_same"], "a decode step's "
                "attribution is the same PhaseSample on the card and the CPU")
    if hybrid:
        require(all(e <= PARITY_TOL for e in
                    res["decode_fp32_window_max_abs_err"].values()),
                "with an fp32 conv window, decode logits, SSM state and "
                "window within PARITY_TOL")
        require(res["forward_launches"]["ssd_scan"] == cfg.n_layers,
                "the forward ran the SSD kernel on every layer")
    elif xlstm:
        require(res["forward_launches"]["ssd_scan"]
                == lm._xlstm_counts(cfg)[0]
                and not res["forward_launches"]["flash_attention"],
                "the forward ran the SSD kernel on every mLSTM layer")
    else:
        require(res["forward_launches"]["flash_attention"] == cfg.n_layers,
                "the forward ran the flash kernel on every layer")
    if cfg.is_moe or kv_rounding:
        require(res["decode_fp32_kv_logits_max_abs_err"] <= PARITY_TOL,
                "with an fp32 KV cache, decode logits within PARITY_TOL")
    if cfg.is_moe:
        require(generate_launches["tiered_matmul_experts"]
                == 3 * cfg.n_layers * (P + n_new),
                "every routed product of the card's decode ran the expert "
                f"route ({generate_launches})")
    require(res["forward_logits_max_abs_err"] <= PARITY_TOL,
            "forward logits within tolerance")
    if cfg.frontend:
        require(res["frontend"]["logits_shape"] == [
            B, cfg.frontend_tokens + 600, cfg.vocab_size]
            and res["frontend"]["logits_max_abs_err"] <= PARITY_TOL,
            "forward with frontend embeddings within tolerance")
    return res


def _expected_launches(cfg, path: str, steps: int) -> dict:
    """Exact launches of each kernel entry point on a path, from the
    (possibly cut) config.  serve, per decode step and attention layer:
    one decode attention and 4 attention products through tiered_matmul,
    and the MLP's 3 (gated) or 2 (plain: musicgen-large, nemotron-4-340b);
    zamba2 one decode attention and 7 products a shared-block application
    and 2 products a Mamba-2 layer; xlstm-350m 3 products an mLSTM layer
    and 2 an sLSTM layer, no attention or SSD launch; MoE 4 attention
    products and 3 shared-expert ones (none for dbrx) through tiered_matmul
    and the 3 routed products through its expert route.  train, per step:
    every attention layer's flash forward twice (remat) and its backward
    once; zamba2 also 2 + 1 SSD launches a Mamba-2 layer, xlstm 2 + 1 an
    mLSTM layer and no flash launch; MoE as a dense config (the experts'
    products go to torch.matmul)."""
    counts = dict.fromkeys(ops.launch_counts(), 0)
    if cfg.block_pattern == "xlstm":
        n_m, n_s = lm._xlstm_counts(cfg)
        if path == "serve":
            counts["tiered_matmul"] = (3 * n_m + 2 * n_s) * steps
        else:
            counts["ssd_scan"] = 2 * n_m * steps
            counts["ssd_scan_bwd"] = n_m * steps
        return counts
    L = cfg.n_layers
    attn = L if cfg.block_pattern == "attn" else -(-L // cfg.attn_every)
    if path == "serve" and cfg.is_moe:
        shared = 3 if cfg.moe_shared_experts else 0
        counts["decode_attention"] = L * steps
        counts["tiered_matmul"] = (4 + shared) * L * steps
        counts["tiered_matmul_experts"] = 3 * L * steps
    elif path == "serve":
        counts["decode_attention"] = attn * steps
        mamba = 2 * L if cfg.block_pattern == "mamba_shared_attn" else 0
        mlp = 2 if cfg.mlp_type == "mlp" else 3
        counts["tiered_matmul"] = ((4 + mlp) * attn + mamba) * steps
    else:
        counts["flash_attention"] = 2 * attn * steps
        counts["flash_attention_bwd"] = attn * steps
        if cfg.block_pattern == "mamba_shared_attn":
            counts["ssd_scan"] = 2 * L * steps
            counts["ssd_scan_bwd"] = L * steps
    return counts


def _serve_source(cfg, B, P, n_new, tenant) -> ManualSource:
    """Analytic access counts (bytes / cacheline) of one request's phases:
    every step reads all weights once (the tied head reads the whole
    embedding), the KV cache rows written so far and, for zamba2, reads and
    writes every layer's SSM state and conv window; xlstm has no KV cache
    and reads and writes every layer's recurrent state."""
    line = H100_HBM_HOST.cacheline_bytes
    wbytes = 2 * cfg.n_params()
    n_kv, state = cfg.n_layers, 0
    if cfg.block_pattern == "xlstm":
        n_kv = 0
        state = 2 * sum(t.numel() * t.element_size() for t in _tree.leaves(
            lm.init_cache(cfg, B, 1, device="meta")))
    if cfg.block_pattern == "mamba_shared_attn":
        n_kv = -(-cfg.n_layers // cfg.attn_every)
        state = 2 * sum(t.numel() * t.element_size() for t in
                        lm.init_cache(cfg, B, 1, device="meta")["mamba"]
                        .values())
    kv_row = 2 * n_kv * B * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    kv = lambda a, b: sum(kv_row * (p + 1) + state  # noqa: E731
                          for p in range(a, b))
    src = ManualSource()
    src.set(f"{tenant}/prefill", accesses={
        f"{tenant}/params": P * wbytes / line,
        f"{tenant}/kv_cache": kv(0, P) / line})
    src.set(f"{tenant}/decode", accesses={
        f"{tenant}/params": n_new * wbytes / line,
        f"{tenant}/kv_cache": kv(P, P + n_new) / line})
    return src


PROFILE_PAD = 128                   # launches, after a fill of one float
PROFILE_GUARD_S = 0.05              # host time before the pad, after the run


def _profile_guard() -> None:
    """``PROFILE_GUARD_S`` of host time with the card idle, then a marker
    kernel (``torch.cuda._sleep``'s)."""
    torch.cuda.synchronize()
    time.sleep(PROFILE_GUARD_S)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _device_profile(run, steps: int, wall_ms: float, groups=None) -> dict:
    """torch.profiler over ``run()`` (``steps`` steps): device busy time
    (union of device intervals), idle share against the unprofiled step
    time ``wall_ms``, the kernels that take the most device time and, with
    ``groups`` ({group: name substrings}), device time per group (the rest
    under "other").  The trace drops kernels at a profiling session's head
    in two ways (H100): the first few of the session, more the more
    sessions the process ran (1 to 21), and every kernel whose device time
    stamp, converted to the host's clock, falls before the session's start
    (the stamps lag the host's by up to ~6 ms, by a lag that changes from
    session to session).  So each session opens with ``PROFILE_GUARD_S``
    of host time, PROFILE_PAD throwaway launches and a marker kernel, and
    closes with the same guard and a second marker; only the kernels
    between the two markers count.  ``calls_per_step_by_kernel``: the
    calls a step of each group substring's kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_GUARD_S)
        pad = torch.zeros(1, device="cuda")
        for _ in range(PROFILE_PAD):
            pad.add_(1)
        _profile_guard()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0) / steps
        _profile_guard()
        time.sleep(PROFILE_GUARD_S)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = sorted(e.time_range.start for e in dev
                   if "spin_kernel" in e.name)
    require(len(marks) == 2, "the profile's two marker kernels are in its "
            f"trace ({len(marks)})")
    seen = sum(1 for e in dev if e.time_range.start < marks[0])
    dev = [e for e in dev if marks[0] < e.time_range.start < marks[1]]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy_ms = busy / 1e3 / steps
    by_group, calls_by_group, calls_by_key = {}, {}, {}
    for name, (t, c) in by_name.items():
        g = next((g for g, keys in (groups or {}).items()
                  if any(k in name for k in keys)), "other")
        by_group[g] = by_group.get(g, 0.0) + t / 1e3 / steps
        calls_by_group[g] = calls_by_group.get(g, 0) + c / steps
        for k in (groups or {}).get(g, ()):
            if k in name:
                calls_by_key[k] = calls_by_key.get(k, 0) + c / steps
    return dict(
        ms_per_step_by_group=by_group, calls_per_step_by_group=calls_by_group,
        calls_per_step_by_kernel=calls_by_key,
        steps=steps, device_events=len(dev),
        trace_dropped_at_start=PROFILE_PAD + 1 - seen,
        device_events_per_step=len(dev) / steps,
        device_busy_ms_per_step=busy_ms if dev else None,
        wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=profiled_ms,
        device_idle_share=(1.0 - busy_ms / wall_ms) if dev else None,
        top_kernels=[dict(name=n[:96], ms_per_step=t / 1e3 / steps,
                          calls_per_step=c / steps)
                     for n, (t, c) in top])


# the port's serving kernels, by their names in the profile; the serving
# products run only the tensor-core kernels, one launch a call (the
# mma.sync kernel at a serving batch, the warpgroup kernel at the dry run's
# decode batch of 128): the FFMA route and the old split-K sum kernel must
# not appear
WGMMA_KERNEL = "::tiered_wgmma_kernel<"
SERVE_GROUPS = {
    "decode_attention": ["::decode_kernel<"],
    "tiered_matmul": ["::tiered_mma_kernel(", WGMMA_KERNEL],
    "tiered_matmul_ffma": ["::tiered_ffma_kernel<"],
    "tiered_matmul_experts": ["::tiered_experts_mma_kernel("],
    "tiered_matmul_experts_ffma": ["::tiered_experts_ffma_kernel<"],
    "splitk_sum": ["splitk_sum_kernel"],
}


def _profile(params, cfg, prompts, S, steps: int, wall_ms: float) -> dict:
    """The profile of a few decode steps, after four unprofiled ones, fed
    a request's prompt tokens (each row its own: rows fed one token would
    route every row of an MoE layer to the same experts)."""
    B = prompts.shape[0]
    toks = prompts.cuda()
    cache = lm.init_cache(cfg, B, S)
    for p in range(4):
        lm.decode_step(params, cfg, cache, toks[:, p], p)

    def run():
        for p in range(4, 4 + steps):
            lm.decode_step(params, cfg, cache, toks[:, p], p)
    return _device_profile(run, steps, wall_ms, SERVE_GROUPS)


def _routed_experts(params, cfg, prompts, S, steps: int) -> list:
    """The distinct experts each MoE layer's decode picks in the steps that
    :func:`_profile` profiles (replayed unprofiled), from ``moe._route``
    wrapped from outside the package: one count a layer and step."""
    counts, real = [], moe._route

    def spy(p, x, c):
        probs, gates, idx = real(p, x, c)
        counts.append(int(torch.unique(idx).numel()))
        return probs, gates, idx
    toks = prompts.cuda()
    cache = lm.init_cache(cfg, prompts.shape[0], S)
    moe._route = spy
    try:
        for p in range(4 + steps):
            if p == 4:
                counts.clear()
            lm.decode_step(params, cfg, cache, toks[:, p], p)
    finally:
        moe._route = real
    return counts


def _free() -> None:
    """Release what an earlier phase left, and reset the peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_serve(arch: str, name: str, layers: int = None) -> dict:
    """A full-width model, bf16, batch 4, three requests of 128 + 32
    tokens under the runtime; the third repeats the first.  ``layers``
    cuts the depth (the row says so under ``reduced``, with the reason:
    weights that fit no tier, or the run's time limit)."""
    _free()
    cfg = full = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(full, n_layers=layers)
    B, P, n_new, S = 4, 128, 32, 1024
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rt = UnimemRuntime(H100_HBM_HOST, RuntimeConfig(backend="torch"))
    rt.attach_source(_serve_source(cfg, B, P, n_new, "t0"))
    eng = ServeEngine(cfg, params, max_seq=S, batch=B, runtime=rt,
                      tenant="t0")
    gen = torch.Generator().manual_seed(1)
    p1 = torch.randint(0, cfg.vocab_size, (B, P), generator=gen)
    p2 = torch.randint(0, cfg.vocab_size, (B, P), generator=gen)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()            # the main path starts here
    outs, secs = [], []
    for prompts in (p1, p2, p1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(eng.generate(prompts, n_new).cpu())
        secs.append(time.perf_counter() - t)
    launches = ops.launch_counts()       # ... and ends here
    steps = 3 * (P + n_new)
    expect = _expected_launches(cfg, "serve", steps)
    peak = torch.cuda.max_memory_allocated()
    logits = lm.decode_step(params, cfg, lm.init_cache(cfg, B, S),
                            outs[0][:, 0].cuda(), 0)
    plan = rt.plan
    plan_objs = sorted({m.obj for m in plan.moves}
                       | {o for r in plan.residents for o in r}) if plan else []
    wall_ms = [1e3 * s / (P + n_new) for s in secs]
    res = dict(
        phase=name, arch=cfg.name, dtype="bfloat16",
        n_params=cfg.n_params(), layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, batch=B, prompt=P, new=n_new, max_seq=S,
        reduced=None if layers is None else dict(
            n_layers=[full.n_layers, layers],
            reason=f"bf16 weights of the whole model, "
                   f"{2 * full.n_params() / 1e9:.1f} GB, fit neither the "
                   "card's 80 GB nor the 108 GB host tier"
            if 2 * full.n_params() > 80e9 else
            "the run's time limit: the decode step is host-bound, so its "
            "time grows with the layers, which all run the same kernels at "
            "the same shapes (EARLIER_SERVE_LAYERS)"),
        requests=3, init_s=init_s, request_s=secs, ms_per_step=wall_ms,
        tokens_per_s=[B * (P + n_new) / s for s in secs],
        peak_mem_bytes=peak, launches=launches, launches_expected=expect,
        repeat_identical=torch.equal(outs[0], outs[2]),
        logits_shape=list(logits.shape),
        logits_finite=bool(torch.isfinite(logits).all().item()),
        runtime=dict(phases=rt.phase_names(), plan_objects=plan_objs,
                     strategy=plan.strategy if plan else None,
                     iterations=rt.stats()["iteration"]),
        sample=outs[0][0, P:P + 16].tolist())
    res["profile"] = prof = _profile(params, cfg, p1, S, 8, min(wall_ms))
    calls = prof["calls_per_step_by_group"]
    res["device_operations_per_step"] = prof["device_events_per_step"]
    # least time a decode step could take: the bytes of the weights it
    # reads (the products', and all of them with the embedding and the
    # head) over the card's memory rate
    res["tiered_matmul_ms_per_step"] = prof["ms_per_step_by_group"].get(
        "tiered_matmul")
    res["tiered_matmul_bytes_bound_ms_per_step"] = None
    if cfg.is_moe:
        # the expert route reads each expert the step's B k rows pick once:
        # its bound is the bytes of the experts the profiled steps picked
        # (E (1 - (1 - k / E)^B) a layer if the router spread them evenly);
        # the reference's dense buffer reads all E
        E, k = cfg.moe_experts, cfg.moe_top_k
        expert = 2 * sum(K * N for _, K, N in _moe_products(cfg))
        routed = _routed_experts(params, cfg, p1, S, 8)
        res["tiered_matmul_bytes_bound_ms_per_step"] = 2 * sum(
            K * N for _, K, N in _moe_layer_products(cfg)) * cfg.n_layers \
            / HBM_BW * 1e3
        res["tiered_matmul_experts_ms_per_step"] = prof[
            "ms_per_step_by_group"].get("tiered_matmul_experts")
        res["experts_routed_per_layer"] = sum(routed) / len(routed)
        res["experts_routed_per_layer_uniform"] = E * (1 - (1 - k / E) ** B)
        res["tiered_matmul_experts_bytes_bound_ms_per_step"] = (
            sum(routed) / 8 * expert / HBM_BW * 1e3)
        res["dense_experts_bytes_ms_per_step"] = (
            E * expert * cfg.n_layers / HBM_BW * 1e3)
    elif cfg.block_pattern == "attn":
        res["tiered_matmul_bytes_bound_ms_per_step"] = 2 * sum(
            K * N for _, K, N in _layer_products(cfg)) * cfg.n_layers \
            / HBM_BW * 1e3
    elif cfg.block_pattern == "xlstm":
        n_m, n_s = lm._xlstm_counts(cfg)
        prods = [K * N for _, K, N in _xlstm_products(cfg)]
        res["tiered_matmul_bytes_bound_ms_per_step"] = 2 * (
            n_m * sum(prods[:3]) + n_s * sum(prods[3:])) / HBM_BW * 1e3
    res["weights_bytes_bound_ms_per_step"] = (
        sum(t.numel() * t.element_size() for t in _tree.leaves(params))
        / HBM_BW * 1e3)
    emit(res)
    require(launches == expect, f"launch counts {launches} == {expect}")
    require(calls.get("tiered_matmul") == expect["tiered_matmul"] / steps
            and calls.get("tiered_matmul_experts", 0)
            == expect["tiered_matmul_experts"] / steps
            and not calls.get("tiered_matmul_ffma")
            and not calls.get("tiered_matmul_experts_ffma")
            and not calls.get("splitk_sum")
            and not prof["calls_per_step_by_kernel"].get(WGMMA_KERNEL),
            "every product of a decode step is one tensor-core launch, of "
            f"the mma.sync kernel at batch {B} ({calls})")
    require(res["repeat_identical"], "a repeated request gives the same tokens")
    require(res["logits_finite"] and res["logits_shape"] == [B, cfg.vocab_size],
            "finite logits of shape (batch, vocab)")
    require(all(o.shape == (B, P + n_new) for o in outs), "output shapes")
    require(plan is not None and plan_objs
            and all(o.startswith("t0/") for o in plan_objs)
            and rt.phase_names() == ["t0/prefill", "t0/decode"],
            "the runtime planned the tenant's objects and phases")
    return res


#: the cells the dry run's fit loop must run on an H100 80GB: (cell, the
#: KV cache dtype it must choose)
DRYRUN_MUST_RUN = {"gemma-2b|decode_32k|1xH100": "float8_e4m3fn"}


def _dryrun_expected(cfg, rec) -> dict:
    """Kernel launches of one decode step of a dry-run cell: as a serve
    path's (``_expected_launches``), the decode attention on the e4m3
    route over an e4m3 cache."""
    counts = _expected_launches(cfg, "serve", 1)
    if rec["kv_dtype"] == "float8_e4m3fn":
        counts["decode_attention_e4m3"] = counts.pop("decode_attention")
        counts["decode_attention"] = 0
    return {k: float(n) for k, n in counts.items() if n}


#: the dry run's train and prefill cells run on the card, in this order,
#: each one required to run: (arch, shape, run_cell's cuts).  Each train
#: cell runs 2 of its fitted microbatches a step; each prefill cell at batch 1 but
#: musicgen-large's, at MUSICGEN_PREFILL_BATCH (whole, 32 x 32,768, is
#: predicted to fit, but its forward would take ~35 s: 4.34 s at batch 4 on
#: an H100; the run's time limit).  xlstm-350m's train cell stays a
#: prediction: its sLSTM's per-position loop (ROADMAP item D) makes a
#: microbatch of 8 x 4,096 tens of seconds.
MUSICGEN_PREFILL_BATCH = 2
DRYRUN_STEP_CELLS = [
    ("gemma-2b", "train_4k", dict(microbatches_run=2)),
    ("zamba2-1.2b", "train_4k", dict(microbatches_run=2)),
    ("gemma-2b", "prefill_32k", dict(batch=1)),
    ("zamba2-1.2b", "prefill_32k", dict(batch=1)),
    ("musicgen-large", "prefill_32k", dict(batch=MUSICGEN_PREFILL_BATCH)),
    ("musicgen-large", "train_4k", dict(microbatches_run=2)),
    ("phi-3-vision-4.2b", "train_4k", dict(microbatches_run=2)),
    ("yi-6b", "train_4k", dict(microbatches_run=2)),
    ("chatglm3-6b", "train_4k", dict(microbatches_run=2))]
#: the most a fit's prediction may lie above the measured peak, so that
#: the fit loop does not turn away cells that fit; and the most the cost
#: probes' extrapolation may lie from the measured full-depth microbatch
DRYRUN_PEAK_SLACK = 1.25
DRYRUN_EXTRAP_TOL = 0.25
DRYRUN_PREDICTION_ONLY = {
    "xlstm-350m|train_4k|1xH100":
        "prediction only: the sLSTM's per-position loop (ROADMAP item D) "
        "makes a microbatch of 8 x 4,096 tens of seconds"}


def _step_expected(cfg, kind: str) -> dict:
    """Kernel launches of one train microbatch (a training step's,
    ``_expected_launches``) or of one prefill forward: one flash forward an
    attention layer (zamba2: a shared-block application), one SSD forward
    a Mamba-2 layer."""
    if kind == "train":
        counts = _expected_launches(cfg, "train", 1)
    else:
        counts = dict.fromkeys(ops.launch_counts(), 0)
        L = cfg.n_layers
        if cfg.block_pattern == "attn":
            counts["flash_attention"] = L
        elif cfg.block_pattern == "mamba_shared_attn":
            counts["flash_attention"] = -(-L // cfg.attn_every)
            counts["ssd_scan"] = L
    return {k: float(n) for k, n in counts.items() if n}


def _step_cell_checks(cfg, rec, pred) -> None:
    """A train or prefill cell that ran: as predicted, within the
    prediction and not far under it, finite, the launches of its program,
    the probes' extrapolation near the measured microbatch, the offload
    slice within its prediction, the attribution's objects."""
    cid, mem = rec["cell"], rec["memory"]
    require(rec["ran"] and rec["mode"] == pred["mode"]
            and rec["microbatches"] == pred["microbatches"],
            f"{cid} predicted to fit ran in its predicted mode "
            f"{pred['mode']} with {pred['microbatches']} microbatches")
    require(mem["measured_peak_bytes"] <= mem["peak_bytes"]
            <= DRYRUN_PEAK_SLACK * mem["measured_peak_bytes"],
            f"{cid}: measured peak {mem['measured_peak_bytes']} within the "
            f"prediction {mem['peak_bytes']}, which lies at most "
            f"{DRYRUN_PEAK_SLACK} x above it")
    kind = "prefill" if rec["mode"] == "prefill" else "train"
    if kind == "prefill":
        S = rec["seq_len"] + cfg.frontend_tokens
        require(rec["logits_finite"] and rec["logits_shape"] == [
            rec["batch"], S, cfg.vocab_size],
            f"{cid}: finite logits (batch, positions, vocab)")
    else:
        require(rec["loss_finite"] and math.isfinite(rec["grad_norm"]),
                f"{cid}: finite loss and gradient norm")
    expect = _step_expected(cfg, kind)
    require(rec["launches_per_microbatch"] == expect,
            f"{cid}: launches a microbatch {rec['launches_per_microbatch']}"
            f" == {expect}")
    ri = rec["roofline_inputs"]
    L1, L2 = ri["probe_layers"]
    for Lp in (L1, L2):
        want = _step_expected(dataclasses.replace(cfg, n_layers=Lp), kind)
        require(ri["probes"][f"L{Lp}"]["launches"] == want,
                f"{cid}: the {Lp}-layer probe's launches "
                f"{ri['probes'][f'L{Lp}']['launches']} == {want}")
    require(ri["extrapolated_from"] == "device_ms" and all(
        p["device_ms"] > 0 for p in ri["probes"].values()),
            f"{cid}: the probes' extrapolation carries their profiled "
            "device time")
    per_mb = rec["ms_a_step_extrapolated"] / (rec["microbatches"] or 1)
    require(abs(per_mb - rec["ms_a_microbatch"])
            <= DRYRUN_EXTRAP_TOL * rec["ms_a_microbatch"],
            f"{cid}: the probes' extrapolation {per_mb:.1f} ms a microbatch "
            f"within {DRYRUN_EXTRAP_TOL} of the measured "
            f"{rec['ms_a_microbatch']:.1f}")
    if rec["mode"] == "offload-grads":
        off = rec["offload"]
        require(off["slice_peak_measured"] and off["slice_finite"]
                and off["slice_peak_bytes"]
                <= off["slice_peak_bytes_predicted"],
                f"{cid}: the AdamW slice's measured peak "
                f"{off['slice_peak_bytes']} within its prediction "
                f"{off['slice_peak_bytes_predicted']}, finite")
    att = rec["unimem_attribution"]
    require(set(att) == set(dryrun.ATTRIBUTION_OBJECTS[rec["mode"]])
            and all(e["accesses"] > 0 for e in att.values()),
            f"{cid}: the attribution shows {sorted(att)}")
    if kind == "train":
        require(rec["params_step_over_forward"] > 2.0,
                f"{cid}: the backward's ops reach the attribution source "
                f"(params accesses {rec['params_step_over_forward']:.2f} x "
                "the forward's)")


def _probe_profile(run, steps: int, wall_ms: float) -> dict:
    """A cost probe's profile (:func:`_device_profile`, no groups)."""
    return _device_profile(run, steps, wall_ms)


def _dryrun_steps(hbm: int, preds: dict) -> list:
    """The train and prefill cells of DRYRUN_STEP_CELLS, each predicted to
    fit and each run as a path with ``--attribution`` and its roofline
    row."""
    paths, ran = [], set()
    for arch, shape, cuts in DRYRUN_STEP_CELLS:
        cfg = get_config(arch)
        cid = dryrun.cell_id(cfg, shape)
        pred = (preds[cid] if "batch" not in cuts else dryrun.run_cell(
            arch, shape, hbm_bytes=hbm, predict_only=True, **cuts))
        require(pred["fits_hbm"], f"{cid} ({cuts}) is predicted to fit")
        _free()
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, hbm_bytes=hbm, attribution=True,
                              steps=2, probe_profile=_probe_profile, **cuts)
        rec["seconds"] = time.perf_counter() - t0
        rec["roofline"] = roofline.analyze(rec)
        emit(dict(phase="dryrun", **rec))
        _step_cell_checks(cfg, rec, pred)
        ran.add((cid, rec["mode"]))
        paths.append(dict(phase="dryrun:" + cid, launches=rec["launches"]))
    for cid, mode in (("gemma-2b|train_4k|1xH100", "offload-grads"),
                      ("zamba2-1.2b|train_4k|1xH100", "fused")):
        require((cid, mode) in ran, f"{cid} runs in {mode} mode")
    return paths


def phase_dryrun() -> list:
    """The dry run (``launch/dryrun.py``): the fit prediction of every
    (config x shape) cell, then each decode cell predicted to fit run at
    full width and depth with ``--attribution``, its steps profiled, and
    its roofline row; then the train and prefill cells
    (:func:`_dryrun_steps`).  Each run cell is a path: its launches
    counted from 0 just before its timed steps.  The run fails if a decode
    cell predicted to fit does not run, its measured peak passes the
    prediction, its logits are not finite, or a step's launches differ
    from a serve step's."""
    _free()
    hbm = torch.cuda.get_device_properties(0).total_memory
    cells = [(a, s) for a in sorted(dryrun.ARCHS) for s in dryrun.SHAPES]
    preds = [dryrun.run_cell(a, s, hbm_bytes=hbm, predict_only=True)
             for a, s in cells]
    emit(dict(phase="dryrun_fit", hbm_bytes=hbm, cells=[
        dict({k: r.get(k) for k in ("cell", "status", "mode", "kv_dtype",
                                    "microbatches", "fits_hbm", "memory",
                                    "reason")},
             attempts=[a["peak_bytes"] for a in r.get("fit_attempts", [])],
             offload=r.get("offload"),
             run=DRYRUN_PREDICTION_ONLY.get(r["cell"]))
        for r in preds]))
    paths = []
    for (a, s), pred in zip(cells, preds):
        if (s not in dryrun.DECODE_SHAPES or pred["status"] != "ok"
                or not pred["fits_hbm"]):
            continue
        _free()
        t0 = time.perf_counter()
        rec = dryrun.run_cell(
            a, s, hbm_bytes=hbm, attribution=True,
            profile=lambda run, steps, wall: _device_profile(
                run, steps, wall, SERVE_GROUPS))
        rec["seconds"] = time.perf_counter() - t0
        rec["roofline"] = roofline.analyze(rec)
        cfg = get_config(a)
        expect = _dryrun_expected(cfg, rec)
        emit(dict(phase="dryrun", **rec))
        mem = rec["memory"]
        require(rec["ran"] and rec["kv_dtype"] == pred["kv_dtype"],
                f"{rec['cell']} predicted to fit ran as predicted")
        require(mem["measured_peak_bytes"] <= mem["peak_bytes"],
                f"{rec['cell']}: measured peak {mem['measured_peak_bytes']} "
                f"within the prediction {mem['peak_bytes']}")
        require(rec["logits_finite"]
                and rec["logits_shape"] == [rec["batch"], cfg.vocab_size],
                f"{rec['cell']}: finite logits (batch, vocab)")
        require(rec["launches_per_step"] == expect,
                f"{rec['cell']}: launches a step {rec['launches_per_step']} "
                f"== {expect}")
        # the step's products on the warpgroup kernel at a batch of
        # mm.WGMMA_MIN_M or more, on the mma.sync kernel below it
        calls = rec["profile"]["calls_per_step_by_kernel"]
        wg = calls.get(WGMMA_KERNEL, 0)
        require(wg == (expect["tiered_matmul"]
                       if rec["batch"] >= mm.WGMMA_MIN_M else 0)
                and rec["profile"]["calls_per_step_by_group"].get(
                    "tiered_matmul") == expect["tiered_matmul"],
                f"{rec['cell']}: the products' kernels a step ({calls})")
        paths.append(dict(phase="dryrun:" + rec["cell"],
                          launches=rec["launches"]))
    ran = {p["phase"][len("dryrun:"):] for p in paths}
    for cell, kv in DRYRUN_MUST_RUN.items():
        pred = next(r for r in preds if r["cell"] == cell)
        require(cell in ran and pred["kv_dtype"] == kv,
                f"{cell} runs with its {kv} cache")
    return paths + _dryrun_steps(hbm, {r["cell"]: r for r in preds})


def phase_train(arch: str, S: int, name: str, layers: int = None,
                lr: float = 3e-4, rerun: bool = False,
                profile_steps: int = 2) -> dict:
    """A full-width model, bf16 parameters from a seeded generator, AdamW
    (fp32 master and moments, lr 3e-4 unless given), per-layer remat,
    batch 2 x S tokens from the ported pipeline, 5 steps through
    ``train/loop.py`` under ``UnimemRuntime(H100_HBM_HOST)``.  ``layers``
    cuts the depth (the row says so under ``reduced``): at 16 bytes a
    parameter (bf16 weights and gradients, fp32 master and moments) a
    whole 6-billion-parameter model's training state outgrows the card's
    80 GB.  ``rerun``: the 5 steps run a second time, from the same seed,
    and must give the same losses, bit for bit.  ``profile_steps``: steps
    under the profiler."""
    cfg = full = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(full, n_layers=layers)
    B, steps = 2, 5
    tcfg = TrainConfig(steps=steps, global_batch=B, seq_len=S, lr=lr,
                       remat=True, log_every=1, seed=0,
                       machine=H100_HBM_HOST, device="cuda")
    opt = AdamWConfig(lr=lr)
    _free()
    ops.reset_launch_counts()            # the main path starts here
    t0 = time.perf_counter()
    res = train(cfg, tcfg, opt)
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    rt = res.runtime
    plan = rt.plan
    again = None
    if rerun:
        again = train(cfg, tcfg, opt).losses
    names = ({m.obj for m in plan.moves}
             | {o for r in plan.residents for o in r}) if plan else set()
    # a chunk of a registered object counts for its parent
    planned = sorted({rt.registry[n].parent or n if n in rt.registry else n
                      for n in names})
    expect = _expected_launches(cfg, "train", steps)
    ms = [1e3 * t for t in res.step_times]
    res_row = dict(
        phase=name, arch=cfg.name, dtype="bfloat16",
        n_params=cfg.n_params(), layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, batch=B, seq_len=S, steps=steps, remat=True,
        reduced=None if layers is None else dict(
            n_layers=[full.n_layers, layers],
            reason=f"training state of the whole model, "
                   f"{16 * full.n_params() / 1e9:.1f} GB at 16 bytes a "
                   "parameter, does not fit the card's 80 GB"
            if 16 * full.n_params() > 80e9 else
            "the run's time limit: the step is host-bound by the sLSTM's "
            "Python loop (XLSTM_TRAIN_LAYERS)"),
        optimizer=dict(lr=opt.lr, master_fp32=opt.master_fp32,
                       moments=opt.moments_dtype),
        losses=res.losses, grad_norms=res.grad_norms, ms_per_step=ms,
        rerun_losses=again,
        tokens_per_s=[B * S / t for t in res.step_times],
        total_s=total_s, peak_mem_bytes=peak,
        launches=launches, launches_expected=expect,
        runtime=dict(phases=rt.phase_names(), planned=planned,
                     registered={o.name: dict(bytes=o.size_bytes,
                                              tier=o.tier, pinned=o.pinned)
                                 for o in rt.registry if o.parent is None},
                     strategy=plan.strategy if plan else None,
                     stats=res.runtime_stats))
    del res, rt, plan
    _free()
    res_row["profile"] = _train_profile(cfg, tcfg, opt, min(ms[1:]),
                                        profile_steps)
    res_row["profile"]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if cfg.frontend:
        _free()
        res_row["frontend_step"] = _frontend_step(cfg, B, S)
    print(json.dumps(res_row, default=str), flush=True)
    losses = res_row["losses"]
    require(all(math.isfinite(x) for x in losses), "every loss finite")
    require(sum(losses[-2:]) / 2 < losses[0],
            "the mean of the last two losses is below the first")
    require(launches == expect, f"launch counts {launches} == {expect}")
    require(again is None or again == losses,
            f"a second run gives the same losses ({again} == {losses})")
    if cfg.frontend:
        fs = res_row["frontend_step"]
        require(all(math.isfinite(x) for x in fs["loss"])
                and all(g > 0 for g in fs["grad_abs_max"].values())
                and fs["launches"] == fs["launches_expected"],
                f"the frontend step: finite losses, nonzero gradients "
                f"({fs['grad_abs_max']}), launch counts")
    reg = res_row["runtime"]["registered"]
    require(res_row["runtime"]["phases"] == ["data", "step", "ckpt"]
            and "opt_state" in planned and "opt_state" in reg
            and reg.get("params", {}).get("pinned"),
            "the runtime planned opt_state (params pinned) over the "
            "phases data, step, ckpt")
    return res_row


def _frontend_step(cfg, B: int, S: int) -> dict:
    """``lm.loss_fn`` forward and backward (per-layer remat) with
    ``batch["frontend"]`` at full width, twice, on a fresh model: B x
    ``frontend_tokens`` embeddings drawn from a seeded generator before B x
    S tokens -- musicgen-large's 64 conditioning frames (std 0.02, the
    token embeddings' scale) or phi-3-vision-4.2b's 144 CLIP patch
    embeddings (std 1, projected by ``frontend_proj``).  Reports each
    call's ms (CUDA events), the peak memory, the kernel launches and the
    largest gradient on ``frontend_proj`` (vision) and on the embeddings."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = lm.init_params(cfg, gen, device="cuda")
    leaves, treedef = _tree.flatten(params)
    for t in leaves:
        t.requires_grad_()
    tree = _tree.unflatten(treedef, leaves)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                         generator=gen)
    scale = 1.0 if cfg.frontend == "vision" else 0.02
    fe = (torch.randn((B, cfg.frontend_tokens, cfg.d_model), device="cuda",
                      generator=gen) * scale).to(torch.bfloat16)
    fe.requires_grad_()
    batch = {"tokens": toks, "labels": toks, "frontend": fe}
    proj = [i for i, (p, _) in enumerate(_tree.flatten_with_path(tree)[0])
            if p == "['frontend_proj']"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = dict(loss=[], ms=[])
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss, _ = lm.loss_fn(tree, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, leaves + [fe],
                                    materialize_grads=True)
        ev[1].record()
        torch.cuda.synchronize()
        out["loss"].append(float(loss.detach()))
        out["ms"].append(ev[0].elapsed_time(ev[1]))
    out["launches"] = ops.launch_counts()
    L = cfg.n_layers
    out["launches_expected"] = dict.fromkeys(out["launches"], 0)
    out["launches_expected"].update(flash_attention=2 * 2 * L,
                                    flash_attention_bwd=2 * L)
    out["grad_abs_max"] = {"frontend": grads[-1].abs().max().item()}
    for i in proj:
        out["grad_abs_max"]["frontend_proj"] = grads[i].abs().max().item()
    out.update(kind=cfg.frontend, positions=cfg.frontend_tokens,
               seq_len=S + cfg.frontend_tokens, batch=B,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del params, leaves, tree, grads, loss
    return out


TRAIN_GROUPS = {
    "flash_attention": ["flash_fwd_kernel", "flash_fwd_wgmma"],
    # "::dq_kernel": the flash kernel's, not ssd_bwd_dq_kernel
    "flash_attention_bwd_dq": ["dq_wgmma", "::dq_kernel", "delta_kernel"],
    "flash_attention_bwd_dkdv": ["dkdv_wgmma", "dkdv_kernel",
                                 "split_sum_kernel"],
    # every kernel of either route: ssd_fwd_{sums,carry,chunk,scores,
    # wide}_kernel, ssd_bwd_{sums,carry,chunk,scores,dq,dk,dv,dla}_kernel
    "ssd_scan": ["ssd_fwd_"],
    "ssd_scan_bwd": ["ssd_bwd_"],
    "cublas_products": ["nvjet", "gemm", "cutlass", "sm90_xmma"],
}


def _train_profile(cfg, tcfg, opt, wall_ms: float, steps: int = 2) -> dict:
    """The profile of ``steps`` training steps (outside the runtime), after
    one unprofiled step, on a fresh model of the same configuration; then
    two steps timed in halves with CUDA events: forward + backward
    (``build_grads_step``) and the AdamW update."""
    gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
    params = lm.init_params(cfg, gen, device="cuda")
    state = init_opt_state(params, opt)
    step = build_train_step(cfg, opt, remat=tcfg.remat, lr=tcfg.lr)
    toks = torch.randint(0, cfg.vocab_size, (tcfg.global_batch, tcfg.seq_len),
                         device="cuda", generator=gen)
    batch = {"tokens": toks, "labels": toks}
    step(params, state, batch)

    def run():
        for _ in range(steps):
            step(params, state, batch)
    prof = _device_profile(run, steps, wall_ms, TRAIN_GROUPS)
    grads_step = build_grads_step(cfg, remat=tcfg.remat)
    halves = {"forward_backward_ms": [], "adamw_update_ms": []}
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        grads, _ = grads_step(params, batch)
        ev[1].record()
        adamw_update(grads, params, state, opt, tcfg.lr)
        ev[2].record()
        torch.cuda.synchronize()
        halves["forward_backward_ms"].append(ev[0].elapsed_time(ev[1]))
        halves["adamw_update_ms"].append(ev[1].elapsed_time(ev[2]))
        del grads
    prof.update(halves)
    return prof


def _sim_run(machine, wl, tier=None):
    """The quickstart's CG run: a static placement (``tier``) or Unimem with
    a 256 MB fast tier; returns (result, plan digest, host seconds,
    seconds of each plan build), the plan builds timed from outside the
    package by wrapping the session's ``_build_plan``."""
    if tier is not None:
        reg = ObjectRegistry()
        for n, s in wl.objects.items():
            reg.alloc(n, s, tier=tier)
        t0 = time.perf_counter()
        res = sim.SimulationEngine(machine, wl, registry=reg).run(10)
        return res, None, time.perf_counter() - t0, []
    rt = UnimemRuntime(machine, RuntimeConfig(fast_capacity_bytes=256 * MB),
                       cf=calibrate(machine))
    plans, build_plan = [], rt._build_plan

    def timed_build(*args, **kw):
        t = time.perf_counter()
        out = build_plan(*args, **kw)
        plans.append(time.perf_counter() - t)
        return out
    rt._build_plan = timed_build
    statics = wl.static_ref_counts()
    for n, s in wl.objects.items():
        rt.register(n, s, chunkable=wl.chunkable.get(n, False),
                    static_refs=statics.get(n))
    t0 = time.perf_counter()
    res = sim.SimulationEngine(machine, wl, runtime=rt).run(12)
    secs = time.perf_counter() - t0
    digest = hashlib.sha256(rt.plan.to_json().encode()).hexdigest()[:16]
    return res, digest, secs, plans


def phase_sim() -> dict:
    """The discrete-event simulator on the card's host (numpy only): the
    quickstart's CG workload (``examples/quickstart_torch.py``) DRAM-only,
    NVM-only and under Unimem, each twice: the same plan digest and
    iteration times both times, and Unimem's steady time between the other
    two.  Then the planner's wall time on a larger workload that replans
    (``paged_serving``, chunked objects, the default drift threshold)."""
    machine = PAPER_DRAM_NVM.scaled(bw_scale=0.5)
    runs = {}
    for name, tier in (("dram", "fast"), ("nvm", "slow"), ("unimem", None)):
        runs[name] = [_sim_run(machine, sim.NPB_WORKLOADS["cg"](), tier)
                      for _ in range(2)]
    steady = {n: r[0][0].steady_iteration_time for n, r in runs.items()}
    same = {n: r[0][0].iteration_times == r[1][0].iteration_times
            and r[0][1] == r[1][1] for n, r in runs.items()}
    uni = runs["unimem"]
    paged = _sim_run(PAPER_DRAM_NVM.scaled(bw_scale=0.5, lat_scale=2.0),
                     sim.SKEWED_SCENARIO_WORKLOADS["paged_serving"]())
    res = dict(
        phase="sim", workload="cg", steady_ms={n: s * 1e3
                                               for n, s in steady.items()},
        iteration_times_s={n: r[0][0].iteration_times
                           for n, r in runs.items()},
        plan_digest=[r[1] for r in uni], deterministic=same,
        unimem_host_s=[r[2] for r in uni],
        unimem_plan_build_s=[r[3] for r in uni],
        stats=uni[0][0].stats,
        paged_serving=dict(host_s=paged[2], plan_build_s=paged[3],
                           n_replans=paged[0].stats["n_replans"],
                           n_objects=paged[0].stats["n_objects"],
                           plan_digest=paged[1]))
    print(json.dumps(res, default=str), flush=True)
    require(all(same.values()), f"two runs give the same results ({same})")
    # the static and the managed runs add the same phase times in another
    # order, so Unimem at DRAM speed may differ from DRAM-only in the last
    # bits (54.0972288 against 54.097228799999996 ms here)
    eps = 1e-12
    require(steady["dram"] * (1 - eps) <= steady["unimem"]
            <= steady["nvm"] * (1 + eps),
            f"Unimem's steady time between DRAM-only and NVM-only ({steady})")
    require(all(r[3] for r in uni) and paged[0].stats["n_replans"] > 0,
            "the planner built plans and replanned")
    return res


def _plan_build(chunks: int, device_dp: bool, cells: list):
    """One plan of the chunk fixture (built afresh, untimed) with the numpy
    DP or the device DP: (PlanProgram JSON, host seconds of the build,
    the n * qcap of each knapsack solve)."""
    fx = planner_fixture.build_chunk_fixture(chunks)
    knapsack.use_device, knapsack.dp_device = device_dp, "cuda"
    cells.clear()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog = planner_fixture.plan_program(*fx[:3], PLANNER_CAPACITY)
        secs = time.perf_counter() - t0
    finally:
        knapsack.use_device = False
    return prog.to_json(), secs, list(cells)


def phase_planner() -> dict:
    """The planner above the device DP's threshold: the reference's chunk
    fixture (``sim/planner_fixture.py``) at PLANNER_CHUNKS chunks and a 256
    MiB fast tier, each plan built PLANNER_BUILDS times with the numpy DP
    and with the DP on the card (``knapsack.use_device``), in turns.  The
    two plans' JSON and digests must be equal, every solve at most 50M
    cells (no greedy cut) and some at least 8M (the device threshold), and
    the knapsack_dp launches exactly the solves at or above it.  The cells
    of each solve are read by wrapping ``knapsack._quantize`` from outside
    the package (one call a solve, after the filter).  Counts are set to 0
    just before the device builds and read just after."""
    cells, quantize = [], knapsack._quantize

    def counted(sizes, capacity, max_cells):
        out = quantize(sizes, capacity, max_cells)
        cells.append(len(sizes) * out[1])
        return out
    knapsack._quantize = counted
    res = dict(phase="planner", fast_tier_bytes=PLANNER_CAPACITY,
               device_min_work=knapsack._DEVICE_MIN_WORK, fixtures=[])
    expected = 0
    try:
        ops.reset_launch_counts()            # the planner's path starts here
        for chunks in PLANNER_CHUNKS:
            runs = {False: [], True: []}
            for _ in range(PLANNER_BUILDS):
                for on in (False, True):
                    runs[on].append(_plan_build(chunks, on, cells))
            solve_cells = runs[True][0][2]
            expected += PLANNER_BUILDS * sum(
                c >= knapsack._DEVICE_MIN_WORK for c in solve_cells)
            plans = {r[0] for rs in runs.values() for r in rs}
            digests = {on: [hashlib.sha256(r[0].encode()).hexdigest()[:16]
                            for r in rs] for on, rs in runs.items()}
            res["fixtures"].append(dict(
                chunks=chunks, solve_cells=solve_cells,
                numpy_dp_build_s=[r[1] for r in runs[False]],
                device_dp_build_s=[r[1] for r in runs[True]],
                plan_digest_numpy=digests[False],
                plan_digest_device=digests[True], plans_equal=len(plans) == 1,
                plan_json_bytes=len(runs[True][0][0])))
        launches = ops.launch_counts()       # ... and ends here
    finally:
        knapsack._quantize = quantize
    res.update(launches=launches,
               launches_expected=dict.fromkeys(launches, 0))
    res["launches_expected"]["knapsack_dp"] = expected
    emit(res)
    for f in res["fixtures"]:
        require(f["plans_equal"], f"{f['chunks']} chunks: the device DP's "
                "plans equal the numpy DP's, JSON and digest")
        require(max(f["solve_cells"]) <= 50_000_000
                and max(f["solve_cells"]) >= knapsack._DEVICE_MIN_WORK,
                f"{f['chunks']} chunks: solves between 8M and 50M cells "
                f"({f['solve_cells']})")
    require(launches["knapsack_dp"] > 0
            and launches == res["launches_expected"],
            f"knapsack_dp launched once a solve above the threshold "
            f"({launches['knapsack_dp']} of {expected})")
    return res


#: the distributed phase: gemma-2b's layers in its checkpoint and its
#: gradient step, the pipeline's microbatches and their blocks
DIST_CKPT_LAYERS = 2
DIST_PIPE_MICROBATCHES = 4
DIST_PIPE_BLOCKS = 2


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its element size (so NaNs and -0
    compare as bits)."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[
                                    t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b)))


def _cut_blocks(params, n: int):
    """``params`` with the stacked layers cut to the first ``n`` (views)."""
    leaves, treedef = _tree.flatten(params["blocks"])
    return dict(params, blocks=_tree.unflatten(treedef,
                                               [t[:n] for t in leaves]))


def _dist_checkpoint(mesh, params) -> dict:
    """Full-width gemma-2b cut to DIST_CKPT_LAYERS layers saved, then
    restored onto ``param_specs``' shardings (DTensors) and onto the plain
    device: each leaf the saved bits both ways."""
    small = _cut_blocks(params, DIST_CKPT_LAYERS)
    d = os.path.join(ROOT, "build", "distributed_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    mgr = CheckpointManager(d, keep=1)
    try:
        t = time.perf_counter()
        mgr.save(0, {"params": small}, blocking=True)
        save_s = time.perf_counter() - t
        sh = shd.shardings(mesh, shd.param_specs(mesh, small))
        t = time.perf_counter()
        _, placed = mgr.restore(shardings={"params": sh})
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t
        want = _tree.leaves(small)
        sharded_ok = all(
            type(p).__name__ == "DTensor" and _same_bits(p.to_local(), w)
            for p, w in zip(_tree.leaves(placed["params"]), want))
        del placed
        t = time.perf_counter()
        _, plain = mgr.restore(device="cuda")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        plain_ok = all(_same_bits(p, w) for p, w in
                       zip(_tree.leaves(plain["params"]), want))
        del plain
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dict(layers=DIST_CKPT_LAYERS, leaves=len(want),
                bytes=sum(t.numel() * t.element_size() for t in want),
                save_s=save_s, restore_sharded_s=sharded_s,
                restore_plain_s=plain_s, sharded_same_bits=sharded_ok,
                plain_same_bits=plain_ok)


def _dist_serve(mesh, cfg, params) -> dict:
    """The serve phase's batch, prompt and new tokens (one request) without
    the mesh hint, then with it: tokens, launches a step, wall ms a step
    (host clock, ending in the copy to the host) and host ms a step (the
    thread's CPU time)."""
    B, P, n_new, S = 4, 128, 32, 1024
    eng = ServeEngine(cfg, params, max_seq=S, batch=B, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1))
    steps = P + n_new
    out = {}
    for name, hint in (("plain", None), ("hinted", mesh)):
        common.set_mesh_hint(hint)
        try:
            eng.generate(prompts[:, :8], 2).cpu()              # warm-up
            ops.reset_launch_counts()
            t, c = time.perf_counter(), time.thread_time()
            toks = eng.generate(prompts, n_new).cpu()
            wall, cpu = time.perf_counter() - t, time.thread_time() - c
            launches = ops.launch_counts()
        finally:
            common.set_mesh_hint(None)
        out[name] = dict(tokens=toks, launches=launches,
                         launches_per_step={k: n / steps for k, n in
                                            launches.items() if n},
                         ms_per_step=1e3 * wall / steps,
                         host_ms_per_step=1e3 * cpu / steps)
    return out


def _dist_embed(mesh, table: torch.Tensor) -> dict:
    """``embed_lookup``'s hinted route (table and tokens as DTensors on
    their specs, the table vocab-sharded: gemma-2b ties it) against the
    plain gather, 2 x 2,048 tokens: the forward's bits, and the table's
    gradient's bits for an integer-valued output gradient (every sum
    exact, so any order of adds gives the same bits) and, for a normal
    draw, its largest difference (the plain gather's backward rounds to
    bf16 after each repeated row's add, the route once)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, table.shape[0], (2, 2048), generator=gen,
                           device="cuda")
    tspec = shd.fit(mesh, tuple(table.shape), "model", None)
    kspec = shd.fit(mesh, tuple(tokens.shape), shd.dp_axes(mesh), None)
    out = dict(tokens=list(tokens.shape), table=list(table.shape),
               table_spec=repr(tspec))
    plain_t = table.detach().clone().requires_grad_()
    plain_x = plain_t[tokens]
    for name, g in (
            ("int", torch.randint(-8, 9, plain_x.shape, generator=gen,
                                  device="cuda").to(table.dtype)),
            ("normal", torch.randn(plain_x.shape, generator=gen,
                                   device="cuda").to(table.dtype))):
        plain_t.grad = None
        plain_x.backward(g, retain_graph=True)
        td = distribute_tensor(table.detach(), mesh,
                               shd.placements(mesh, tspec)).requires_grad_()
        kd = distribute_tensor(tokens, mesh, shd.placements(mesh, kspec))
        common.set_mesh_hint(mesh)
        try:
            x = common.embed_lookup(td, kd, tied=True)
            x.backward(distribute_tensor(g, mesh, x.placements))
        finally:
            common.set_mesh_hint(None)
        grad = td.grad.to_local()
        out[name] = dict(
            forward_same_bits=_same_bits(x.to_local().detach(), plain_x),
            grad_same_bits=_same_bits(grad, plain_t.grad),
            grad_max_abs_err=(grad.float() - plain_t.grad.float()
                              ).abs().max().item(),
            grad_abs_max=plain_t.grad.float().abs().max().item(),
            rows_touched=int(torch.unique(tokens).numel()))
        del td, x, grad
    return out


def _dist_compression(mesh, cfg, params) -> dict:
    """``tree_compressed_psum`` over the data group of the gradients of one
    step of full-width gemma-2b cut to DIST_CKPT_LAYERS layers (batch 2 x
    2,048, bf16): its ms (CUDA events), the bytes all-reduced (fp32: the
    dequantized values, as the reference's psum) and the int8 codes and
    scales they stand for; per leaf the card's sent value against the
    CPU's quantize / dequantize of the same leaf, the error against x -
    sent and the reduced value against sent (one rank), bit for bit."""
    small = _cut_blocks(params, DIST_CKPT_LAYERS)
    c2 = dataclasses.replace(cfg, n_layers=DIST_CKPT_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(6)
    tok = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                        device="cuda")
    grads, _ = build_grads_step(c2)(small, {"tokens": tok, "labels": tok})
    group = mesh.get_group("data")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    reduced, errors = tree_compressed_psum(grads, group)
    end.record()
    torch.cuda.synchronize()
    rows, int8_bytes = [], 0
    for g, r, e in zip(_tree.leaves(grads), _tree.leaves(reduced),
                       _tree.leaves(errors)):
        q, s = quantize_int8(g)
        sent = dequantize_int8(q, s, g.shape)
        qc, sc = quantize_int8(g.cpu())
        sent_cpu = dequantize_int8(qc, sc, g.shape)
        int8_bytes += q.numel() + s.numel() * s.element_size()
        rows.append(dict(
            shape=list(g.shape), dtype=str(g.dtype).replace("torch.", ""),
            sent_same_bits_as_cpu=_same_bits(sent.cpu(), sent_cpu),
            error_is_x_minus_sent=_same_bits(e, g - sent),
            reduced_is_sent=_same_bits(r, sent)))
    return dict(leaves=len(rows), ms=start.elapsed_time(end),
                allreduce_bytes=sum(r.numel() * r.element_size()
                                    for r in _tree.leaves(reduced)),
                int8_payload_bytes=int8_bytes,
                grad_bytes=sum(g.numel() * g.element_size()
                               for g in _tree.leaves(grads)),
                per_leaf=rows)


def _dist_pipeline(cfg, params) -> dict:
    """``pipeline_forward`` on a one-rank "stage" mesh (S 1, M
    DIST_PIPE_MICROBATCHES microbatches of 1 x 2,048) through the first
    DIST_PIPE_BLOCKS full-width gemma-2b blocks, against those blocks
    applied to each microbatch directly: bits, and the kernel launches of
    the pipeline's run."""
    S, D = 2048, cfg.resolved_head_dim
    smesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    cos, sin = common.rope_frequencies(
        D, S, cfg.rope_theta, rotary_dim=int(D * cfg.rotary_fraction),
        device="cuda")
    leaves, treedef = _tree.flatten(params["blocks"])
    stage = _tree.unflatten(treedef, [t[None, :DIST_PIPE_BLOCKS]
                                      for t in leaves])

    def layer(p, x):
        for blk in lm._unstack(p, DIST_PIPE_BLOCKS):
            x = lm._block_fwd(blk, x, cos, sin, cfg)
        return x

    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = torch.randn((DIST_PIPE_MICROBATCHES, 1, S, cfg.d_model),
                     generator=gen, device="cuda").to(torch.bfloat16)
    fn = pipeline_forward(layer, 1, DIST_PIPE_MICROBATCHES, smesh)
    with torch.no_grad():
        ops.reset_launch_counts()
        ys = fn(stage, xs)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        row = _tree.unflatten(treedef, [t[0] for t in _tree.leaves(stage)])
        direct = torch.stack([layer(row, x) for x in xs])
    return dict(stages=1, microbatches=DIST_PIPE_MICROBATCHES,
                microbatch=[1, S], blocks=DIST_PIPE_BLOCKS,
                launches=launches, same_bits=_same_bits(ys, direct),
                out_finite=bool(torch.isfinite(ys).all().item()),
                out_abs_max=ys.float().abs().max().item())


def phase_distributed() -> dict:
    """The distributed layer on a world of one NCCL rank: ``make_host_mesh``
    (a (1, 1) ("data", "model") mesh), full-width, full-depth gemma-2b's
    parameters through ``param_specs`` and ``distribute``; a checkpoint of
    its first DIST_CKPT_LAYERS layers restored onto those shardings and
    onto the plain device; gemma-2b served with and without the mesh hint;
    ``embed_lookup``'s hinted route; ``tree_compressed_psum`` over one
    step's gradients; ``pipeline_forward`` through two blocks.  The
    process group is torn down at the end.  ``launches``: the hinted serve
    and the pipeline, each counted from 0 just before it."""
    _free()
    t0 = time.perf_counter()
    parts = {}
    mesh = make_host_mesh()
    try:
        res = dict(phase="distributed", backend=dist.get_backend(),
                   world_size=dist.get_world_size(),
                   mesh=shd.axis_sizes(mesh))
        cfg = get_config("gemma-2b")
        params = lm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda", dtype=torch.bfloat16)
        t = time.perf_counter()
        specs = shd.param_specs(mesh, params)
        dparams = shd.distribute(params, mesh, specs)
        torch.cuda.synchronize()
        parts["distribute"] = time.perf_counter() - t
        res["distribute"] = dict(
            leaves=len(_tree.leaves(params)),
            bytes=sum(p.numel() * p.element_size()
                      for p in _tree.leaves(params)),
            placements=sorted({repr(tuple(d.placements))
                               for d in _tree.leaves(dparams)}),
            same_bits=all(_same_bits(d.to_local(), p) for d, p in zip(
                _tree.leaves(dparams), _tree.leaves(params))))
        del dparams
        for name, fn, args in (
                ("checkpoint", _dist_checkpoint, (mesh, params)),
                ("serve", _dist_serve, (mesh, cfg, params)),
                ("embed", _dist_embed, (mesh, params["embed"])),
                ("compression", _dist_compression, (mesh, cfg, params)),
                ("pipeline", _dist_pipeline, (cfg, params))):
            t = time.perf_counter()
            res[name] = fn(*args)
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t
    finally:
        common.set_mesh_hint(None)
        dist.destroy_process_group()
    serve, pipe = res["serve"], res["pipeline"]
    res["launches"] = {k: serve["hinted"]["launches"][k]
                       + pipe["launches"][k] for k in pipe["launches"]}
    same_tokens = torch.equal(serve["plain"]["tokens"],
                              serve["hinted"]["tokens"])
    for run in serve.values():
        run["sample"] = run.pop("tokens")[0, 128:144].tolist()
    serve["same_tokens"] = same_tokens
    comp = res["compression"]
    per_leaf = comp.pop("per_leaf")
    comp["leaves_ok"] = sum(all(v for k, v in r.items()
                                if k not in ("shape", "dtype"))
                            for r in per_leaf)
    comp["failed_leaves"] = [r for r in per_leaf
                             if not all(v for k, v in r.items()
                                        if k not in ("shape", "dtype"))]
    res["seconds_by_part"] = parts
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    ck, emb = res["checkpoint"], res["embed"]
    require(res["backend"] == "nccl" and res["world_size"] == 1
            and res["mesh"] == {"data": 1, "model": 1},
            "a world of one NCCL rank, a (1, 1) mesh")
    require(res["distribute"]["same_bits"],
            "each distributed parameter's local shard has its bits")
    require(ck["sharded_same_bits"] and ck["plain_same_bits"],
            "the checkpoint restores its bits onto the shardings and plain")
    require(same_tokens, "the same greedy tokens with and without the hint")
    for k in ("decode_attention", "tiered_matmul"):
        require(serve["plain"]["launches"][k] > 0
                and serve["plain"]["launches"][k]
                == serve["hinted"]["launches"][k],
                f"{k} launches a step the same with and without the hint")
    require(emb["int"]["forward_same_bits"] and emb["int"]["grad_same_bits"]
            and emb["normal"]["forward_same_bits"]
            and emb["normal"]["grad_max_abs_err"]
            <= TOL[torch.bfloat16] * emb["normal"]["grad_abs_max"],
            "the hinted embedding: the plain gather's bits forward, its "
            "gradient's bits for exact sums, within TOL[bf16] otherwise")
    require(comp["leaves_ok"] == comp["leaves"] > 0,
            f"compressed psum bit for bit on every leaf "
            f"({comp['failed_leaves']})")
    require(pipe["same_bits"] and pipe["out_finite"]
            and pipe["launches"]["flash_attention"]
            == DIST_PIPE_MICROBATCHES * DIST_PIPE_BLOCKS,
            "the pipeline: the blocks' bits, one flash forward a block "
            "and microbatch")
    return res


def _knapsack_line(checks, paths, parent=None) -> dict:
    """knapsack_dp's row of the kernels line: the n 2,000 row at qcap
    16,384 (the 2,000-chunk fixture's global solve), with every timed
    size under ``shapes`` (``parent_ms``: the checkout given with
    ``--parent`` at the same n and qcap, ``parent``: {n: ms}) and the
    cluster-size sweep under ``ranks_sweep``; launches from the planner
    phase.  ``chain_floor_ms``: the same cluster's item loop with no table
    work, the least the solve can take in this design."""
    mine = [r for r in checks if r["kernel"] == "knapsack_dp"]
    timed = [r for r in mine if "ms" in r and not r["sweep"]]
    main = next(r for r in timed if r["line"])
    by_path = {p["phase"]: p["launches"]["knapsack_dp"] for p in paths}
    keys = ("ms", "plain_ms", "numpy_dp_ms", "copy_to_host_ms",
            "ns_per_item", "bound_ms", "bound_by", "launch_floor_ms")

    def parent_of(r):
        sh = r["shape"]
        return ((parent or {}).get(str(sh["n"]))
                if sh["qcap"] == KNAPSACK_QCAP and sh["case"] == "planner"
                else None)
    src, replaces = KERNELS["knapsack_dp"]
    row = dict(name="knapsack_dp", route="cuda", source=src,
               replaces=replaces, launches=sum(by_path.values()),
               launches_by_path=by_path,
               max_abs_err=max(r["max_abs_err"] for r in mine),
               checks=len(mine), checks_ok=sum(r["ok"] for r in mine),
               **{k: main[k] for k in keys}, library_ms=None,
               chain_floor_ms=main["chain_floor_ms"],
               chain_floor_cluster_barrier_ms=main[
                   "chain_floor_cluster_barrier_ms"],
               parent_ms=parent_of(main), ranks=main["shape"]["ranks"],
               width=main["shape"]["width"],
               library="none: no PyTorch call computes the DP",
               note=("no Pallas kernel: the reference runs the DP as one "
                     "jitted lax.scan (src/repro/core/knapsack.py:76 "
                     "_jax_dp); numpy_dp_ms is the port's numpy DP on the "
                     "card's host"),
               covers=(f"one call, n {main['shape']['n']} over qcap "
                       f"{main['shape']['qcap']} (route "
                       f"{main['shape']['route']}, "
                       f"{main['shape']['ranks']} ranks), the 2,000-chunk "
                       "fixture's global solve"),
               path=[p for p, n in by_path.items() if n])
    row["shapes"] = [dict(case=r["shape"]["case"], n=r["shape"]["n"],
                          qcap=r["shape"]["qcap"], route=r["shape"]["route"],
                          ranks=r["shape"]["ranks"],
                          max_abs_err=r["max_abs_err"],
                          chain_floor_ms=r.get("chain_floor_ms"),
                          parent_ms=parent_of(r),
                          **{k: r[k] for k in keys}) for r in timed]
    row["ranks_sweep"] = [dict(case=r["shape"]["case"], n=r["shape"]["n"],
                               qcap=r["shape"]["qcap"],
                               ranks=r["shape"]["ranks"],
                               width=r["shape"]["width"],
                               threads=r["shape"]["threads"], ms=r["ms"],
                               ns_per_item=r["ns_per_item"],
                               chain_floor_ms=r["chain_floor_ms"],
                               chain_floor_cluster_barrier_ms=r[
                                   "chain_floor_cluster_barrier_ms"])
                          for r in mine if "ms" in r and r["sweep"]]
    return row


def kernel_line(checks, paths, parent_ms=None) -> dict:
    """Each kernel's numbers at its path's shapes: decode attention one
    bf16 call at batch 4, length 160 over the (4, 1024, 1, 256) cache view;
    tiered_matmul one gemma-2b layer's 7 bf16 products at M = 4, summed;
    flash attention forward and backward one bf16 call at the gemma-2b
    training shape; the SSD scan and its gradient one fp32 call at the
    zamba2 training shape.  Launches are the sum over the main paths
    (``paths``: the serve and train rows of every model), each counted from
    0 just before its path ran; ``launches_by_path`` splits them.
    ``shapes``: the same numbers at yi-6b's and chatglm3-6b's shapes
    (decode over their serving caches at length 160, their layers' 7
    products, their training attention) and at xlstm-350m's (an mLSTM and
    an sLSTM layer's 5 decode products; the SSD pair at its training
    shape, with ``parent_ms`` null: the parent's kernels took N <= 64).
    ``parent_ms``: the SSD forward and backward of the checkout given with
    ``--parent`` ({"ssd_scan": ms, "ssd_scan_bwd": ms}), timed in this
    run, its e4m3 route at E4M3_PARENT_SHAPES before and after this
    checkout's checks ({"decode_attention_e4m3": {label: [ms, ms]}}), and
    its tiered_matmul at the M = 128 products likewise
    ({"tiered_matmul@M128": [{label: ms}, {label: ms}]}), summed into the
    "arch@M128" entries of tiered_matmul's shapes, and its knapsack DP at
    KNAPSACK_NS ({"knapsack_dp": {n: ms}})."""
    def pick(kernel, cond):
        return [r for r in checks if r["kernel"] == kernel
                and cond(r["dtype"], r["shape"])]

    def flash_train(dt, s):
        return dt == "bfloat16" and (s["B"], s["K"], s["G"], s["S"], s["T"],
                                     s["D"]) == TRAIN_SHAPE

    def ssd_train(dt, s):
        return (s["B"], s["H"], s["S"], s["N"], s["P"],
                s["chunk"]) == SSD_TRAIN_SHAPE and s["decay"] == "near1"

    gemma = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    flash_covers = ("one bf16 call at the gemma-2b training shape q "
                    "(2,1,8,2048,256), k/v (2,1,2048,256), causal")
    ssd_covers = ("one fp32 call at the zamba2-1.2b training shape: B 2, "
                  "H 64, S 4096, N = P = 64, chunk 256, k/q broadcast over "
                  "H, decays near 1")
    out = []
    for name, rows, covers in (
            ("decode_attention",
             pick("decode_attention", lambda dt, s: dt == "bfloat16"
                  and s["cache_view"] and s["length"] == 160
                  and s["D"] == 256),
             "one bf16 call, batch 4, length 160, cache view (4,1024,1,256)"),
            ("decode_attention_e4m3",
             [r for r in pick("decode_attention_e4m3", lambda dt, s:
                              dt == "bfloat16" and s.get("B") == 128
                              and s["D"] == 256) if "ms" in r],
             "one call, bf16 q over an e4m3 cache, at gemma-2b's "
             "decode_32k shape: batch 128, all 32,768 rows of the cache "
             "view (128,32768,1,256)"),
            ("tiered_matmul",
             pick("tiered_matmul", lambda dt, s: dt == "bfloat16"
                  and s["product"] in gemma),
             "one gemma-2b layer's 7 bf16 products at M=4, summed"),
            ("tiered_matmul_experts",
             [r for r in pick("tiered_matmul_experts", lambda dt, s:
                              dt == "bfloat16" and str(s["product"])
                              .startswith("moonshot-v1-16b-a3b:"))
              if "ms" in r],
             "one moonshot-v1-16b-a3b MoE layer's 3 routed bf16 products "
             "at batch 4 (24 rows over 64 experts of 2048 x 1408 and 1408 "
             "x 2048), summed; bound: the routed experts' weights"),
            ("flash_attention", pick("flash_attention", flash_train),
             flash_covers),
            ("flash_attention_bwd", pick("flash_attention_bwd", flash_train),
             flash_covers),
            ("ssd_scan", pick("ssd_scan", ssd_train), ssd_covers),
            ("ssd_scan_bwd", pick("ssd_scan_bwd", ssd_train), ssd_covers)):
        src, replaces = KERNELS[name]
        mine = [r for r in checks if r["kernel"] == name]
        by_path = {p["phase"]: p["launches"][name] for p in paths}
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=sum(by_path.values()), launches_by_path=by_path,
                   max_abs_err=max(r["max_abs_err"] for r in rows),
                   checks=len(mine), checks_ok=sum(r["ok"] for r in mine))
        for key in ("ms", "plain_ms", "bound_ms"):
            row[key] = sum(r[key] for r in rows)
        libs = [r["library_ms"] for r in rows]
        row["library_ms"] = None if None in libs else sum(libs)
        if name == "decode_attention_e4m3":
            # the parent's ms at each shape, before and after the checks
            runs = (parent_ms or {}).get(name) or {}
            row["parent_ms"] = runs.get("gemma-2b:decode_32k")
            row["library"] = rows[0]["library"]
            row["library_bf16_sdpa_ms"] = rows[0]["library_bf16_sdpa_ms"]
            row["library_bf16_bound_ms"] = rows[0]["library_bf16_bound_ms"]
            row["note"] = ("the e4m3 route of decode_attention: the "
                           "reference's kernel takes an e4m3 cache and casts "
                           "it to fp32 (src/repro/kernels/decode_attention.py"
                           ":42-43)")
        elif row["library_ms"] is None:
            row["library"] = "none: no single PyTorch call computes it"
        elif name == "tiered_matmul_experts":
            row["library"] = rows[0]["library"]
            row["note"] = ("a route of tiered_matmul; the reference "
                           "computes the experts' products with jnp.einsum "
                           "over its dense (B, E, C, d) buffer "
                           "(src/repro/models/moe.py:114-117)")
        row["bound_by"] = rows[0]["bound_by"]
        if name == "decode_attention":
            row["launch_floor_ms"] = rows[0]["launch_floor_ms"]
        if name.startswith("ssd_scan"):
            row["kernels_a_call"] = rows[0]["kernels_a_call"]
            row["kernel_ms_a_call"] = rows[0]["kernel_ms_a_call"]
            row["bound_tc_ms"] = rows[0]["bound_tc_ms"]
            row["bytes_bound_ms"] = rows[0]["bytes_bound_ms"]
            row["parent_ms"] = (parent_ms or {}).get(name)
        row["covers"] = covers
        row["path"] = [p for p, n in by_path.items() if n]
        row["shapes"] = (_e4m3_shapes(checks, runs)
                         if name == "decode_attention_e4m3"
                         else _arch_shapes(checks, name))
        if name == "decode_attention":
            row["shapes"] += _long_shapes(checks)
        if name == "tiered_matmul":
            _m128_parents(row["shapes"], checks,
                          (parent_ms or {}).get("tiered_matmul@M128"))
        row["shapes"] += _prefill_shapes(checks, name)
        out.append(row)
    out.append(_knapsack_line(checks, paths,
                              (parent_ms or {}).get("knapsack_dp")))
    return {"kernels": out}


def _m128_parents(shapes, checks, runs) -> None:
    """The route each "arch@M128" entry of tiered_matmul's shapes took and,
    with ``--parent``, the parent's ms of the same products summed, before
    and after this checkout's checks (``runs``: [{label: ms}, ...])."""
    for entry in shapes:
        if not entry["arch"].endswith("@M128"):
            continue
        prefix = "m128:" + entry["arch"].split("@")[0] + ":"
        entry["routes"] = sorted({r["route"] for r in checks
                                  if r["kernel"] == "tiered_matmul"
                                  and str(r["shape"]["product"])
                                  .startswith(prefix)})
        entry["parent_ms"] = [sum(ms for label, ms in run.items()
                                  if label.startswith(prefix))
                              for run in runs] if runs else None


def _long_shapes(checks) -> list:
    """decode_attention's timed row at zamba2-1.2b's long_500k shape (bf16,
    all 524,288 rows)."""
    return [dict(arch="zamba2-1.2b:long_500k", rows=1,
                 max_abs_err=r["max_abs_err"],
                 float64_max_abs_err=r["float64_max_abs_err"],
                 ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"])
            for r in checks if r["kernel"] == "decode_attention"
            and "ms" in r and r["shape"]["length"] == 524288]


def _prefill_shapes(checks, name) -> list:
    """The forward's timed rows at the dry run's prefill_32k cells: the
    flash forward at each cell's attention shape (its plain version over
    three query tiles, ``plain_ms_sampled_tiles``), the SSD forward at
    zamba2-1.2b's 64 heads."""
    out = []
    for r in checks:
        if r["kernel"] != name or "prefill_cell" not in r:
            continue
        entry = dict(arch=r["prefill_cell"], rows=1,
                     max_abs_err=r["max_abs_err"], ms=r["ms"],
                     plain_ms=r.get("plain_ms"), bound_ms=r["bound_ms"],
                     bound_by=r["bound_by"], library_ms=r["library_ms"])
        if "plain_ms_sampled_tiles" in r:
            entry["plain_ms_sampled_tiles"] = r["plain_ms_sampled_tiles"]
        out.append(entry)
    return out


def _e4m3_shapes(checks, parent) -> list:
    """The e4m3 route's timed rows: gemma-2b's serving shape (fp32 and
    bf16 q) and chatglm3-6b's decode_32k shape; ``parent_ms`` the parent's
    times of the same label ({label: [ms before, ms after]}, ``--parent``)."""
    out = []
    for r in checks:
        s = r["shape"]
        if r["kernel"] != "decode_attention_e4m3" or "ms" not in r:
            continue
        label = ("chatglm3-6b:decode_32k" if s["G"] == 16 else
                 "gemma-2b:decode_32k" if s["B"] == 128 else
                 f"gemma-2b:serving:{r['dtype']}")
        out.append(dict(arch=label, rows=1, max_abs_err=r["max_abs_err"],
                        ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=None,
                        library_bf16_sdpa_ms=r["library_bf16_sdpa_ms"],
                        parent_ms=parent.get(label)))
    return out


def _arch_shapes(checks, name) -> list:
    """A kernel's times at yi-6b's and chatglm3-6b's shapes, bf16: decode
    at length 160 over the (4, 1024, K, 128) cache view, a layer's 7
    products at M = 4 summed, the flash pair at the training shapes; at
    xlstm-350m's: its 5 decode products at M = 4 (bf16) summed, the SSD
    pair at its training shape (fp32, decays near 1, v's rows padded as
    the model pads them); at moonshot-v1-16b-a3b's and dbrx-132b's: decode
    (G 1 and 6), a layer's attention and shared-expert products and its 3
    routed products (the expert route, batch 4) summed, and dbrx's flash
    pair at G 6; at musicgen-large's (decode at zamba2's shared block's
    shape, K 32, G 1, D 64; the plain MLP's 6 products a layer), phi-3-
    vision-4.2b's (D 96; the flash pair at 2048 and at 2048 + 144 patch
    positions, "+frontend") and nemotron-4-340b's (G 12, D 192; its 6
    products, and w_up and w_down alone, "...:w_up", and the flash pair at
    batch 1, on no path)."""
    out = []
    for arch, flash in (("yi-6b", YI_FLASH_SHAPE),
                        ("chatglm3-6b", GLM_FLASH_SHAPE),
                        ("xlstm-350m", None),
                        ("moonshot-v1-16b-a3b", None),
                        ("dbrx-132b", DBRX_FLASH_SHAPE),
                        ("musicgen-large", MUSICGEN_FLASH_SHAPE),
                        ("phi-3-vision-4.2b", PHI3V_FLASH_SHAPE),
                        ("phi-3-vision-4.2b+frontend",
                         PHI3V_FRONT_FLASH_SHAPE),
                        ("nemotron-4-340b", NEMOTRON_FLASH_SHAPE),
                        ("nemotron-4-340b:w_up", None),
                        ("nemotron-4-340b:w_down", None),
                        ("gemma-2b@M128", None), ("chatglm3-6b@M128", None),
                        ("xlstm-350m@M128", None), ("zamba2-1.2b@M1", None),
                        ("xlstm-350m@M1", None)):
        # "arch+frontend": the flash pair only; "arch:product": that
        # product only
        label, front, one = arch, "+" in arch, ":" in arch
        # "arch@M128", "arch@M1": its products at that M
        at_m = arch.split("@")[1].lower() if "@" in arch else None
        arch = arch.split("+")[0].split(":")[0].split("@")[0]
        acfg = get_config(arch)

        def want(r):
            s = r["shape"]
            if r["kernel"] != name or (front and not name.startswith("flash")):
                return False
            if at_m:
                return name == "tiered_matmul" and "ms" in r and str(
                    s["product"]).startswith(f"{at_m}:{arch}:")
            if one:
                return (name == "tiered_matmul" and r["dtype"] == "bfloat16"
                        and s["product"] == label)
            if name.startswith("ssd_scan"):
                return (arch == "xlstm-350m" and "ms" in r
                        and (s["B"], s["H"], s["S"], s["N"], s["P"],
                             s["chunk"]) == XLSTM_SSD_SHAPE
                        and s["v_row"] == XLSTM_V_ROW)
            if r["dtype"] != "bfloat16":
                return False
            if name == "decode_attention":
                return ("ms" in r and s["cache_view"] and s["length"] == 160
                        and (s["K"], s["G"], s["D"]) == (
                            acfg.n_kv_heads, acfg.n_heads // acfg.n_kv_heads,
                            acfg.resolved_head_dim))
            if name == "tiered_matmul":
                return str(s["product"]).startswith(arch + ":")
            if name == "tiered_matmul_experts":
                return str(s["product"]).startswith(arch + ":") \
                    and "ms" in r
            if name.startswith("flash"):
                return flash is not None and (
                    s["B"], s["K"], s["G"], s["S"], s["T"],
                    s["D"]) == flash and "ms" in r
            return False
        rows = [r for r in checks if want(r)]
        if not rows:
            continue
        libs = [r["library_ms"] for r in rows]
        entry = dict(
            arch=label, rows=len(rows),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=rows[0]["bound_by"],
            library_ms=None if None in libs else sum(libs))
        if name.startswith("ssd_scan"):
            for key in ("bound_tc_ms", "bytes_bound_ms", "kernels_a_call",
                        "kernel_ms_a_call", "kernel_vs_f64", "plain_vs_f64"):
                if key in rows[0]:
                    entry[key] = rows[0][key]
            entry["parent_ms"] = None
        out.append(entry)
    return out


# Run in a checkout's root: its own chip_smoke.Timer and tiered_matmul
# wrapper on bf16 products (argv[1]: JSON list of [name, M, K, N]); prints
# one JSON list.
_COMPARE_SNIPPET = r"""
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import ops
timer = cs.Timer()
gen = torch.Generator(device="cuda").manual_seed(42)
rows = []
for name, M, K, N in json.loads(sys.argv[1]):
    x = (torch.randn((M, K), generator=gen, device="cuda") * 0.1).bfloat16()
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.1).bfloat16()
    ms = timer(lambda: ops.tiered_matmul(x, w))
    library_ms = timer(lambda: torch.matmul(x, w))
    ops.tiered_matmul(x, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        ops.tiered_matmul(x, w)
    host_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    rows.append(dict(product=name, M=M, K=K, N=N, ms=ms,
                     library_ms=library_ms, host_us=host_us))
print(json.dumps(rows), flush=True)
"""


def _matmul_compare_run(tree: str, prods: list) -> list:
    """_COMPARE_SNIPPET's rows for ``prods`` ([name, M, K, N]) from the
    checkout at ``tree``, in its own process."""
    out = subprocess.run([sys.executable, "-c", _COMPARE_SNIPPET,
                          json.dumps(prods)], cwd=tree, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"tiered_matmul at {tree}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare_matmul(other: str) -> int:
    """``python3 chip_smoke.py --compare-matmul DIR``: the bf16 serving
    products at M = 4 and the dry run's decode products at M = 128
    through this checkout's ``tiered_matmul`` and through that of the
    checkout at DIR (the parent commit, or a variant, unpacked into a
    directory git ignores), each run in its own process from its
    checkout's root, in turns DIR, this, this, DIR: kernel ms (that
    checkout's ``Timer``), ``torch.matmul`` ms beside it, and the wrapper's
    host us a call (host clock over 1,000 calls, no synchronisation in
    between).  Prints one JSON line a run, then the mean of each
    checkout's two runs by product."""
    phase_device()
    gemma, zamba = _path_products()
    prods = ([[n, 4, K, N] for n, K, N in gemma]
             + [["zamba2:" + n, 4, K, N] for n, K, N in zamba]
             + [[n, 128, K, N] for n, K, N in _m128_products()])
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        tree = os.path.abspath(other) if who == "other" else ROOT
        rows = _matmul_compare_run(tree, prods)
        runs[who].append(rows)
        emit(dict(phase="compare_matmul", checkout=who, tree=tree,
                  products=rows))
    summary = []
    for i, row in enumerate(runs["this"][0]):
        item = dict(product=row["product"], M=row["M"], K=row["K"],
                    N=row["N"])
        for who, key in (("other", "other"), ("this", "this")):
            for f in ("ms", "library_ms", "host_us"):
                item[f"{key}_{f}"] = statistics.mean(
                    r[i][f] for r in runs[who])
        summary.append(item)
    emit(dict(phase="compare_matmul_summary", products=summary))
    return 0


def _trace_drop_session(pad, head: str, n: int = 200,
                        gap_us: float = 0) -> dict:
    """One profiling session of ``n`` one-float launches, ``gap_us`` of host
    time apart, after ``head`` ("sleep": 20 ms of host time, else
    nothing): which launches' kernels the trace lost (matched by
    correlation id), and the device stamps' offset from their launches'."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if head == "sleep":
            time.sleep(0.02)
        for _ in range(n):
            pad.add_(1)
            t = time.perf_counter()
            while time.perf_counter() - t < gap_us * 1e-6:
                pass
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    res = prof.profiler.kineto_results
    evs, start = res.events(), res.trace_start_ns()
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    launch = sorted((e.start_ns(), e.correlation_id()) for e in evs
                    if e.device_type() == cpu and "LaunchKernel" in e.name())
    kern = {e.correlation_id(): e.start_ns() for e in evs
            if e.device_type() == gpu}
    seen = [c in kern for _, c in launch]
    first = seen.index(True) if True in seen else len(seen)
    lag = sorted(kern[c] - t for t, c in launch if c in kern)
    return dict(launches=len(launch), kernels=len(kern),
                dropped_at_head=first, dropped=seen.count(False),
                stamp_minus_launch_us=[lag[0] / 1e3, lag[len(lag) // 2] / 1e3]
                if lag else None,
                first_launch_after_start_us=(launch[0][0] - start) / 1e3
                if launch else None)


def trace_drops() -> int:
    """``python3 chip_smoke.py --trace-drops``: 16 rounds in one process,
    each 2 s of matmuls, three short profiling sessions, then three
    sessions of 200 launches: 25 µs apart ("plain"), the same after 20 ms
    of host time ("sleep"), and back to back ("burst"); one JSON line a
    session (see ``_trace_drop_session``)."""
    phase_device()
    x = torch.randn(4096, 4096, device="cuda")
    pad = torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    for i in range(16):
        while time.perf_counter() - t0 < 2 * (i + 1):
            for _ in range(20):
                x @ x
            torch.cuda.synchronize()
        for _ in range(3):
            _trace_drop_session(pad, "", 20)
        for way, head, gap in (("plain", "", 25), ("sleep", "sleep", 25),
                               ("burst", "", 0)):
            emit(dict(phase="trace_drops", round=i, way=way,
                      age_s=time.perf_counter() - t0,
                      **_trace_drop_session(pad, head, 200, gap)))
    return 0


def _hog_host(duty: float, stop: threading.Event) -> None:
    """Hold the interpreter's lock ``duty`` of each 2 ms until ``stop``."""
    while not stop.is_set():
        t = time.perf_counter()
        while time.perf_counter() - t < 0.002 * duty:
            pass
        time.sleep(0.002 * (1.0 - duty) + 1e-6)


def probe_noise() -> int:
    """``python3 chip_smoke.py --probe-noise``: musicgen-large's train_4k
    cell (2 of its fitted microbatches a step, steps and probes profiled)
    three times, with a thread of the process holding the interpreter's
    lock 0, 50 and 100 % of the time; one JSON line each: the measured
    microbatch, the device's busy time and idle share in the steps, and
    the probes' extrapolation a microbatch from their device time and from
    their wall time, with each probe's numbers."""
    phase_device()
    phase_build()
    hbm = torch.cuda.get_device_properties(0).total_memory
    for duty in (0.0, 0.5, 1.0):
        stop = threading.Event()
        hog = threading.Thread(target=_hog_host, args=(duty, stop),
                               daemon=True)
        if duty:
            hog.start()
        _free()
        try:
            rec = dryrun.run_cell("musicgen-large", "train_4k",
                                  hbm_bytes=hbm, steps=2, microbatches_run=2,
                                  profile=_probe_profile,
                                  probe_profile=_probe_profile)
        finally:
            stop.set()
            if duty:
                hog.join()
        ri = rec["roofline_inputs"]
        L1, L2 = ri["probe_layers"]
        p1, p2 = ri["probes"][f"L{L1}"], ri["probes"][f"L{L2}"]
        mb = rec["microbatches"]
        wall = dryrun._extrap(p1["ms"], p2["ms"], L1, L2, rec["n_layers"])
        emit(dict(phase="probe_noise", cell=rec["cell"], mode=rec["mode"],
                  host_lock_duty=duty, ms_a_microbatch=rec["ms_a_microbatch"],
                  ms_per_step=rec["ms_per_step"],
                  device_busy_ms_per_step=rec["profile"][
                      "device_busy_ms_per_step"],
                  device_idle_share=rec["profile"]["device_idle_share"],
                  extrapolated_device_ms_a_microbatch=rec[
                      "ms_a_step_extrapolated"] / mb,
                  extrapolated_wall_ms_a_microbatch=wall,
                  probes={k: dict(ms=p["ms"], ms_per_run=p["ms_per_run"],
                                  device_ms=p["device_ms"],
                                  device_idle_share=p["profile"][
                                      "device_idle_share"])
                          for k, p in ri["probes"].items()}))
    return 0


def slstm_autograd() -> int:
    """``python3 chip_smoke.py --slstm-autograd``: one full-width sLSTM
    layer of xlstm-350m (batch 2 x 2048, bf16 weights from a seed),
    forward and backward on the host clock, twice each: through
    ``slstm_forward`` (the cell's gradient written out) and through the
    cell under plain autograd, each with and without the remat's
    checkpoint; then the largest distance of x's gradient between the two
    (x and its gradient are bf16)."""
    from torch.utils.checkpoint import checkpoint
    phase_device()
    cfg = get_config("xlstm-350m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    blk = {k: t[0].clone().requires_grad_()
           for k, t in xlstm.init_slstm_params(gen, cfg, 1).items()}
    x = torch.randn((2, 2048, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    gy = torch.randn(x.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)

    def cell_loop(p, x, cfg):
        B, S, d = x.shape
        gates = xlstm._gate_inputs(x, p["w_gates"], cfg.n_heads,
                                   torch.matmul)
        r = p["r_gates"].float()
        carry = (gates.new_zeros((B, cfg.n_heads, r.shape[1])),) * 4
        hs = []
        for g_t in gates.unbind(1):
            carry = xlstm._slstm_cell(r, carry, g_t)
            hs.append(carry[0])
        h = torch.stack(hs, 1).reshape(B, S, d).to(x.dtype)
        return torch.matmul(rms_norm(h, p["norm"]), p["out_proj"])

    grads = {}
    for _ in range(2):
        for way, fn in (("function", xlstm.slstm_forward),
                        ("autograd", cell_loop)):
            for remat in (False, True):
                for t in (*blk.values(), x):
                    t.grad = None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = (checkpoint(fn, blk, x, cfg, use_reentrant=False)
                     if remat else fn(blk, x, cfg))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                y.backward(gy)
                torch.cuda.synchronize()
                grads[way] = x.grad.float()
                emit(dict(phase="slstm_autograd", way=way, remat=remat,
                          forward_s=t1 - t0,
                          backward_s=time.perf_counter() - t1))
                del y
    emit(dict(phase="slstm_autograd_grad",
              x_grad_max_abs=grads["autograd"].abs().max().item(),
              function_vs_autograd_max_abs=(
                  grads["function"] - grads["autograd"]).abs().max().item()))
    return 0


# Run in a checkout's root: its own chip_smoke.Timer, SSD forward and SSD
# backward at the zamba2 training shape, decays near 1; prints one JSON
# object.
_SSD_PARENT_SNIPPET = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import ssd_scan as ss
B, H, S, N, P, chunk = cs.SSD_TRAIN_SHAPE
gen = torch.Generator(device="cuda").manual_seed(42)
r = lambda *s: torch.randn(s, generator=gen, device="cuda")
lo, hi = cs.SSD_DECAY_RANGE
a = torch.exp(-(lo + (hi - lo) * torch.rand((B, S, H), generator=gen,
                                            device="cuda"))).transpose(1, 2)
k, q = (r(B, S, N)[:, :, None].expand(B, S, H, N).transpose(1, 2) * 0.3
        for _ in range(2))
v, dy = (r(B, S, H, P) * 0.3).transpose(1, 2), r(B, H, S, P)
y, fin, st = ss.ssd_scan_fwd(a, k, v, q, chunk, save_states=True)
timer = cs.Timer()
fwd = timer(lambda: ss.ssd_scan_fwd(a, k, v, q, chunk, save_states=True), 20)
bwd = timer(lambda: ss.ssd_scan_bwd(a, k, v, q, dy, st, fin, None, chunk,
                                    False), 20)
print(json.dumps(dict(ssd_scan=fwd, ssd_scan_bwd=bwd)), flush=True)
"""


# Run in a checkout's root: its own chip_smoke.Timer over its knapsack DP
# at KNAPSACK_NS items over qcap 16,384 (the check phase's draws); prints
# one JSON object, n: ms.
_KNAPSACK_PARENT_SNIPPET = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import knapsack_dp as kdp
timer = cs.Timer()
out = {}
for i, n in enumerate(cs.KNAPSACK_NS):
    values, qsizes = cs._knapsack_inputs("planner", n, cs.KNAPSACK_QCAP,
                                         10 + i)
    v, s = torch.from_numpy(values).cuda(), torch.from_numpy(qsizes).cuda()
    out[n] = timer(lambda: kdp.knapsack_dp(v, s, cs.KNAPSACK_QCAP))
print(json.dumps(out), flush=True)
"""


def parent_knapsack_ms(other: str) -> dict:
    """``--parent DIR``: the knapsack DP of the checkout at DIR at
    KNAPSACK_NS items over qcap 16,384, timed by that checkout's ``Timer``
    in its own process on this card: {n: ms}."""
    out = subprocess.run([sys.executable, "-c", _KNAPSACK_PARENT_SNIPPET],
                         cwd=os.path.abspath(other), capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the parent's knapsack DP: {out.stderr[-2000:]}")
    ms = json.loads(out.stdout.strip().splitlines()[-1])
    emit(dict(phase="parent_knapsack_dp", tree=other, ms=ms))
    return ms


# Run in a checkout's root: its own chip_smoke.Timer over its decode
# attention's e4m3 route at E4M3_PARENT_SHAPES (the cache view drawn as
# _decode_case draws it); prints one JSON object, label: ms.
_E4M3_PARENT_SNIPPET = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import ops
gen = torch.Generator(device="cuda").manual_seed(42)
timer = cs.Timer()
out = {}
for label, dt, B, K, G, D, T, n in json.loads(sys.argv[1]):
    dt = getattr(torch, dt)
    kc, vc = (cs.kv_cast(torch.randn((B, T, K, D), generator=gen,
                                     device="cuda"), cs.E4M3)
              for _ in range(2))
    k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    q = torch.randn((B, K, G, D), generator=gen, device="cuda").to(dt)
    out[label] = timer(lambda: ops.decode_attention(q, k, v, n))
    del kc, vc, k, v
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""
# the e4m3 route's timed shapes, labelled as _e4m3_shapes labels them:
# (label, q dtype, B, K, G, D, T, length)
E4M3_PARENT_SHAPES = [
    ("gemma-2b:decode_32k", "bfloat16", 128, 1, 8, 256, 32768, 32768),
    ("chatglm3-6b:decode_32k", "bfloat16", 128, 2, 16, 128, 32768, 32768),
    ("gemma-2b:serving:float32", "float32", 4, 1, 8, 256, 1024, 160),
    ("gemma-2b:serving:bfloat16", "bfloat16", 4, 1, 8, 256, 1024, 160)]


def e4m3_ms(tree: str) -> dict:
    """The e4m3 route at E4M3_PARENT_SHAPES through the checkout at
    ``tree``, timed by that checkout's ``Timer`` in its own process on this
    card: {label: ms}."""
    out = subprocess.run([sys.executable, "-c", _E4M3_PARENT_SNIPPET,
                          json.dumps(E4M3_PARENT_SHAPES)],
                         cwd=os.path.abspath(tree), capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the e4m3 route at {tree}: {out.stderr[-2000:]}")
    ms = json.loads(out.stdout.strip().splitlines()[-1])
    emit(dict(phase="parent_e4m3", tree=tree, ms=ms))
    return ms


def parent_m128_ms(other: str) -> dict:
    """``--parent DIR``: the dry run's decode products at M = 128 through
    the ``tiered_matmul`` of the checkout at DIR, timed by that checkout's
    ``Timer`` in its own process on this card: {label: ms}."""
    rows = _matmul_compare_run(os.path.abspath(other), [
        [n, 128, K, N] for n, K, N in _m128_products()])
    ms = {r["product"]: r["ms"] for r in rows}
    emit(dict(phase="parent_m128", tree=other, ms=ms))
    return ms


def parent_ssd_ms(other: str) -> dict:
    """``--parent DIR``: the SSD forward and backward of the checkout at DIR
    (the parent commit, unpacked with ``git archive``) at the zamba2
    training shape, timed by that checkout's ``Timer`` in its own process
    on this card: {"ssd_scan": ms, "ssd_scan_bwd": ms}."""
    out = subprocess.run([sys.executable, "-c", _SSD_PARENT_SNIPPET],
                         cwd=os.path.abspath(other), capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the parent's SSD scan: {out.stderr[-2000:]}")
    ms = json.loads(out.stdout.strip().splitlines()[-1])
    emit(dict(phase="parent_ssd_scan", tree=other, ms=ms))
    return ms


def lr_sweep(arch: str, layers: int, rates) -> int:
    """5 steps of ``train/loop.py`` (batch 2 x 2048, the train phases'
    settings, no profile) of ``arch`` at full width, cut to ``layers``
    (0: its own depth), at each learning rate: one line each with the
    losses, grad norms and step ms.  How the train phases' rates were
    chosen (``SIX_B_TRAIN_LR``, ``XLSTM_TRAIN_LR``, ``MUSICGEN_TRAIN_LR``,
    ``PHI3V_TRAIN_LR``)."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    for lr in rates:
        _free()
        tcfg = TrainConfig(steps=5, global_batch=2, seq_len=2048, lr=lr,
                           remat=True, log_every=1, seed=0,
                           machine=H100_HBM_HOST, device="cuda")
        res = train(cfg, tcfg, AdamWConfig(lr=lr))
        emit(dict(phase="lr_sweep", arch=cfg.name, layers=cfg.n_layers,
                  lr=lr, losses=res.losses, grad_norms=res.grad_norms,
                  ms_per_step=[1e3 * t for t in res.step_times],
                  losses_fall=sum(res.losses[-2:]) / 2 < res.losses[0]))
        del res
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--compare-matmul":
        return compare_matmul(sys.argv[2])
    if sys.argv[1:] == ["--slstm-autograd"]:
        return slstm_autograd()
    if sys.argv[1:] == ["--trace-drops"]:
        return trace_drops()
    if sys.argv[1:] == ["--probe-noise"]:
        return probe_noise()
    if len(sys.argv) >= 5 and sys.argv[1] == "--lr-sweep":
        return lr_sweep(sys.argv[2], int(sys.argv[3]),
                        [float(x) for x in sys.argv[4:]])
    parent = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--parent" \
        else None
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kw):
        """fn(*args, **kw), its wall time added to seconds[name]."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    info = phase_device()
    timed("build", phase_build)
    timer = Timer()
    # the parent's e4m3 route timed before and after this checkout's
    e4m3_parent = [timed("parent", e4m3_ms, parent)] if parent else []
    # ... and its tiered_matmul at M = 128
    m128_parent = [timed("parent", parent_m128_ms, parent)] if parent else []
    checks = timed("check", phase_check, timer)
    timed("check", phase_e4m3_cast)
    parent_ms = timed("parent", parent_ssd_ms, parent) if parent else None
    if parent:
        e4m3_parent.append(timed("parent", e4m3_ms, parent))
        parent_ms["decode_attention_e4m3"] = {
            label: [run[label] for run in e4m3_parent]
            for label in e4m3_parent[0]}
        m128_parent.append(timed("parent", parent_m128_ms, parent))
        parent_ms["tiered_matmul@M128"] = m128_parent
        parent_ms["knapsack_dp"] = timed("parent", parent_knapsack_ms,
                                         parent)
    timed("runtime", phase_runtime, timer)
    for arch, heads, head_dim in (
            ("gemma-2b", None, None), ("zamba2-1.2b", None, None),
            ("yi-6b", None, None), ("yi-6b", 8, None),
            ("chatglm3-6b", None, None), ("chatglm3-6b", 16, None),
            ("xlstm-350m", None, None), ("xlstm-350m", 1, None),
            ("moonshot-v1-16b-a3b", None, None), ("dbrx-132b", None, None),
            ("dbrx-132b", 6, None), ("musicgen-large", None, None),
            ("phi-3-vision-4.2b", None, None), ("nemotron-4-340b", None, None),
            ("nemotron-4-340b", 12, None),
            # the real head widths inside the model: phi-3-vision-4.2b's D
            # 96 and nemotron-4-340b's D 192 at its real G 12
            ("phi-3-vision-4.2b", None, 96), ("nemotron-4-340b", 12, 192)):
        timed("parity", phase_parity, arch, heads, head_dim)
    timed("sim", phase_sim)
    planner = timed("planner", phase_planner)
    dryrun_paths = timed("dryrun", phase_dryrun)
    paths = [
        timed("serve", phase_serve, "gemma-2b", "serve"),
        timed("train", phase_train, "gemma-2b", 2048, "train"),
        timed("serve_zamba2", phase_serve, "zamba2-1.2b", "serve_zamba2",
              EARLIER_SERVE_LAYERS["zamba2-1.2b"]),
        timed("train_zamba2", phase_train, "zamba2-1.2b", 4096,
              "train_zamba2"),
        timed("serve_yi", phase_serve, "yi-6b", "serve_yi",
              EARLIER_SERVE_LAYERS["yi-6b"]),
        timed("train_yi", phase_train, "yi-6b", 2048, "train_yi",
              SIX_B_TRAIN_LAYERS, SIX_B_TRAIN_LR),
        timed("serve_chatglm3", phase_serve, "chatglm3-6b", "serve_chatglm3",
              EARLIER_SERVE_LAYERS["chatglm3-6b"]),
        timed("train_chatglm3", phase_train, "chatglm3-6b", 2048,
              "train_chatglm3", SIX_B_TRAIN_LAYERS, SIX_B_TRAIN_LR),
        timed("serve_xlstm", phase_serve, "xlstm-350m", "serve_xlstm",
              EARLIER_SERVE_LAYERS["xlstm-350m"]),
        # one profiled step: the sLSTM's loop is ~10^5 launches a step
        timed("train_xlstm", phase_train, "xlstm-350m", 2048, "train_xlstm",
              XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_LR, rerun=True,
              profile_steps=1),
        timed("serve_moonshot", phase_serve, "moonshot-v1-16b-a3b",
              "serve_moonshot", EARLIER_SERVE_LAYERS["moonshot-v1-16b-a3b"]),
        timed("serve_dbrx", phase_serve, "dbrx-132b", "serve_dbrx",
              DBRX_SERVE_LAYERS),
        timed("train_moonshot", phase_train, "moonshot-v1-16b-a3b", 2048,
              "train_moonshot", MOE_TRAIN_LAYERS, MOE_TRAIN_LR, rerun=True),
        timed("serve_musicgen", phase_serve, "musicgen-large",
              "serve_musicgen"),
        timed("train_musicgen", phase_train, "musicgen-large", 2048,
              "train_musicgen", lr=MUSICGEN_TRAIN_LR),
        timed("serve_phi3v", phase_serve, "phi-3-vision-4.2b", "serve_phi3v"),
        timed("train_phi3v", phase_train, "phi-3-vision-4.2b", 2048,
              "train_phi3v", PHI3V_TRAIN_LAYERS, PHI3V_TRAIN_LR),
        timed("serve_nemotron", phase_serve, "nemotron-4-340b",
              "serve_nemotron", NEMOTRON_SERVE_LAYERS),
        timed("distributed", phase_distributed), planner] + dryrun_paths
    emit(dict(phase="seconds", by_phase=seconds))
    line = kernel_line(checks, paths, parent_ms)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
