#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py
  python3 chip_smoke.py --parent DIR
  python3 chip_smoke.py --compare-matmul DIR
  python3 chip_smoke.py --slstm-autograd
  python3 chip_smoke.py --trace-drops

Drives the port's main path on the card and fails (non-zero exit, no
result line) if any phase fails:

1. device   -- the card (nvidia-smi name and power limit), torch and CUDA;
2. build    -- the six kernels compiled from ``src/repro_torch/csrc`` with
               nvcc for sm_90a, all at once, with the ptxas report
               (decode_attention, tiered_matmul, ssd_scan and ssd_scan_bwd
               compiled in every run, so that their reports are there to
               read: no spill, required), each bf16 flash kernel's HGMMA
               count and the SSD forward's and backward's HMMA (TF32, the
               chunk kernels) and DMMA (fp64, the sums kernels) counts
               (required);
3. check    -- each kernel against its plain PyTorch version at the
               reference tests' shapes and the serving and training
               shapes of gemma-2b, zamba2-1.2b, yi-6b, chatglm3-6b,
               xlstm-350m (the SSD kernels' wide route; v's rows as the
               model pads them, and unpadded), moonshot-v1-16b-a3b and
               dbrx-132b (decode at G 1 and 6, the flash pair at G 6, the
               attention and shared-expert products, and tiered_matmul's
               expert route at both models' decode shapes and edge
               cases: every row on one expert, experts no row picks),
               with kernel / plain /
               bound / library times and the launch floor (an empty
               kernel); the flash-attention and SSD-scan backward kernels
               against autograd through the plain forward, the SSD one's
               d(log a) against float64 with decays near 1; the SSD
               forward and backward each the same bits from a second call;
               decode attention, tiered_matmul and the SSD forward and
               backward also behind a NaN fill of shared memory;
               tiered_matmul with the route and plan each shape took, the
               same bits from a second call, and the wrapper's host time a
               call;
4. runtime  -- the Unimem runtime moving real tensors between HBM and
               pinned host memory (``backend="torch_async"``), bytes checked,
               plus host<->device copy rates for 1, 2 and 4 channels;
5. parity   -- reduced gemma-2b, zamba2-1.2b, yi-6b, chatglm3-6b,
               xlstm-350m, moonshot-v1-16b-a3b and dbrx-132b, fp32 weights,
               the card against the CPU; yi-6b, chatglm3-6b and dbrx-132b
               also at their real G (8, 16 and 6 query heads over one KV
               head), xlstm-350m also at one head (N 128, P 129: the SSD
               forward's wide route);
6. sim      -- the discrete-event simulator on the card's host: the
               quickstart's CG workload DRAM-only, NVM-only and under
               Unimem, twice (same plan digest and iteration times), and
               the planner's wall time on each (re)plan;
7. serve    -- full-width gemma-2b (18 layers, d_model 2048, vocab 256000)
               served under the runtime, with every kernel launch counted;
8. train    -- full-width gemma-2b trained for 5 steps (batch 2 x 2048
               tokens, AdamW, per-layer remat) through ``train/loop.py``
               under the runtime, with every kernel launch counted;
9. serve_zamba2 -- full-width zamba2-1.2b (38 Mamba-2 layers, a shared
               attention block every 6, d_model 2048) served the same way;
10. train_zamba2 -- full-width zamba2-1.2b trained for 5 steps of batch
               2 x 4096 tokens (16 chunks of the SSD scan a sequence);
11. serve_yi, serve_chatglm3 -- full-width, full-depth yi-6b (32 layers,
               d_model 4096, 32 heads over 4 KV heads of 128, SwiGLU 11008)
               and chatglm3-6b (28 layers, 32 heads over 2 KV heads, qkv
               bias, half-dim rotary, SwiGLU 13696) served as gemma-2b is;
12. train_yi, train_chatglm3 -- the same at full width, cut to 8 layers
               (the whole model's training state does not fit 80 GB),
               trained as gemma-2b is;
13. serve_xlstm, train_xlstm -- full-width, full-depth xlstm-350m (24
               layers: 21 mLSTM with a 512 x 513 state a head, 3 sLSTM;
               d_model 1024) served as gemma-2b is, and trained for 5 steps
               of batch 2 x 2048 twice (the same losses, bit for bit);
14. serve_moonshot, serve_dbrx, train_moonshot -- full-width,
               full-depth moonshot-v1-16b-a3b (48 layers of 64 experts,
               top-6, 2 shared) and dbrx-132b cut to 8 of its 40 layers (16
               experts, top-4, layer norm, G 6: 263 GB of weights fit no
               tier) served as gemma-2b is, each routed product one launch
               of the expert route; moonshot cut to 4 layers trained for 5
               steps of batch 2 x 2048 twice (the same losses, bit for bit:
               the dispatch is deterministic);
15. kernels -- one line with each kernel's numbers.

Each phase prints one JSON object; the last line is the device object.
``--parent DIR`` also times the SSD forward and backward of the checkout
at DIR (the parent commit) in this run and puts them in the kernels line.
The serve phases require every product of a decode step to be one launch
of the tensor-core matmul kernel (the MoE layers' routed products one of
its expert route), and report device operations a step.
``--compare-matmul DIR`` only times the serving products through this
checkout's tiered_matmul and through that of the checkout at DIR (see
``compare_matmul``); ``--slstm-autograd`` only times one sLSTM layer's
forward and backward with and without its written-out gradient (see
``slstm_autograd``); ``--trace-drops`` only counts the kernels that
torch.profiler's trace loses at a session's head (see ``trace_drops``).
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
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the training phase holds ~40 GB of state beside multi-GB transients
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch import _tree, sim  # noqa: E402
from repro_torch.core import (H100_HBM_HOST, PAPER_DRAM_NVM,  # noqa: E402
                              ManualSource, ObjectRegistry, RuntimeConfig,
                              UnimemRuntime, calibrate)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, fill_shared_memory_nan)
from repro_torch.kernels.ref import decode_attention_f64  # noqa: E402
from repro_torch.kernels import tiered_matmul as mm  # noqa: E402
from repro_torch.models import lm, moe, xlstm  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update,  # noqa: E402
                               init_opt_state)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402
from repro_torch.train.step import (build_grads_step,  # noqa: E402
                                    build_train_step)

MB = 1024 ** 2
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BW = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
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
KERNELS = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
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
TIMED_FLASH_SHAPES = (TRAIN_SHAPE, ZAMBA_FLASH_SHAPE, YI_FLASH_SHAPE,
                      GLM_FLASH_SHAPE, DBRX_FLASH_SHAPE)
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
    "tiered_matmul": {"tiered_mma_kernel": "HMMA",
                      "tiered_experts_mma_kernel": "HMMA"},
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
NO_SPILL = ("decode_attention", "tiered_matmul", "ssd_scan", "ssd_scan_bwd")


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
                 peak=1.0, against="plain", stale_nan=False):
    """The kernel against its plain version (``against="plain"``) or the
    same attention in float64 (``"float64"``), on q scaled by ``peak``
    (8: peaked scores, so the running max moves between tiles); with
    ``stale_nan``, every SM's shared memory is filled with NaN just before
    the kernel, so a read of shared memory it did not write shows; timed
    beside the plain version and SDPA unless ``timer`` is None."""
    if cache_view:      # one layer of the serving cache, (B, T, K, D)
        kc = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        vc = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    else:
        k = torch.randn((B, K, T, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, K, T, D), generator=gen, device="cuda").to(dtype)
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
    err, ok = _compare(out, want, dtype)
    row = dict(
        phase="check", kernel="decode_attention", dtype=str(dtype)[6:],
        shape=dict(B=B, K=K, G=G, D=D, T=T, length=length,
                   cache_view=cache_view, peak=peak, stale_nan=stale_nan),
        against=against, max_abs_err=err, tol=TOL[dtype], ok=ok)
    if timer is None:
        return row
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * K * G * D + 2 * B * K * length * D) * size
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes, 4.0 * B * K * G * length * D, dtype)
    row["library_ms"] = None
    if length:
        kl, vl = k[:, :, :length], v[:, :, :length]
        row["library_ms"] = timer(
            lambda: F.scaled_dot_product_attention(q, kl, vl))
    row["ms"] = timer(lambda: ops.decode_attention(q, k, v, length))
    row["plain_ms"] = timer(lambda: decode_attention_plain(q, k, v, length))
    return row


# Decode shapes whose lanes own 16-byte chunks past D, which the kernel
# never copies into its ring: fp32 at D <= 128 (a lane's second chunk) and
# at D = 160, bf16 where D / 8 is no power of 2 (D 96, 160); zamba2's
# shape in fp32 among them.  (dtype, B, K, G, D, length)
STALE_SHARED_CASES = [
    (torch.float32, 4, 32, 1, 64, 160), (torch.float32, 2, 2, 16, 128, 161),
    (torch.float32, 2, 1, 4, 16, 37), (torch.float32, 2, 2, 4, 160, 161),
    (torch.bfloat16, 2, 2, 4, 96, 161), (torch.bfloat16, 2, 2, 4, 160, 33),
    (torch.bfloat16, 4, 1, 8, 96, 1024)]


def _stale_shared_cases(gen) -> list:
    """The decode kernel behind a NaN fill of every SM's shared memory, at
    the shapes of STALE_SHARED_CASES, against its plain version."""
    return [_decode_case(None, dt, B, K, G, D, 1024, length, True, gen,
                         stale_nan=True)
            for dt, B, K, G, D, length in STALE_SHARED_CASES]


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


def _matmul_case(timer, dtype, M, K, N, gen, name=None, stale_nan=False):
    """The kernel against its plain version, with the route and plan the
    wrapper chose; the same inputs again must give the same bits (the K
    split is merged in a fixed order); with ``stale_nan`` every SM's shared
    memory is filled with NaN just before the kernel, so a ring slot read
    before its copy lands shows.  Timed beside the plain version and
    ``torch.matmul``, with the wrapper's host time a call, unless
    ``timer`` is None."""
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
        ok=ok and same)
    if timer is None:
        return row
    size = x.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(
        (M * K + K * N + M * N) * size, 2.0 * M * N * K, dtype)
    row["ms"] = timer(lambda: ops.tiered_matmul(x, w))
    row["plain_ms"] = timer(lambda: mm.tiered_matmul_plain(x, w))
    row["library_ms"] = timer(lambda: torch.matmul(x, w))
    row["host_us"] = _host_us(lambda: ops.tiered_matmul(x, w))
    return row


# tiered_matmul shapes checked untimed: the card tests' smallest and most
# ragged ones; M = 1, 4, 8 and 9 (one block of 8 rows of x, and two) at
# gemma-2b's w_down and zamba2-1.2b's in_proj; K not a multiple of the
# ring's 64-row stage, one of them under one stage, one whose K splits
# (2560 rows) outgrow the kernel's 2048-k window of x; N a multiple of 8
# but not of 64.  (M, K, N)
MATMUL_EDGE_CASES = [
    (1, 3, 5), (5, 100, 13),
    *((M, 16384, 2048) for M in (1, 4, 8, 9)),
    *((M, 2048, 8384) for M in (1, 4, 8, 9)),
    (4, 2000, 2048), (3, 100, 264), (3, 40, 264), (4, 20000, 2048)]
# tiered_matmul shapes run behind a NaN fill of shared memory (bf16, the
# "mma" route): zamba2's in_proj, whose last tile loads one box of its 4,
# and a ragged K and N.  (M, K, N)
MATMUL_STALE_CASES = [(4, 2048, 8384), (3, 100, 264)]


def _matmul_edge_cases(gen) -> list:
    rows = [_matmul_case(None, dt, M, K, N, gen)
            for dt in (torch.float32, torch.bfloat16)
            for M, K, N in MATMUL_EDGE_CASES]
    return rows + [_matmul_case(None, torch.bfloat16, M, K, N, gen,
                                stale_nan=True)
                   for M, K, N in MATMUL_STALE_CASES]


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
    route = mm.route(x, w[0])
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
    and a missing rescale shows).  Float64 columns and times at the two
    training shapes only."""
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
    if (B, K, G, S, T, D) in TIMED_FLASH_SHAPES:
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
    """One attention layer's 7 products of a dense config, (name, K, N)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    return [("wq", d, cfg.n_heads * hd), ("wk", d, cfg.n_kv_heads * hd),
            ("wv", d, cfg.n_kv_heads * hd), ("wo", cfg.n_heads * hd, d),
            ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]


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
                # peaked scores (q x 8): the running max moves
                (1, 1, 8, 300, 300, 256, True, 8.0),
                (1, 32, 1, 512, 512, 64, True, 8.0),
                (1, 2, 4, 128, 300, 128, False, 8.0),
                (1, 2, 16, 300, 300, 128, True, 8.0),
                (1, 2, 6, 300, 300, 128, True, 8.0),
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
    for r in rows:
        if r["kernel"] == "decode_attention" and "ms" in r:
            r["launch_floor_ms"] = floor_ms
    # zamba2's shared attention in training, then yi-6b's, chatglm3-6b's
    # and dbrx-132b's attention, bf16 as the paths run them
    for shape in (ZAMBA_FLASH_SHAPE, YI_FLASH_SHAPE, GLM_FLASH_SHAPE,
                  DBRX_FLASH_SHAPE):
        rows += _flash_case(timer, torch.bfloat16, *shape, True, gen)
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


def phase_parity(arch: str, heads: int = None) -> dict:
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
    forward's wide route (``reduced()`` gives N 32, P 33)."""
    cfg = get_config(arch).reduced()
    if heads is not None:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-g{heads}",
                                  n_heads=heads, n_kv_heads=1)
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
    res = dict(phase="parity", arch=cfg.name, params="float32",
               G=cfg.n_heads // cfg.n_kv_heads, D=cfg.resolved_head_dim,
               tokens_identical=same, logits_max_abs_err=dec["logits"],
               generate_launches=generate_launches,
               tol=(ZAMBA_DECODE_TOL if hybrid else
                    MOE_DECODE_TOL if cfg.is_moe else PARITY_TOL),
               forward_tol=PARITY_TOL)
    if cfg.is_moe:
        res["decode_fp32_kv_logits_max_abs_err"] = _decode_errors(
            cfg, cpu, gpu, prompts, S, kv=torch.float32)["logits"]
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
    emit(res)
    require(same, "greedy tokens identical on card and CPU")
    require(res["logits_max_abs_err"] <= res["tol"], "logits within tolerance")
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
    if cfg.is_moe:
        require(res["decode_fp32_kv_logits_max_abs_err"] <= PARITY_TOL,
                "with an fp32 KV cache, decode logits within PARITY_TOL")
        require(generate_launches["tiered_matmul_experts"]
                == 3 * cfg.n_layers * (P + n_new),
                "every routed product of the card's decode ran the expert "
                f"route ({generate_launches})")
    require(res["forward_logits_max_abs_err"] <= PARITY_TOL,
            "forward logits within tolerance")
    return res


def _expected_launches(cfg, path: str, steps: int) -> dict:
    """Exact launches of each kernel entry point on a path.  serve: per
    decode step, gemma-2b 18 decode attentions and 7 x 18 products; zamba2
    7 decode attentions (the shared block's applications) and 2 x 38 + 7 x 7
    products; yi-6b 32 and 7 x 32, chatglm3-6b 28 and 7 x 28 (serve_yi,
    serve_chatglm3).  train: per step, every layer's forward twice (remat)
    and its backward once: gemma-2b 36 + 18 flash launches; zamba2 14 + 7
    flash and 76 + 38 SSD launches, 380 and 190 over 5 steps; yi-6b and
    chatglm3-6b cut to 8 layers 16 + 8 (train_yi, train_chatglm3).
    xlstm-350m (21 mLSTM, 3 sLSTM layers): serve 3 x 21 + 2 x 3 = 69
    products a step and no attention or SSD launch; train 42 + 21 SSD
    launches a step, 210 and 105 over 5 steps, and no flash launch.  MoE:
    serve per layer and step one decode attention, 4 attention products
    and 3 shared-expert ones (none for dbrx) through tiered_matmul and the
    3 routed products through its expert route: moonshot-v1-16b-a3b 48,
    336 and 144 a step, dbrx-132b at 8 layers 8, 32 and 24; train as a
    dense config (the experts' products go to torch.matmul), moonshot at
    4 layers 8 + 4 flash launches a step."""
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
        counts["tiered_matmul"] = (7 * attn + mamba) * steps
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
    between the two markers count."""
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
    by_group, calls_by_group = {}, {}
    for name, (t, c) in by_name.items():
        g = next((g for g, keys in (groups or {}).items()
                  if any(k in name for k in keys)), "other")
        by_group[g] = by_group.get(g, 0.0) + t / 1e3 / steps
        calls_by_group[g] = calls_by_group.get(g, 0) + c / steps
    return dict(
        ms_per_step_by_group=by_group, calls_per_step_by_group=calls_by_group,
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
# products run only the tensor-core kernel, one launch a call: the FFMA
# route and the old split-K sum kernel must not appear
SERVE_GROUPS = {
    "decode_attention": ["::decode_kernel<"],
    "tiered_matmul": ["::tiered_mma_kernel("],
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
    cuts the depth (the row says so under ``reduced``)."""
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
                   "card's 80 GB nor the 108 GB host tier"),
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
            and not calls.get("splitk_sum"),
            "every product of a decode step is one tensor-core launch "
            f"({calls})")
    require(res["repeat_identical"], "a repeated request gives the same tokens")
    require(res["logits_finite"] and res["logits_shape"] == [B, cfg.vocab_size],
            "finite logits of shape (batch, vocab)")
    require(all(o.shape == (B, P + n_new) for o in outs), "output shapes")
    require(plan is not None and plan_objs
            and all(o.startswith("t0/") for o in plan_objs)
            and rt.phase_names() == ["t0/prefill", "t0/decode"],
            "the runtime planned the tenant's objects and phases")
    return res


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
                   "parameter, does not fit the card's 80 GB"),
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
    print(json.dumps(res_row, default=str), flush=True)
    losses = res_row["losses"]
    require(all(math.isfinite(x) for x in losses), "every loss finite")
    require(sum(losses[-2:]) / 2 < losses[0],
            "the mean of the last two losses is below the first")
    require(launches == expect, f"launch counts {launches} == {expect}")
    require(again is None or again == losses,
            f"a second run gives the same losses ({again} == {losses})")
    reg = res_row["runtime"]["registered"]
    require(res_row["runtime"]["phases"] == ["data", "step", "ckpt"]
            and "opt_state" in planned and "opt_state" in reg
            and reg.get("params", {}).get("pinned"),
            "the runtime planned opt_state (params pinned) over the "
            "phases data, step, ckpt")
    return res_row


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
    run."""
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
        if row["library_ms"] is None:
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
        row["shapes"] = _arch_shapes(checks, name)
        out.append(row)
    return {"kernels": out}


def _arch_shapes(checks, name) -> list:
    """A kernel's times at yi-6b's and chatglm3-6b's shapes, bf16: decode
    at length 160 over the (4, 1024, K, 128) cache view, a layer's 7
    products at M = 4 summed, the flash pair at the training shapes; at
    xlstm-350m's: its 5 decode products at M = 4 (bf16) summed, the SSD
    pair at its training shape (fp32, decays near 1, v's rows padded as
    the model pads them); at moonshot-v1-16b-a3b's and dbrx-132b's: decode
    (G 1 and 6), a layer's attention and shared-expert products and its 3
    routed products (the expert route, batch 4) summed, and dbrx's flash
    pair at G 6."""
    out = []
    for arch, flash in (("yi-6b", YI_FLASH_SHAPE),
                        ("chatglm3-6b", GLM_FLASH_SHAPE),
                        ("xlstm-350m", None),
                        ("moonshot-v1-16b-a3b", None),
                        ("dbrx-132b", DBRX_FLASH_SHAPE)):
        acfg = get_config(arch)

        def want(r):
            s = r["shape"]
            if r["kernel"] != name:
                return False
            if name.startswith("ssd_scan"):
                return (arch == "xlstm-350m" and "ms" in r
                        and (s["B"], s["H"], s["S"], s["N"], s["P"],
                             s["chunk"]) == XLSTM_SSD_SHAPE
                        and s["v_row"] == XLSTM_V_ROW)
            if r["dtype"] != "bfloat16":
                return False
            if name == "decode_attention":
                return (s["cache_view"] and s["length"] == 160
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
            arch=arch, rows=len(rows),
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
# wrapper on the serving products at M = 4 in bf16 (argv[1]: JSON list of
# [name, K, N]); prints one JSON list.
_COMPARE_SNIPPET = r"""
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import ops
timer = cs.Timer()
gen = torch.Generator(device="cuda").manual_seed(42)
rows = []
for name, K, N in json.loads(sys.argv[1]):
    x = (torch.randn((4, K), generator=gen, device="cuda") * 0.1).bfloat16()
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
    rows.append(dict(product=name, K=K, N=N, ms=ms, library_ms=library_ms,
                     host_us=host_us))
print(json.dumps(rows), flush=True)
"""


def compare_matmul(other: str) -> int:
    """``python3 chip_smoke.py --compare-matmul DIR``: the bf16 serving
    products at M = 4 through this checkout's ``tiered_matmul`` and
    through that of the checkout at DIR (the parent commit, unpacked with
    ``git archive``), each run in its own process from its checkout's
    root, in turns DIR, this, this, DIR: kernel ms (that checkout's
    ``Timer``), ``torch.matmul`` ms beside it, and the wrapper's host us a
    call (host clock over 1,000 calls, no synchronisation in between).
    Prints one JSON line a run, then the mean of each checkout's two runs
    by product."""
    phase_device()
    gemma, zamba = _path_products()
    prods = json.dumps([[n, K, N] for n, K, N in gemma]
                       + [["zamba2:" + n, K, N] for n, K, N in zamba])
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        tree = os.path.abspath(other) if who == "other" else ROOT
        out = subprocess.run([sys.executable, "-c", _COMPARE_SNIPPET, prods],
                             cwd=tree, capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        runs[who].append(rows)
        emit(dict(phase="compare_matmul", checkout=who, tree=tree,
                  products=rows))
    summary = []
    for i, row in enumerate(runs["this"][0]):
        item = dict(product=row["product"], K=row["K"], N=row["N"])
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
    parent = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--parent" \
        else None
    t0 = time.perf_counter()
    info = phase_device()
    phase_build()
    timer = Timer()
    checks = phase_check(timer)
    parent_ms = parent_ssd_ms(parent) if parent else None
    phase_runtime(timer)
    phase_parity("gemma-2b")
    phase_parity("zamba2-1.2b")
    for arch, heads in (("yi-6b", None), ("yi-6b", 8), ("chatglm3-6b", None),
                        ("chatglm3-6b", 16), ("xlstm-350m", None),
                        ("xlstm-350m", 1), ("moonshot-v1-16b-a3b", None),
                        ("dbrx-132b", None), ("dbrx-132b", 6)):
        phase_parity(arch, heads)
    phase_sim()
    paths = [phase_serve("gemma-2b", "serve"),
             phase_train("gemma-2b", 2048, "train"),
             phase_serve("zamba2-1.2b", "serve_zamba2"),
             phase_train("zamba2-1.2b", 4096, "train_zamba2"),
             phase_serve("yi-6b", "serve_yi"),
             phase_train("yi-6b", 2048, "train_yi", SIX_B_TRAIN_LAYERS,
                         SIX_B_TRAIN_LR),
             phase_serve("chatglm3-6b", "serve_chatglm3"),
             phase_train("chatglm3-6b", 2048, "train_chatglm3",
                         SIX_B_TRAIN_LAYERS, SIX_B_TRAIN_LR),
             phase_serve("xlstm-350m", "serve_xlstm"),
             # one profiled step: the sLSTM's loop is ~10^5 launches a step
             phase_train("xlstm-350m", 2048, "train_xlstm", lr=XLSTM_TRAIN_LR,
                         rerun=True, profile_steps=1),
             phase_serve("moonshot-v1-16b-a3b", "serve_moonshot"),
             phase_serve("dbrx-132b", "serve_dbrx", DBRX_SERVE_LAYERS),
             phase_train("moonshot-v1-16b-a3b", 2048, "train_moonshot",
                         MOE_TRAIN_LAYERS, MOE_TRAIN_LR, rerun=True)]
    line = kernel_line(checks, paths, parent_ms)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
