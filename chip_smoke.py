#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py
  python3 chip_smoke.py --compare-matmul DIR

Drives the port's main path on the card and fails (non-zero exit, no
result line) if any phase fails:

1. device   -- the card (nvidia-smi name and power limit), torch and CUDA;
2. build    -- the six kernels compiled from ``src/repro_torch/csrc`` with
               nvcc for sm_90a, all at once, with the ptxas report
               (decode_attention and tiered_matmul compiled in every run,
               so that their reports are there to read: no spill,
               required) and each bf16 flash kernel's HGMMA count
               (required);
3. check    -- each kernel against its plain PyTorch version at the
               reference tests' shapes and the serving and training
               shapes of gemma-2b and zamba2-1.2b, with kernel / plain /
               bound / library times and the launch floor (an empty
               kernel); the flash-attention and SSD-scan backward kernels
               against autograd through the plain forward, the SSD one's
               d(log a) against float64 with decays near 1; decode
               attention and tiered_matmul also behind a NaN fill of
               shared memory; tiered_matmul with the route and plan each
               shape took, the same bits from a second call, and the
               wrapper's host time a call;
4. runtime  -- the Unimem runtime moving real tensors between HBM and
               pinned host memory (``backend="torch_async"``), bytes checked,
               plus host<->device copy rates for 1, 2 and 4 channels;
5. parity   -- reduced gemma-2b and zamba2-1.2b, fp32 weights, the card
               against the CPU;
6. serve    -- full-width gemma-2b (18 layers, d_model 2048, vocab 256000)
               served under the runtime, with every kernel launch counted;
7. train    -- full-width gemma-2b trained for 5 steps (batch 2 x 2048
               tokens, AdamW, per-layer remat) through ``train/loop.py``
               under the runtime, with every kernel launch counted;
8. serve_zamba2 -- full-width zamba2-1.2b (38 Mamba-2 layers, a shared
               attention block every 6, d_model 2048) served the same way;
9. train_zamba2 -- full-width zamba2-1.2b trained for 5 steps of batch
               2 x 4096 tokens (16 chunks of the SSD scan a sequence);
10. kernels -- one line with each kernel's numbers.

Each phase prints one JSON object; the last line is the device object.
The serve phases require every product of a decode step to be one launch
of the tensor-core matmul kernel, and report device operations a step.
``--compare-matmul DIR`` only times the serving products through this
checkout's tiered_matmul and through that of the checkout at DIR (see
``compare_matmul``).
Times are CUDA-event times over many queued launches (median), each
behind a device-side sleep so that no host delay falls inside a timed
pair, with the L2 cache flushed before each launch, since the serving and
training paths find weights, cache and activations cold.  Needs one CUDA card and nvcc; it stops at once without them.
"""

import gc
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
from repro_torch.core import (H100_HBM_HOST, ManualSource,  # noqa: E402
                              RuntimeConfig, UnimemRuntime)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, fill_shared_memory_nan)
from repro_torch.kernels.ref import decode_attention_f64  # noqa: E402
from repro_torch.kernels import tiered_matmul as mm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
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
KERNELS = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:65"),
    "tiered_matmul": ("src/repro_torch/csrc/tiered_matmul.cu",
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
TRAIN_SHAPE = (2, 1, 8, 2048, 2048, 256)       # B, K, G, S, T, D
# zamba2-1.2b's training step (batch 2 x 4096): the shared block's
# attention (32 heads over 32 KV heads of 64) and the SSD scan (64 heads,
# N = P = 64, chunks of 256, k and q broadcast over the heads)
ZAMBA_FLASH_SHAPE = (2, 32, 1, 4096, 4096, 64)
SSD_TRAIN_SHAPE = (2, 64, 4096, 64, 64, 256)   # B, H, S, N, P, chunk


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


# The bf16 flash kernels, by name, and the tensor-core instruction each
# instantiation must run: wgmma (HGMMA) or mma.sync (HMMA).
TENSOR_CORE_KERNELS = {
    "flash_attention": {"flash_fwd_wgmma": "HGMMA"},
    "flash_attention_bwd": {"dq_wgmma": "HGMMA", "dkdv_wgmma": "HGMMA"}}


def _sass_counts(name: str) -> dict:
    """HGMMA and HMMA instructions in each bf16 flash kernel of a built
    library, from ``cuobjdump --dump-sass``."""
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
                counts[fn] = dict(HGMMA=0, HMMA=0)
        elif fn:
            op = "HGMMA" if "HGMMA" in line else "HMMA" if "HMMA" in line \
                else None
            if op:
                counts[fn][op] += 1
    return counts


# kernels whose ptxas report is required in every run, with no spill
NO_SPILL = ("decode_attention", "tiered_matmul")


def phase_build() -> None:
    t0 = time.perf_counter()
    # decode_attention and tiered_matmul compiled even when their
    # libraries exist, so that their ptxas reports are read in every run
    reports = build.build(list(KERNELS),
                          fresh=["decode_attention", "tiered_matmul"])
    for name in KERNELS:
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
    if (B, K, G, S, T, D) in (TRAIN_SHAPE, ZAMBA_FLASH_SHAPE):
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
    the inter-chunk products and the state update."""
    pairs = sum(q * (q + 1) // 2
                for q in (min(chunk, S - s0) for s0 in range(0, S, chunk)))
    fwd = B * H * (pairs * 2 * (N + P) + S * 4 * N * P)
    bwd = B * H * (pairs * 2 * (2 * P + 3 * N) + S * 8 * N * P)
    return float(fwd), float(bwd)


def _ssd_case(timer, B, H, S, N, P, chunk, bcast, decay, gen) -> list:
    """Forward kernel against the plain forward (y, final state, chunk
    states) and backward kernel against autograd through the plain
    forward, with an initial state and a final-state gradient; in the
    model's layout, (B, S, H, .) seen as (B, H, S, .), k and q broadcast
    over H where ``bcast``; decays ``decay`` ("strong" or "near1", see
    SSD_DECAY_RANGE).  Float64 columns at the training shape; timed there
    with decays near 1 only."""
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
    v = r(B, S, H, P) * 0.3
    a, k, v, q = (t.transpose(1, 2) for t in (a, k, v, q))
    s0, dy, dfin = r(B, H, N, P) * 0.3, r(B, H, S, P), r(B, H, N, P)
    y, fin, states = ssd.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    grads = ssd.ssd_scan_bwd(a, k, v, q, dy, states, fin, dfin, chunk, True)
    leaves = [t.detach().clone().requires_grad_() for t in (a, k, v, q, s0)]
    py, pfin, pstates = ssd._plain_forward(*leaves[:4], chunk, leaves[4])
    want = torch.autograd.grad([py, pfin], leaves, [dy, dfin])
    torch.cuda.synchronize()
    errs = [_compare(x, w.detach(), torch.float32, {torch.float32: SSD_TOL})
            for x, w in ((y, py), (fin, pfin), (states, pstates))]
    # d(log a) = da * a for the decays; dk, dq per head
    g_cmp = [(g * a if i == 0 else g, w * a if i == 0 else w)
             for i, (g, w) in enumerate(zip(grads, want))]
    if decay == "near1":    # d(log a) against the float64 plain version
        g_cmp[0] = (g_cmp[0][0].double(),
                    _ssd_grads(torch.float64, a, k, v, q, s0, dy, dfin,
                               chunk)[0])
    g_err = [_compare(g, w, torch.float32, {torch.float32: SSD_TOL})
             for g, w in g_cmp]
    shape = dict(B=B, H=H, S=S, N=N, P=P, chunk=chunk, bcast=bcast,
                 decay=decay)
    fwd = dict(phase="check", kernel="ssd_scan", dtype="float32", shape=shape,
               max_abs_err=max(e for e, _ in errs),
               y_final_states_max_abs_err=[e for e, _ in errs],
               tol=SSD_TOL, ok=all(o for _, o in errs))
    bwd = dict(phase="check", kernel="ssd_scan_bwd", dtype="float32",
               shape=shape, max_abs_err=max(e for e, _ in g_err),
               dloga_dk_dv_dq_dinit_max_abs_err=[e for e, _ in g_err],
               dloga_against="float64" if decay == "near1" else "float32",
               tol=SSD_TOL, ok=all(o for _, o in g_err))
    del leaves, py, pfin, pstates, want
    if (B, H, S, N, P, chunk) != SSD_TRAIN_SHAPE:
        return [fwd, bwd]
    bwd.update(_ssd_f64_errors(a, k, v, q, s0, dy, dfin, chunk, grads))
    # the kernel's d(log a) no further from float64 than the reference's
    # arithmetic, the fp32 plain version
    bwd["dloga_kernel_le_plain"] = (bwd["kernel_vs_f64"][0]
                                    <= bwd["plain_vs_f64"][0])
    bwd["ok"] = bwd["ok"] and bwd["dloga_kernel_le_plain"]
    if decay == "near1":
        nc = -(-S // chunk)
        kq = 2 * (k[:, 0].numel() if bcast else k.numel()) * 4
        io = (a.numel() + v.numel()) * 4 + kq
        f_flops, b_flops = _ssd_work(B, H, S, N, P, chunk)
        # forward: reads a, k, q, v; writes y, the final and chunk states
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(
            io + (v.numel() + B * H * (nc + 1) * N * P) * 4, f_flops,
            torch.float32)
        # backward: reads a, k, q, v, dy and the states; writes da, dv and
        # the per-head dk, dq
        bwd["bound_ms"], bwd["bound_by"] = bound_ms(
            io + (2 * v.numel() + B * H * (nc + 1) * N * P + a.numel()
                  + 2 * B * H * S * N) * 4, b_flops, torch.float32)
        _, fin0, st0 = ssd.ssd_scan_fwd(a, k, v, q, chunk, save_states=True)
        fwd["ms"] = timer(lambda: ssd.ssd_scan_fwd(a, k, v, q, chunk,
                                                   save_states=True), 20)
        fwd["plain_ms"] = timer(lambda: ssd._plain_forward(a, k, v, q, chunk),
                                10)
        bwd["ms"] = timer(lambda: ssd.ssd_scan_bwd(
            a, k, v, q, dy, st0, fin0, None, chunk, False), 20)
        bwd["plain_ms"] = timer(lambda: ssd.ssd_scan_bwd_plain(
            a, k, v, q, dy, st0, fin0, None, chunk, False), 10)
        # no single PyTorch call computes the scan or its gradient
        fwd["library_ms"] = bwd["library_ms"] = None
    return [fwd, bwd]


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


def _path_products():
    """The serving paths' products, (name, K, N): one gemma-2b layer's 7,
    and zamba2-1.2b's Mamba-2 in_proj (N = 8384, a multiple of no tile)
    and out_proj and three of its shared block's."""
    cfg = get_config("gemma-2b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    gemma = [("wq", d, cfg.n_heads * hd), ("wk", d, cfg.n_kv_heads * hd),
             ("wv", d, cfg.n_kv_heads * hd), ("wo", cfg.n_heads * hd, d),
             ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]
    zcfg = get_config("zamba2-1.2b")
    zd, d_in = zcfg.d_model, zcfg.ssm_expand * zcfg.d_model
    zproj = 2 * d_in + 2 * zcfg.ssm_state + d_in // zcfg.ssm_head_dim
    zamba = [("in_proj", zd, zproj), ("out_proj", d_in, zd),
             ("wq", zd, zd), ("w_gate", zd, zcfg.d_ff),
             ("w_down", zcfg.d_ff, zd)]
    return gemma, zamba


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
                # peaked scores (q x 8): the running max moves
                (1, 1, 8, 300, 300, 256, True, 8.0),
                (1, 32, 1, 512, 512, 64, True, 8.0),
                (1, 2, 4, 128, 300, 128, False, 8.0),
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
    for r in rows:
        if r["kernel"] == "decode_attention" and "ms" in r:
            r["launch_floor_ms"] = floor_ms
    # zamba2's shared attention in training, bf16 as the path runs it
    rows += _flash_case(timer, torch.bfloat16, *ZAMBA_FLASH_SHAPE, True, gen)
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
                SSD_TRAIN_SHAPE + (True,)):
            rows += _ssd_case(timer, B, H, S, N, P, chunk, bcast, decay, gen)
            torch.cuda.empty_cache()
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


def _decode_errors(cfg, cpu, gpu, prompts, S, window=None) -> dict:
    """Largest card-vs-CPU distance of the logits over one decode step per
    prompt token and, for zamba2, of each layer's SSM state and conv window
    after them; ``window`` replaces the conv window's dtype on both sides."""
    B, P = prompts.shape
    caches = {d: lm.init_cache(cfg, B, S, device=d) for d in ("cpu", "cuda")}
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


def phase_parity(arch: str) -> dict:
    """A reduced config with the same fp32 weights on the card and on the
    CPU: identical greedy tokens, logits within PARITY_TOL after each
    decode step and, for zamba2 (whose forward runs the SSD scan), after
    ``forward`` over three chunks of the scan (the last ragged).  zamba2's
    decode runs twice: with its bf16 conv window (ZAMBA_DECODE_TOL on the
    logits) and with the window in fp32 on both sides (PARITY_TOL on the
    logits, the SSM state and the window)."""
    cfg = get_config(arch).reduced()
    # the same draws from one CPU generator, placed on either device
    cpu, gpu = (lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=d, dtype=torch.float32)
                for d in ("cpu", "cuda"))
    B, P, n_new, S = 4, 12, 8, 64
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1))
    toks = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        eng = ServeEngine(cfg, params, max_seq=S, batch=B, device=dev)
        toks[dev] = eng.generate(prompts, n_new).cpu()
    same = torch.equal(toks["cpu"], toks["cuda"])
    hybrid = cfg.block_pattern == "mamba_shared_attn"
    dec = _decode_errors(cfg, cpu, gpu, prompts, S)
    res = dict(phase="parity", arch=cfg.name, params="float32",
               tokens_identical=same, logits_max_abs_err=dec["logits"],
               tol=ZAMBA_DECODE_TOL if hybrid else PARITY_TOL,
               forward_tol=PARITY_TOL)
    if hybrid:
        res["decode_bf16_window_max_abs_err"] = dec
        res["decode_fp32_window_max_abs_err"] = _decode_errors(
            cfg, cpu, gpu, prompts, S, torch.float32)
        # 600 positions: chunks of 256, 256 and 88, so the state is carried
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
        require(res["forward_logits_max_abs_err"] <= PARITY_TOL,
                "forward logits within tolerance")
    return res


def _expected_launches(cfg, path: str, steps: int) -> dict:
    """Exact launches of each kernel entry point on a path.  serve: per
    decode step, gemma-2b 18 decode attentions and 7 x 18 products; zamba2
    7 decode attentions (the shared block's applications) and 2 x 38 + 7 x 7
    products.  train: per step, every layer's forward twice (remat) and
    its backward once: gemma-2b 36 + 18 flash launches; zamba2 14 + 7 flash
    and 76 + 38 SSD launches, 380 and 190 over 5 steps."""
    counts = dict.fromkeys(ops.launch_counts(), 0)
    L = cfg.n_layers
    attn = L if cfg.block_pattern == "attn" else -(-L // cfg.attn_every)
    if path == "serve":
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
    writes every layer's SSM state and conv window."""
    line = H100_HBM_HOST.cacheline_bytes
    wbytes = 2 * cfg.n_params()
    n_kv, state = cfg.n_layers, 0
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


def _device_profile(run, steps: int, wall_ms: float, groups=None) -> dict:
    """torch.profiler over ``run()`` (``steps`` steps): device busy time
    (union of device intervals), idle share against the unprofiled step
    time ``wall_ms``, the kernels that take the most device time and, with
    ``groups`` ({group: name substrings}), device time per group (the rest
    under "other")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0) / steps
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
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
    "splitk_sum": ["splitk_sum_kernel"],
}


def _profile(params, cfg, B, S, steps: int, wall_ms: float) -> dict:
    """The profile of a few decode steps, after four unprofiled ones."""
    cache = lm.init_cache(cfg, B, S)
    tok = torch.zeros(B, dtype=torch.long, device="cuda")
    for p in range(4):
        lm.decode_step(params, cfg, cache, tok, p)

    def run():
        for p in range(4, 4 + steps):
            lm.decode_step(params, cfg, cache, tok, p)
    return _device_profile(run, steps, wall_ms, SERVE_GROUPS)


def _free() -> None:
    """Release what an earlier phase left, and reset the peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_serve(arch: str, name: str) -> dict:
    """A full-width model, bf16, batch 4, three requests of 128 + 32
    tokens under the runtime; the third repeats the first."""
    _free()
    cfg = get_config(arch)
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
    res["profile"] = prof = _profile(params, cfg, B, S, 8, min(wall_ms))
    calls = prof["calls_per_step_by_group"]
    res["device_operations_per_step"] = prof["device_events_per_step"]
    emit(res)
    require(launches == expect, f"launch counts {launches} == {expect}")
    require(calls.get("tiered_matmul") == expect["tiered_matmul"] / steps
            and not calls.get("tiered_matmul_ffma")
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


def phase_train(arch: str, S: int, name: str) -> dict:
    """A full-width model, bf16 parameters from a seeded generator, AdamW
    (fp32 master and moments, lr 3e-4), per-layer remat, batch 2 x S
    tokens from the ported pipeline, 5 steps through ``train/loop.py``
    under ``UnimemRuntime(H100_HBM_HOST)``."""
    cfg = get_config(arch)
    B, steps = 2, 5
    tcfg = TrainConfig(steps=steps, global_batch=B, seq_len=S, lr=3e-4,
                       remat=True, log_every=1, seed=0,
                       machine=H100_HBM_HOST, device="cuda")
    opt = AdamWConfig(lr=3e-4)
    _free()
    ops.reset_launch_counts()            # the main path starts here
    t0 = time.perf_counter()
    res = train(cfg, tcfg, opt)
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    rt = res.runtime
    plan = rt.plan
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
        optimizer=dict(lr=opt.lr, master_fp32=opt.master_fp32,
                       moments=opt.moments_dtype),
        losses=res.losses, grad_norms=res.grad_norms, ms_per_step=ms,
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
    res_row["profile"] = _train_profile(cfg, tcfg, opt, min(ms[1:]))
    res_row["profile"]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(res_row, default=str), flush=True)
    losses = res_row["losses"]
    require(all(math.isfinite(x) for x in losses), "every loss finite")
    require(sum(losses[-2:]) / 2 < losses[0],
            "the mean of the last two losses is below the first")
    require(launches == expect, f"launch counts {launches} == {expect}")
    reg = res_row["runtime"]["registered"]
    require(res_row["runtime"]["phases"] == ["data", "step", "ckpt"]
            and "opt_state" in planned and "opt_state" in reg
            and reg.get("params", {}).get("pinned"),
            "the runtime planned opt_state (params pinned) over the "
            "phases data, step, ckpt")
    return res_row


TRAIN_GROUPS = {
    "flash_attention": ["flash_fwd_kernel", "flash_fwd_wgmma"],
    "flash_attention_bwd_dq": ["dq_wgmma", "dq_kernel", "delta_kernel"],
    "flash_attention_bwd_dkdv": ["dkdv_wgmma", "dkdv_kernel",
                                 "split_sum_kernel"],
    "ssd_scan": ["ssd_fwd_kernel"],
    "ssd_scan_bwd": ["ssd_bwd_kernel"],
    "cublas_products": ["nvjet", "gemm", "cutlass", "sm90_xmma"],
}


def _train_profile(cfg, tcfg, opt, wall_ms: float) -> dict:
    """The profile of two training steps (outside the runtime), after one
    unprofiled step, on a fresh model of the same configuration; then two
    steps timed in halves with CUDA events: forward + backward
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
        for _ in range(2):
            step(params, state, batch)
    prof = _device_profile(run, 2, wall_ms, TRAIN_GROUPS)
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


def kernel_line(checks, paths) -> dict:
    """Each kernel's numbers at its path's shapes: decode attention one
    bf16 call at batch 4, length 160 over the (4, 1024, 1, 256) cache view;
    tiered_matmul one gemma-2b layer's 7 bf16 products at M = 4, summed;
    flash attention forward and backward one bf16 call at the gemma-2b
    training shape; the SSD scan and its gradient one fp32 call at the
    zamba2 training shape.  Launches are the sum over the main paths
    (``paths``: the serve and train rows of both models), each counted from
    0 just before its path ran; ``launches_by_path`` splits them."""
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
        row["bound_by"] = rows[0]["bound_by"]
        if name == "decode_attention":
            row["launch_floor_ms"] = rows[0]["launch_floor_ms"]
        row["covers"] = covers
        row["path"] = [p for p, n in by_path.items() if n]
        out.append(row)
    return {"kernels": out}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--compare-matmul":
        return compare_matmul(sys.argv[2])
    t0 = time.perf_counter()
    info = phase_device()
    phase_build()
    timer = Timer()
    checks = phase_check(timer)
    phase_runtime(timer)
    phase_parity("gemma-2b")
    phase_parity("zamba2-1.2b")
    paths = [phase_serve("gemma-2b", "serve"),
             phase_train("gemma-2b", 2048, "train"),
             phase_serve("zamba2-1.2b", "serve_zamba2"),
             phase_train("zamba2-1.2b", 4096, "train_zamba2")]
    line = kernel_line(checks, paths)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
