#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Drives the port's main path on the card and fails (non-zero exit, no
result line) if any phase fails:

1. device   -- the card (nvidia-smi name and power limit), torch and CUDA;
2. build    -- both kernels compiled from ``src/repro_torch/csrc`` with nvcc
               for sm_90a, with the ptxas report;
3. check    -- each kernel against its plain PyTorch version at the
               reference tests' shapes and the serving shapes, fp32 and
               bf16, with kernel / plain / bound / library times;
4. runtime  -- the Unimem runtime moving real tensors between HBM and
               pinned host memory (``backend="torch_async"``), bytes checked,
               plus host<->device copy rates for 1, 2 and 4 channels;
5. parity   -- reduced gemma-2b, fp32 weights, the card against the CPU;
6. serve    -- full-width gemma-2b (18 layers, d_model 2048, vocab 256000)
               served under the runtime, with every kernel launch counted;
7. kernels  -- one line with each kernel's numbers.

Each phase prints one JSON object; the last line is the device object.
Times are CUDA-event times over many queued launches (median), each
behind a device-side sleep so that no host delay falls inside a timed
pair, with the L2 cache flushed before each launch, since the serving path
finds weights and cache cold.  Needs one CUDA card and nvcc; it stops at once without them.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (H100_HBM_HOST, ManualSource,  # noqa: E402
                              RuntimeConfig, UnimemRuntime)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.tiered_matmul import tiered_matmul_plain  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

MB = 1024 ** 2
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BW = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}     # tests/test_kernels.py
PARITY_TOL = 1e-4
KERNELS = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:65"),
    "tiered_matmul": ("src/repro_torch/csrc/tiered_matmul.cu",
                      "src/repro/kernels/tiered_matmul.py:50"),
}


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


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = build.build(list(KERNELS))
    for name in KERNELS:
        build.load(name)
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc=build.nvcc_path(), flags=build.NVCC_FLAGS,
              ptxas=reports))


def _compare(out, plain, dtype):
    """Max abs error, and the reference tests' allclose (rtol = atol)."""
    a, b = out.float(), plain.float()
    return ((a - b).abs().max().item() if a.numel() else 0.0,
            torch.allclose(a, b, rtol=TOL[dtype], atol=TOL[dtype]))


def _decode_case(timer, dtype, B, K, G, D, T, length, cache_view, gen):
    if cache_view:      # one layer of the serving cache, (B, T, K, D)
        kc = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        vc = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    else:
        k = torch.randn((B, K, T, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, K, T, D), generator=gen, device="cuda").to(dtype)
    q = torch.randn((B, K, G, D), generator=gen, device="cuda").to(dtype)
    out = ops.decode_attention(q, k, v, length)
    plain = decode_attention_plain(q, k, v, length)
    torch.cuda.synchronize()
    err, ok = _compare(out, plain, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * K * G * D + 2 * B * K * length * D) * size
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * K * G * length * D, dtype)
    lib = None
    if length:
        kl, vl = k[:, :, :length], v[:, :, :length]
        lib = timer(lambda: F.scaled_dot_product_attention(q, kl, vl))
    return dict(
        phase="check", kernel="decode_attention", dtype=str(dtype)[6:],
        shape=dict(B=B, K=K, G=G, D=D, T=T, length=length,
                   cache_view=cache_view),
        max_abs_err=err, tol=TOL[dtype], ok=ok,
        ms=timer(lambda: ops.decode_attention(q, k, v, length)),
        plain_ms=timer(lambda: decode_attention_plain(q, k, v, length)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def _matmul_case(timer, dtype, M, K, N, gen, name=None):
    x = (torch.randn((M, K), generator=gen, device="cuda") * 0.1).to(dtype)
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.1).to(dtype)
    out = ops.tiered_matmul(x, w)
    plain = tiered_matmul_plain(x, w)
    torch.cuda.synchronize()
    err, ok = _compare(out, plain, dtype)
    size = x.element_size()
    b_ms, b_by = bound_ms((M * K + K * N + M * N) * size, 2.0 * M * N * K,
                          dtype)
    return dict(
        phase="check", kernel="tiered_matmul", dtype=str(dtype)[6:],
        shape=dict(M=M, K=K, N=N, product=name), max_abs_err=err,
        tol=TOL[dtype], ok=ok,
        ms=timer(lambda: ops.tiered_matmul(x, w)),
        plain_ms=timer(lambda: tiered_matmul_plain(x, w)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.matmul(x, w)))


def phase_check(timer) -> list:
    """Every kernel against its plain version; returns all check rows."""
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 stays fp32
    gen = torch.Generator(device="cuda").manual_seed(42)
    cfg = get_config("gemma-2b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    products = [("wq", d, cfg.n_heads * hd), ("wk", d, cfg.n_kv_heads * hd),
                ("wv", d, cfg.n_kv_heads * hd), ("wo", cfg.n_heads * hd, d),
                ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]
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


def phase_parity() -> dict:
    """Reduced gemma-2b with the same fp32 weights on the card and on the
    CPU: identical greedy tokens, logits within PARITY_TOL."""
    cfg = get_config("gemma-2b").reduced()
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
    err = 0.0
    caches = {d: lm.init_cache(cfg, B, S, device=d) for d in ("cpu", "cuda")}
    for i in range(P):
        a = lm.decode_step(cpu, cfg, caches["cpu"], prompts[:, i], i)
        b = lm.decode_step(gpu, cfg, caches["cuda"], prompts[:, i].cuda(), i)
        err = max(err, (a - b.cpu()).abs().max().item())
    same = torch.equal(toks["cpu"], toks["cuda"])
    res = dict(phase="parity", arch=cfg.name, params="float32",
               tokens_identical=same, logits_max_abs_err=err,
               tol=PARITY_TOL)
    emit(res)
    require(same, "greedy tokens identical on card and CPU")
    require(err <= PARITY_TOL, "logits within tolerance")
    return res


def _serve_source(cfg, B, P, n_new, tenant) -> ManualSource:
    """Analytic access counts (bytes / cacheline) of one request's phases:
    every step reads all weights once (the tied head reads the whole
    embedding) and the KV cache rows written so far."""
    line = H100_HBM_HOST.cacheline_bytes
    wbytes = 2 * cfg.n_params()
    kv_row = 2 * cfg.n_layers * B * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    kv = lambda a, b: sum(kv_row * (p + 1) for p in range(a, b))  # noqa: E731
    src = ManualSource()
    src.set(f"{tenant}/prefill", accesses={
        f"{tenant}/params": P * wbytes / line,
        f"{tenant}/kv_cache": kv(0, P) / line})
    src.set(f"{tenant}/decode", accesses={
        f"{tenant}/params": n_new * wbytes / line,
        f"{tenant}/kv_cache": kv(P, P + n_new) / line})
    return src


def _profile(params, cfg, B, S, steps: int, wall_ms: float) -> dict:
    """torch.profiler over a few decode steps: device busy time (union of
    device intervals), idle share against the unprofiled step time, and
    the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    cache = lm.init_cache(cfg, B, S)
    tok = torch.zeros(B, dtype=torch.long, device="cuda")
    for p in range(4):
        lm.decode_step(params, cfg, cache, tok, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for p in range(4, 4 + steps):
            lm.decode_step(params, cfg, cache, tok, p)
        torch.cuda.synchronize()
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    busy_ms = busy / 1e3 / steps
    return dict(
        steps=steps, device_events=len(dev),
        device_busy_ms_per_step=busy_ms if dev else None,
        wall_ms_per_step=wall_ms,
        device_idle_share=(1.0 - busy_ms / wall_ms) if dev else None,
        top_kernels=[dict(name=n[:96], ms_per_step=t / 1e3 / steps,
                          calls_per_step=c / steps)
                     for n, (t, c) in top])


def phase_serve() -> dict:
    """Full-width gemma-2b, bf16, batch 4, three requests of 128 + 32
    tokens under the runtime; the third repeats the first."""
    cfg = get_config("gemma-2b")
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
    expect = {"decode_attention": cfg.n_layers * steps,
              "tiered_matmul": 7 * cfg.n_layers * steps}
    peak = torch.cuda.max_memory_allocated()
    logits = lm.decode_step(params, cfg, lm.init_cache(cfg, B, S),
                            outs[0][:, 0].cuda(), 0)
    plan = rt.plan
    plan_objs = sorted({m.obj for m in plan.moves}
                       | {o for r in plan.residents for o in r}) if plan else []
    wall_ms = [1e3 * s / (P + n_new) for s in secs]
    res = dict(
        phase="serve", arch=cfg.name, dtype="bfloat16",
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
    res["profile"] = _profile(params, cfg, B, S, 8, min(wall_ms))
    emit(res)
    require(launches == expect, f"launch counts {launches} == {expect}")
    require(res["repeat_identical"], "a repeated request gives the same tokens")
    require(res["logits_finite"] and res["logits_shape"] == [B, cfg.vocab_size],
            "finite logits of shape (batch, vocab)")
    require(all(o.shape == (B, P + n_new) for o in outs), "output shapes")
    require(plan is not None and plan_objs
            and all(o.startswith("t0/") for o in plan_objs)
            and rt.phase_names() == ["t0/prefill", "t0/decode"],
            "the runtime planned the tenant's objects and phases")
    return res


def kernel_line(checks, serve) -> dict:
    """Each kernel's numbers at the serving path's shapes: decode attention
    one bf16 call at batch 4, length 160 over the (4, 1024, 1, 256) cache
    view; tiered_matmul one layer's 7 bf16 products at M = 4, summed."""
    def pick(kernel, cond):
        return [r for r in checks if r["kernel"] == kernel
                and r["dtype"] == "bfloat16" and cond(r["shape"])]

    da = pick("decode_attention",
              lambda s: s["cache_view"] and s["length"] == 160)
    mm = pick("tiered_matmul", lambda s: s["product"] is not None)
    out = []
    for name, rows, covers in (
            ("decode_attention", da, "one bf16 call, batch 4, length 160, "
             "cache view (4,1024,1,256)"),
            ("tiered_matmul", mm, "one layer's 7 bf16 products at M=4, "
             "summed")):
        src, replaces = KERNELS[name]
        mine = [r for r in checks if r["kernel"] == name]
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=serve["launches"][name],
                   max_abs_err=max(r["max_abs_err"] for r in rows),
                   checks=len(mine), checks_ok=sum(r["ok"] for r in mine))
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            row[key] = sum(r[key] for r in rows)
        row["bound_by"] = rows[0]["bound_by"]
        row["covers"] = covers
        out.append(row)
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    info = phase_device()
    phase_build()
    timer = Timer()
    checks = phase_check(timer)
    phase_runtime(timer)
    phase_parity()
    serve = phase_serve()
    line = kernel_line(checks, serve)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
