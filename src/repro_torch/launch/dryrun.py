"""Dry run of the decode cells on one card: the fit loop, then each cell
that fits run at full width and depth.

  python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --attribution --out DIR
  python -m repro_torch.launch.dryrun --all --predict-only --device cpu
  python -m repro_torch.launch.dryrun --arch gemma --shape decode_32k \\
      --reduced --batch 2 --seq-len 64 --hbm 3000000000 --device cpu \\
      --attribution

The counterpart of the reference's ``launch/dryrun.py`` for its decode
cells (``decode_32k``: batch 128 over a 32,768-row cache; ``long_500k``:
batch 1 over 524,288 rows) on one card, ``n_chips`` 1 and the shape's
global batch whole.  There is nothing to compile, so the fit loop decides
from a stated prediction of the peak: the weights' bytes, the cache's
bytes (both exact, from the shapes) and ``DECODE_WORKSPACE`` (the decode
step's transients and the fill's slab, measured on the card).  Under 0.95
of the card's memory (the reference's rule, there 0.95 x 16 GiB) the cell
runs with a bf16 KV cache; over it, with the fp8 e4m3 cache (the
reference's second attempt); over it still, it reports ``fits_hbm:
false`` and is not run.  A cell that runs draws bf16 weights from a seed,
fills its cache from a seed one layer at a time (slabs of at most
``FILL_SLAB`` elements), and runs ``decode_step`` at ``pos = seq_len -
1``, which reads the whole cache, as the reference's decode program does
for its ``pos`` input: one warm-up step, then ``--steps`` timed ones
(host clock, each ending in a synchronisation) with the kernel launches
counted, the measured peak beside the prediction, and with
``--attribution`` the per-object access histograms of one more step
(:class:`..core.OperandAttributionSource`, the objects ``params`` and
``kv_cache`` registered as the reference registers them).  ``train`` and
``prefill`` cells are reported as skipped: not ported yet (ROADMAP).  The
entry point runs on the card unless ``--device cpu`` is given; on the CPU
``--hbm`` states the memory the fit loop holds a cell to.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import _tree
from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..core import H100_HBM_HOST, OperandAttributionSource, Session
from ..kernels import ops
from ..models import lm
from ..models.common import E4M3, kv_cast, tree_bytes

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


def cell_id(cfg: ArchConfig, shape_name: str) -> str:
    return f"{cfg.name}|{shape_name}|1xH100"


def weights_bytes(cfg: ArchConfig) -> int:
    """Bytes of the bf16 parameters ``lm.init_params`` draws: their shapes
    from a run under FakeTensorMode (nothing allocated)."""
    with FakeTensorMode():
        params = lm.init_params(cfg, torch.Generator(), device="cpu")
    return tree_bytes(params)


def cache_bytes(cfg: ArchConfig, shape: ShapeConfig, kv_dtype) -> int:
    return tree_bytes(lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device="meta", kv_dtype=kv_dtype))


def _has_kv(cfg: ArchConfig) -> bool:
    return cfg.block_pattern != "xlstm"


def fit(cfg: ArchConfig, shape: ShapeConfig, hbm_bytes: int
        ) -> Dict[str, Any]:
    """The fit loop: bf16 KV cache, then e4m3 if the prediction is over
    ``HBM_FRACTION`` of ``hbm_bytes`` (xlstm has no KV cache to switch).
    Returns the chosen ``kv_dtype``, ``fits_hbm``, ``memory`` (the chosen
    attempt's prediction, reference keys) and every ``attempt``."""
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


def unimem_attribution(params, cache, step: Callable[[], Any],
                       n_bins: int = 64) -> Dict[str, Any]:
    """``params`` and ``kv_cache`` registered in a ``Session(H100_HBM_HOST)``
    (the cache chunkable, as the reference registers it), one run of
    ``step`` recorded, its sample summarised."""
    sess = Session(H100_HBM_HOST)
    sess.register("params", params, chunkable=False)
    sess.register("kv_cache", cache, chunkable=True)
    src = OperandAttributionSource(sess, n_bins=n_bins)
    with src.record("step"):
        step()
    return _summary(src.collect("step"))


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(arch: str, shape_name: str, *, device: str = "cuda",
             hbm_bytes: Optional[int] = None, reduced: bool = False,
             batch: Optional[int] = None, seq_len: Optional[int] = None,
             steps: int = 3, attribution: bool = False,
             predict_only: bool = False, seed: int = 0,
             profile: Optional[Callable] = None) -> Dict[str, Any]:
    """One cell's record.  ``reduced``, ``batch`` and ``seq_len`` cut it
    (listed under ``reduced``); ``hbm_bytes`` defaults to the card's
    ``total_memory``; ``profile(run, steps, wall_ms)``, if
    given, is called after the timed steps with a function that runs
    ``steps`` more and its result stored under ``profile``."""
    cfg = get_config(arch)
    cuts = {}
    if reduced:
        cfg, cuts["config"] = cfg.reduced(), "reduced()"
    shape = SHAPES[shape_name]
    cid = cell_id(cfg, shape_name)
    if shape.kind != "decode":
        return {"cell": cid, "status": "skipped",
                "reason": f"{shape.kind} cells are not ported yet (ROADMAP "
                          "queue 1, item 5): the microbatch fit loop, the "
                          "offload programs and the cost probes"}
    ok, why = cfg.shape_applicable(shape)
    if not ok:
        return {"cell": cid, "status": "skipped", "reason": why}
    if batch is not None or seq_len is not None:
        cuts["batch"] = [shape.global_batch, batch or shape.global_batch]
        cuts["seq_len"] = [shape.seq_len, seq_len or shape.seq_len]
        shape = dataclasses.replace(
            shape, global_batch=batch or shape.global_batch,
            seq_len=seq_len or shape.seq_len)
    if hbm_bytes is None:
        if device != "cuda":
            raise ValueError("dryrun: give --hbm off the card")
        hbm_bytes = torch.cuda.get_device_properties(0).total_memory
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
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
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
    if device == "cuda":
        rec["memory"]["measured_peak_bytes"] = (
            torch.cuda.max_memory_allocated() - base)
    if profile is not None:
        def run():
            for _ in range(steps):
                step()
        rec["profile"] = profile(run, steps, min(ms))
    if attribution:
        rec["unimem_attribution"] = unimem_attribution(params, cache, step)
    del params, cache, logits
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attribution", action="store_true",
                    help="per-object access histograms of one decode step")
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
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args()

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    results = []
    for a in archs:
        for s in shapes:
            r = run_cell(a, s, device=args.device, hbm_bytes=args.hbm,
                         reduced=args.reduced, batch=args.batch,
                         seq_len=args.seq_len, steps=args.steps,
                         attribution=args.attribution,
                         predict_only=args.predict_only)
            results.append(r)
            print(json.dumps({k: v for k, v in r.items()
                              if k != "unimem_attribution"}), flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                fn = r["cell"].replace("|", "_").replace("/", "_") + ".json"
                with open(os.path.join(args.out, fn), "w") as f:
                    json.dump(r, f, indent=2)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_run = sum(bool(r.get("ran")) for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n== dry-run summary: {n_ok} ok ({n_run} run), {n_skip} skipped "
          "(documented) ==")


if __name__ == "__main__":
    main()
