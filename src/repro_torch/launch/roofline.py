"""Roofline of each dry-run cell: the reference's analytic terms, with the
chip counts and rates as parameters, beside the measured ms a step.

  python -m repro_torch.launch.roofline --dir DIR

The counterpart of the reference's ``launch/roofline.py``:
:func:`analytic_terms`, :func:`model_flops` and :func:`analyze` keep its
napkin model (FLOPs 2ND a decode token plus the attention and recurrence
terms; HBM bytes the weights in bf16 plus the cache, 1 byte a cached value
for fp8; the link the TP all-reduces), with the chip counts (``chips``,
``dp``, ``tp``) and the rates (bf16 FLOP/s, HBM B/s, link B/s) in a
:class:`Rates`.  The default is one H100 SXM: 1, 1, 1; 989e12 and 3.35e12
from NVIDIA's H100 SXM data sheet (dense bf16, HBM3); no link term on one
card.  Given the reference's counts and rates its numbers come out the
same.  Each row also carries the dry run's measured ms a step
(``measured_ms_a_step``; a train cell's ``microbatches_run`` of its
microbatches) and, for a train or prefill cell, the cost probes' ms
carried to the whole step (``ms_a_step_extrapolated``) beside
``step_bound_s``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional

from ..configs import SHAPES, get_config
from ..configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class Rates:
    """Chip counts and peak rates of the machine a cell runs on."""

    chips: int = 1
    dp: int = 1
    tp: int = 1
    flops: float = 989e12           # bf16 dense, H100 SXM data sheet
    hbm_bw: float = 3.35e12         # HBM3, H100 SXM data sheet
    link_bw: Optional[float] = None  # no link term on one card


H100 = Rates()


def attention_flops_fwd(cfg: ArchConfig, B: int, S: int, cache: int = 0
                        ) -> float:
    """Causal attention matmul FLOPs, forward, all layers."""
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    if cfg.block_pattern == "mamba_shared_attn":
        n_attn = -(-cfg.n_layers // cfg.attn_every)
    elif cfg.block_pattern == "xlstm":
        n_attn = 0
    else:
        n_attn = cfg.n_layers
    if cache:                       # decode: 1 token vs cache
        return n_attn * 4.0 * B * H * Dh * cache
    return n_attn * 2.0 * B * S * S * H * Dh      # causal half of 4BSSHD


def ssm_flops_fwd(cfg: ArchConfig, tokens: float) -> float:
    """Linear-recurrence extra FLOPs (state updates), forward."""
    if cfg.block_pattern == "mamba_shared_attn":
        d_in = cfg.ssm_expand * cfg.d_model
        return cfg.n_layers * 6.0 * tokens * d_in * cfg.ssm_state
    if cfg.block_pattern == "xlstm":
        d_in = cfg.ssm_expand * cfg.d_model
        P = d_in // cfg.n_heads
        return cfg.n_layers * 4.0 * tokens * d_in * P
    return 0.0


def analytic_terms(cfg: ArchConfig, shape: ShapeConfig, r: Dict,
                   rates: Rates = H100) -> Dict:
    CHIPS, DP, TP = rates.chips, rates.dp, rates.tp
    B, S = shape.global_batch, shape.seq_len
    N = cfg.n_active_params()
    N_total = cfg.n_params()
    mb = r.get("microbatches") or 1
    offload = r.get("mode") == "offload-grads"
    kv_bytes = 1 if "float8" in str(r.get("kv_dtype", "")) else 2

    if shape.kind == "train":
        tokens = B * S
        flops = (6.0 * N * tokens
                 + 3.0 * (attention_flops_fwd(cfg, B, S)
                          + ssm_flops_fwd(cfg, tokens)))
        flops *= 4.0 / 3.0          # remat: one extra forward
        w_traffic = 3 * 2 * N_total
        opt_traffic = 0 if offload else 2 * 12 * N_total
        act = 2 * 2 * tokens * cfg.d_model * cfg.n_layers / TP
        hbm = w_traffic / CHIPS + opt_traffic / CHIPS + act / DP
        ag = 2 * mb * 2 * N_total / TP
        rs = 2 * N_total / TP
        tp_ar = 2 * 2 * 2 * (tokens / DP) * cfg.d_model * cfg.n_layers
        a2a = (2 * 2 * tokens * cfg.moe_top_k * cfg.d_model / CHIPS
               if cfg.is_moe else 0.0)
        ici = ag + rs + tp_ar / 1e0 + a2a
        coll = {"all-gather": ag, "reduce-scatter": rs,
                "all-reduce(x2)": tp_ar, "all-to-all": a2a}
    elif shape.kind == "prefill":
        tokens = B * S
        flops = (2.0 * N * tokens + attention_flops_fwd(cfg, B, S)
                 + ssm_flops_fwd(cfg, tokens))
        hbm = (2 * N_total / CHIPS
               + 2 * tokens * cfg.d_model * cfg.n_layers / DP / TP)
        ag = 2 * N_total / TP
        tp_ar = 2 * 2 * (tokens / DP) * cfg.d_model * cfg.n_layers
        a2a = (2 * tokens * cfg.moe_top_k * cfg.d_model / CHIPS
               if cfg.is_moe else 0.0)
        ici = ag + tp_ar + a2a
        coll = {"all-gather": ag, "all-reduce(x2)": tp_ar, "all-to-all": a2a}
    else:                            # decode: one token, cache of length S
        tokens = B
        flops = (2.0 * N * tokens + attention_flops_fwd(cfg, B, S, cache=S)
                 + ssm_flops_fwd(cfg, tokens))
        K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        if cfg.block_pattern == "attn":
            cache_bytes = 2 * cfg.n_layers * B * S * K * Dh * kv_bytes
        elif cfg.block_pattern == "mamba_shared_attn":
            n_apps = -(-cfg.n_layers // cfg.attn_every)
            d_in = cfg.ssm_expand * cfg.d_model
            cache_bytes = (2 * n_apps * B * S * K * Dh * kv_bytes
                           + cfg.n_layers * B * (d_in // cfg.ssm_head_dim)
                           * cfg.ssm_state * cfg.ssm_head_dim * 4)
        else:
            d_in = cfg.ssm_expand * cfg.d_model
            P = d_in // cfg.n_heads
            cache_bytes = cfg.n_layers * B * cfg.n_heads * P * (P + 1) * 4
        hbm = (2 * N_total + cache_bytes) / CHIPS
        tp_ar = 2 * 2 * (tokens / max(1, min(DP, B))) * cfg.d_model \
            * cfg.n_layers
        ici = tp_ar
        coll = {"all-reduce(x2)": tp_ar}
    if rates.link_bw is None:       # one card: nothing crosses a link
        ici, coll = 0.0, {}

    return {
        "flops_per_chip": flops / CHIPS,
        "hbm_bytes_per_chip": hbm,
        "ici_bytes_per_chip": ici,
        "collectives": coll,
        "compute_s": flops / CHIPS / rates.flops,
        "memory_s": hbm / rates.hbm_bw,
        "collective_s": ici / rates.link_bw if rates.link_bw else 0.0,
    }


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def _cell(r: Dict):
    """(arch, shape name, config, shape) of a record, with the cuts a
    dry-run record states: a reduced config (``-smoke``), its layers, batch
    and sequence length."""
    arch, shape_name, _ = r["cell"].split("|")
    if arch.endswith("-smoke"):
        cfg = get_config(arch[:-len("-smoke")]).reduced()
    else:
        cfg = get_config(arch)
    if r.get("n_layers", cfg.n_layers) != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=r["n_layers"])
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(
        shape, global_batch=r.get("batch", shape.global_batch),
        seq_len=r.get("seq_len", shape.seq_len))
    return arch, shape_name, cfg, shape


def analyze(r: Dict, rates: Rates = H100) -> Dict:
    """One cell's roofline row: the reference's keys, then the measured ms
    a step (``measured_ms_a_step``, None for a cell that did not run)."""
    arch, shape_name, cfg, shape = _cell(r)
    t = analytic_terms(cfg, shape, r, rates)
    terms = {"compute": t["compute_s"], "memory": t["memory_s"],
             "collective": t["collective_s"]}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cfg, shape) / rates.chips
    ideal_mem = ((2 * cfg.n_params() / rates.chips) / rates.hbm_bw
                 if shape.kind == "decode" else 0.0)
    ideal = max(mf / rates.flops,
                ideal_mem if shape.kind == "decode" else 0.0,
                t["memory_s"] if shape.kind == "decode" else 0.0)
    frac = ideal / bound if bound else 0.0
    return {
        "cell": r["cell"], "arch": arch, "shape": shape_name,
        "mode": r.get("mode"), "microbatches": r.get("microbatches"),
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"], "dominant": dominant,
        "model_flops_per_chip": mf,
        "hlo_flops_ratio": mf / t["flops_per_chip"],
        "roofline_fraction": frac,
        "step_bound_s": bound,
        "peak_gib": r["memory"]["peak_bytes"] / 2 ** 30,
        "fits": r.get("fits_hbm"),
        "hlo_collectives": {k: v["count"]
                            for k, v in r.get("collectives_raw", {}).items()
                            if v["count"]},
        "measured_ms_a_step": r.get("ms_a_step"),
        "ms_a_step_extrapolated": r.get("ms_a_step_extrapolated"),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True,
                    help="the directory of the dry run's JSON records")
    args = ap.parse_args()
    rows: List[Dict] = []
    for fn in sorted(glob.glob(os.path.join(args.dir, "*1xH100.json"))):
        with open(fn) as f:
            r = json.load(f)
        if r.get("status") != "ok":
            rows.append({"cell": r["cell"], "skip": r.get("reason")})
            continue
        rows.append(analyze(r))
    for row in rows:
        if "skip" in row:
            print(f"{row['cell']:44s} SKIP ({row['skip'][:48]})")
            continue
        meas = row["measured_ms_a_step"]
        ext = row["ms_a_step_extrapolated"]
        print(f"{row['cell']:44s} dom={row['dominant']:8s} "
              f"C={row['compute_s'] * 1e3:9.3f}ms "
              f"M={row['memory_s'] * 1e3:8.3f}ms "
              f"bound={row['step_bound_s'] * 1e3:8.3f}ms "
              f"measured={'not run' if meas is None else f'{meas:.3f}ms'} "
              f"extrapolated="
              f"{'none' if ext is None else f'{ext:.3f}ms'} "
              f"peak={row['peak_gib']:6.2f}GiB fits={row['fits']}")


if __name__ == "__main__":
    main()
