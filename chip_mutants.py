#!/usr/bin/env python3
"""Mutation check of the hand-written kernels' checks, on one card.

  python3 chip_mutants.py [name ...]

Makes broken copies of ``src/`` and ``chip_smoke.py`` under
``build/mutants/``, each with one text replacement in one kernel source;
builds each copy's kernel, runs ``chip_smoke.py``'s checks of that kernel
there and prints one JSON line per mutant with the checks it failed.  The
checks can see these faults only if every mutant fails at least one of
them (or crashes); the script exits non-zero otherwise.  Names on the
command line run those mutants only.  The mutants:

- bf16 flash-attention forward (the flash checks, bar the training shape):
  ``corr_dropped`` (the online softmax never rescales),
  ``last_partial_tile_skipped`` (a key tile that ends past k_end is not
  loaded), ``diagonal_mask_dropped`` (keys past a row's position are not
  masked), ``group_split_fixed_8`` (a stacked row's position is taken as
  row / 8 where row / G belongs: right up to G 8, so only the G 16 checks
  see it);
- decode attention (the decode checks at the serving shapes, G = 16,
  peaked scores and behind a NaN fill of shared memory): ``merge_weight_dropped`` (the splits' partials are
  summed without exp(m_split - m)), ``newest_row_dropped`` (row
  ``length - 1`` is never read), ``split_partial_step_skipped`` (a split's
  last partial step, the rows past its last whole step of R rows, is not
  read), ``running_max_rescale_dropped`` (acc and l are never rescaled
  when the running max grows), ``uncopied_chunks_read`` (a lane's chunks
  past D, which no cp.async wrote, are read from the ring as if copied);
- SSD-scan backward (the SSD checks with decays near 1, and those behind
  a NaN fill of shared memory): ``dloga_inter_chunk_dropped`` (the term
  X_i = e^{cum_i} q_i . S dy_i of d(log a), which carries the state from
  earlier chunks, is left out), ``chunk_sum_dropped`` (the dS scan leaves
  the chunk sums U_c out: dS_c = e^{cum_L} dS_{c+1} only),
  ``tf32_lo_terms_dropped`` (every product in plain TF32, without the lo
  terms of the 3xTF32 split), ``ring_stage_overwritten`` (the next step's
  q and dy tiles are copied into the ring stage being read);
- SSD-scan forward (the SSD checks with decays near 1, and those behind a
  NaN fill of shared memory): ``fwd_carry_decay_dropped`` (the state scan
  adds each chunk's sum without decaying the state: S <- S + dS_c),
  ``fwd_tf32_lo_terms_dropped`` (every product in plain TF32),
  ``fwd_inter_chunk_dropped`` (the term e^{cum_i} q_i S_c, which carries
  the state from earlier chunks, is left out), ``fwd_tile_slot_overwritten``
  (the tiles of row tiles 2 and 3 are copied into the slots of row tiles
  0 and 1, which warps may be reading, and their own slots are never
  written; each tile's barrier still completes, so nothing hangs);
- the SSD kernels' wide route, N or P above 64 (chip_smoke.py's wide
  cases, forward and backward, with decays near 1 and behind a NaN fill
  of shared memory): ``wide_last_n_slice_dropped`` (the forward's scores
  q_I k_J^T leave the last 64-wide slice of N out),
  ``wide_ragged_p_tile_dropped`` (the backward's dv kernel is launched over
  the whole 64-column tiles of P only, so the ragged last tile -- the
  mLSTM's normalizer column -- is never written);
- tiered_matmul (its checks at the serving shapes in both dtypes, the
  edge cases and those behind a NaN fill of shared memory):
  ``split_partial_dropped`` (the merge leaves the first K split's partial
  out), ``empty_barrier_not_awaited`` (the producer refills a ring stage
  before the consumers release it), ``last_k_tile_skipped`` (the ragged
  last 64-row stage of K is not read), ``ragged_n_unmasked`` (columns past
  N of the last tile are written);
- tiered_matmul's expert route (its checks at moonshot-v1-16b-a3b's and
  dbrx-132b's decode shapes and the edge cases, both dtypes):
  ``expert_index_ignored`` (every slot's weight tiles come from expert 0),
  ``group_rows_capped_at_8`` (an expert's rows past its first tile are
  never computed), ``ranks_restart_every_32_rows`` (an expert's rows are
  ranked within each warp-wide chunk of 32 rows only, so past row 31 the
  tiles take the wrong rows).
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FLASH = "src/repro_torch/csrc/flash_attention.cu"
DECODE = "src/repro_torch/csrc/decode_attention.cu"
SSD_FWD = "src/repro_torch/csrc/ssd_scan.cu"
SSD_BWD = "src/repro_torch/csrc/ssd_scan_bwd.cu"
MATMUL = "src/repro_torch/csrc/tiered_matmul.cu"
# name: (source, text, replacement, checks)
MUTANTS = {
    "corr_dropped": (FLASH, "        corr[h] = exp2f(m[h] * sl2 - base[h]);",
                     "        corr[h] = 1.f;", "flash"),
    "last_partial_tile_skipped": (
        FLASH, "  const int n_tiles = (k_end + kN - 1) / kN;",
        "  const int n_tiles = k_end / kN;", "flash"),
    "diagonal_mask_dropped": (
        FLASH,
        "          if (kp >= T || (a.causal && kp > qpos[(v >> 1) & 1]))",
        "          if (kp >= T)", "flash"),
    "group_split_fixed_8": (
        FLASH, "const int qpos[2] = {(r0 + ra) / G, (r0 + ra + 8) / G};",
        "const int qpos[2] = {(r0 + ra) / min(G, 8), "
        "(r0 + ra + 8) / min(G, 8)};", "flash"),
    "merge_weight_dropped": (
        DECODE,
        "      const float w = mx == -INFINITY ? 0.f : exp2f(wgt[s][g] - mx);",
        "      const float w = 1.f;", "decode"),
    "newest_row_dropped": (
        DECODE, "min(a.length, t_begin + a.rows_per_split)",
        "min(a.length - 1, t_begin + a.rows_per_split)", "decode"),
    "split_partial_step_skipped": (
        DECODE, "  const int n_steps = (n_rows + R - 1) / R;",
        "  const int n_steps = n_rows / R;", "decode"),
    "running_max_rescale_dropped": (
        DECODE, "      const float corr = exp2f(m[g] - m_new);",
        "      const float corr = 1.f;", "decode"),
    "uncopied_chunks_read": (
        DECODE, "      if (li + lanes * j < c16) {", "      if (true) {",
        "decode"),
    "dloga_inter_chunk_dropped": (
        SSD_BWD, "      if (J == 0)\n        f += (double)ecum[I * kT + x]",
        "      if (false)\n        f += (double)ecum[I * kT + x]", "ssd_bwd"),
    "chunk_sum_dropped": (
        SSD_BWD, "        ds = fma(d[j], ds, u[j]);", "        ds = d[j] * ds;",
        "ssd_bwd"),
    "tf32_lo_terms_dropped": (
        SSD_BWD, "constexpr bool kSplit = true;",
        "constexpr bool kSplit = false;", "ssd_bwd"),
    "ring_stage_overwritten": (
        SSD_BWD, "if (more) issue(In, Jn, (step + 1) & 1, Jn != J);",
        "if (more) issue(In, Jn, step & 1, Jn != J);", "ssd_bwd"),
    "fwd_carry_decay_dropped": (
        SSD_FWD, "        s = fma(d[j], s, u[j]);", "        s += u[j];",
        "ssd_fwd"),
    "fwd_tf32_lo_terms_dropped": (
        SSD_FWD, "constexpr bool kSplit = true;",
        "constexpr bool kSplit = false;", "ssd_fwd"),
    "fwd_inter_chunk_dropped": (
        SSD_FWD, "    tile_product<false>(y, q_, m0, S_, kN8, 8);",
        "    zero_blk(y);", "ssd_fwd"),
    "fwd_tile_slot_overwritten": (
        SSD_FWD, "copy_tile(tiles + slot * kTile, src,",
        "copy_tile(tiles + (slot > slot_v(1) ? slot - 6 : slot) * kTile, src,",
        "ssd_fwd"),
    "wide_last_n_slice_dropped": (
        SSD_FWD, "ring((a.N + kT - 1) / kT, issue",
        "ring((a.N - 1) / kT, issue", "ssd_wide"),
    "wide_ragged_p_tile_dropped": (
        SSD_BWD, "ssd_bwd_dv_kernel<<<dim3(cg, nT, ptiles)",
        "ssd_bwd_dv_kernel<<<dim3(cg, nT, P / kT)", "ssd_wide"),
    "split_partial_dropped": (
        MATMUL, "      v[p] = p < n_split ?", "      v[p] = 0 < p && p < n_split ?",
        "matmul"),
    "empty_barrier_not_awaited": (
        MATMUL,
        "        mbar_wait_bounded(&empty[st], ((i / kStages) & 1) ^ 1);\n",
        "", "matmul"),
    "last_k_tile_skipped": (
        MATMUL, "  const int kt_total = (a.K + kBK - 1) / kBK;",
        "  const int kt_total = a.K / kBK;", "matmul"),
    "ragged_n_unmasked": (
        MATMUL, "min(kBN, a.N - n0)", "kBN", "matmul"),
    "expert_index_ignored": (
        MATMUL, "(kt0 + i) * kBK, ex,", "(kt0 + i) * kBK, 0,", "experts"),
    "group_rows_capped_at_8": (
        MATMUL, "const int tiles = (counts[e] + tm - 1) / tm;",
        "const int tiles = min(counts[e], 1);", "experts"),
    "ranks_restart_every_32_rows": (
        MATMUL, "      seen += __popc(ballot);\n", "", "experts"),
}
_HEAD = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(42)
'''
_SSD = r'''
cases = [(c, False) for c in [
    (2, 3, 512, 64, 64, 256, False), (2, 3, 300, 32, 64, 128, False),
    (2, 3, 256, 16, 16, 256, False), (1, 4, 1000, 64, 64, 256, True),
    (1, 2, 130, 6, 12, 64, True)]]
cases += [(c, True) for c in cs._ssd_stale_cases()]
for c, stale in cases:
    row = cs._ssd_case(None, *c, "near1", gen, stale_nan=stale)[ROW]
    print(json.dumps(dict(case=c, stale_nan=stale, ok=row["ok"],
                          err=row["max_abs_err"],
                          same=row["bit_identical_rerun"])), flush=True)
'''
CHECKS = {
    # chip_smoke.py's bf16 flash check cases, bar the training shape
    "flash": _HEAD + r'''
timer = cs.Timer()
for c in [(1, 1, 1, 128, 128, 128, True), (1, 1, 1, 128, 128, 128, False),
          (2, 2, 2, 256, 256, 128, True), (1, 2, 4, 128, 384, 128, True),
          (1, 2, 4, 128, 300, 128, False), (2, 1, 4, 24, 24, 16, True),
          (1, 1, 8, 300, 300, 256, True), (1, 1, 8, 128, 384, 256, True),
          (1, 32, 1, 512, 512, 64, True), (1, 1, 8, 300, 300, 256, True, 8.0),
          (1, 32, 1, 512, 512, 64, True, 8.0),
          (1, 2, 4, 128, 300, 128, False, 8.0),
          (1, 2, 16, 300, 300, 128, True),
          (1, 2, 16, 300, 300, 128, True, 8.0)]:
    fwd, _ = cs._flash_case(timer, torch.bfloat16, *c[:7], gen, *c[7:])
    print(json.dumps(dict(case=c, ok=fwd["ok"], err=fwd["max_abs_err"],
                          lse_err=fwd["lse_max_abs_err"])), flush=True)
''',
    # chip_smoke.py's decode check cases, untimed, and those behind a NaN
    # fill of shared memory
    "decode": _HEAD + r'''
cases = []
for dt in (torch.float32, torch.bfloat16):
    cases += [(dt, 2, 2, 4, 128, 1024, 700, False),
              (dt, 2, 2, 4, 128, 700, 650, False),
              (dt, 2, 2, 4, 128, 2048, 1, False)]
    cases += [(dt, 4, 1, 8, 256, 1024, n, True) for n in (1, 160, 1024)]
    cases += [(dt, 4, 32, 1, 64, 1024, n, True) for n in (1, 160, 1024)]
    cases += [(dt, 2, 2, 16, 128, 1024, n, True) for n in (1, 33, 161, 1024)]
    cases += [(dt, 4, K, G, 128, 1024, n, True) for K, G in ((4, 8), (2, 16))
              for n in (1, 160, 1024)]
for c in cases:
    r = cs._decode_case(None, *c, gen)
    print(json.dumps(dict(case=str(c), ok=r["ok"], err=r["max_abs_err"])),
          flush=True)
for n in (160, 1024):
    r = cs._decode_case(None, torch.bfloat16, 4, 32, 1, 64, 1024, n, True,
                        gen, peak=8.0, against="float64")
    print(json.dumps(dict(case=f"peaked zamba2 {n}", ok=r["ok"],
                          err=r["max_abs_err"])), flush=True)
for r in cs._stale_shared_cases(gen):
    print(json.dumps(dict(case="stale NaN " + str(r["shape"]), ok=r["ok"],
                          err=r["max_abs_err"])), flush=True)
''',
    # chip_smoke.py's tiered_matmul check cases, untimed: the reference
    # tests' shapes and the serving products in both dtypes, the edge
    # cases and those behind a NaN fill of shared memory
    "matmul": _HEAD + r'''
gemma, zamba = cs._path_products()
shapes = [(256, 512, 256), (300, 700, 500), (128, 128, 128)]
shapes += [(4, K, N) for _, K, N in gemma + zamba]
shapes += [(4, K, N) for arch in ("yi-6b", "chatglm3-6b")
           for _, K, N in cs._layer_products(cs.get_config(arch))]
rows = [cs._matmul_case(None, dt, M, K, N, gen)
        for dt in (torch.float32, torch.bfloat16) for M, K, N in shapes]
for r in rows + cs._matmul_edge_cases(gen):
    print(json.dumps(dict(case=str(r["shape"]), dtype=r["dtype"], ok=r["ok"],
                          err=r["max_abs_err"],
                          same=r["bit_identical_rerun"])), flush=True)
''',
    # chip_smoke.py's expert-route cases, untimed
    "experts": _HEAD + r'''
for r in cs._experts_cases(None, gen):
    print(json.dumps(dict(case=str(r["shape"]), dtype=r["dtype"], ok=r["ok"],
                          err=r["max_abs_err"],
                          same=r["bit_identical_rerun"])), flush=True)
''',
    # chip_smoke.py's SSD check cases with decays near 1, bar the training
    # shape, and those behind a NaN fill of shared memory: the backward's
    # rows ("ssd_bwd") or the forward's ("ssd_fwd")
    "ssd_bwd": _HEAD + _SSD.replace("ROW", "1"),
    "ssd_fwd": _HEAD + _SSD.replace("ROW", "0"),
    # chip_smoke.py's SSD cases of the wide route, decays near 1, then
    # behind a NaN fill of shared memory: the forward's and the backward's
    # rows
    "ssd_wide": _HEAD + r'''
for c in cs.SSD_WIDE_CASES:
    for stale in (False, True):
        for row in cs._ssd_case(None, *c, "near1", gen, stale_nan=stale):
            print(json.dumps(dict(case=c, kernel=row["kernel"],
                                  stale_nan=stale, ok=row["ok"],
                                  err=row["max_abs_err"])), flush=True)
''',
}


def main() -> int:
    names = sys.argv[1:] or list(MUTANTS)
    caught = 0
    for name in names:
        src, old, new, checks = MUTANTS[name]
        copy = os.path.join(ROOT, "build", "mutants", name)
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src"), os.path.join(copy, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
        path = os.path.join(copy, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            print(f"chip_mutants: {name}: the line to replace is not in "
                  f"{src} once", file=sys.stderr)
            return 1
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        run = subprocess.run([sys.executable, "-c", CHECKS[checks]], cwd=copy,
                             capture_output=True, text=True, timeout=600)
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith("{")]
        failed = [r for r in rows if not r["ok"]]
        caught += bool(failed) or run.returncode != 0
        print(json.dumps(dict(mutant=name, source=src, rc=run.returncode,
                              checks=len(rows), failed=len(failed),
                              failing=failed[:6],
                              error=[line for line in
                                     run.stderr.splitlines()
                                     if "Error" in line][-1:],
                              stderr=run.stderr[-300:] if run.returncode
                              else "")), flush=True)
    return 0 if caught == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
