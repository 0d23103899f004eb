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

- bf16 flash-attention forward (the flash checks, bar the training shape;
  phi-3-vision-4.2b's D 96 and nemotron-4-340b's G 12, D 192 among them):
  ``corr_dropped`` (the online softmax never rescales),
  ``last_partial_tile_skipped`` (a key tile that ends past k_end is not
  loaded), ``diagonal_mask_dropped`` (keys past a row's position are not
  masked), ``group_split_fixed_8`` (a stacked row's position is taken as
  row / 8 where row / G belongs: right up to G 8, so only the G 16 checks
  see it);
- bf16 flash-attention forward at the dry run's lengths (the flash pair at
  each train cell's fitted microbatch, q x 8, and the forward at each
  prefill cell's shape on three query tiles; the fitted rows at q x 1 are
  printed beside them as ``peak1_ok`` and decide nothing):
  ``long_key_tile_dropped`` (key tile 1 left out of every block that
  reads more than 16 key tiles: unseen at the short checks' lengths);
- decode attention (the decode checks at the serving shapes, phi-3-
  vision-4.2b's D 96 and nemotron-4-340b's G 12, D 192 among them, G =
  16, peaked scores and behind a NaN fill of shared memory): ``merge_weight_dropped`` (the splits' partials are
  summed without exp(m_split - m)), ``newest_row_dropped`` (row
  ``length - 1`` is never read), ``split_partial_step_skipped`` (a split's
  last partial step, the rows past its last whole step of R rows, is not
  read), ``running_max_rescale_dropped`` (acc and l are never rescaled
  when the running max grows), ``uncopied_chunks_read`` (a lane's chunks
  past D, which no cp.async wrote, are read from the ring as if copied);
- decode attention at the main path's longest reads (gemma-2b's and
  chatglm3-6b's decode_32k shapes over an e4m3 cache, zamba2-1.2b's
  long_500k over a bf16 one, fp32 and bf16 q; the bf16 rows also against
  float64): ``merge_split_dropped`` (the merge leaves the second split's
  partial out of the output, its weight still in the normaliser);
- decode attention's e4m3 route (its checks: gemma-2b's serving shape
  and the other configs' G and D, lengths 0 and 1, the NaN encoding inside
  and past the valid rows, behind a NaN fill of shared memory, every
  finite e4m3 code in K and V, and the C entry point refusing rows of 8
  and 24 bytes): ``e4m3_bias_off_by_one`` (every decoded value halved, as
  an exponent bias of 8 where e4m3 has 7 gives), ``e4m3_nan_decoded_as_
  number`` (the decode by bit operations with no NaN case: S.1111.111 as
  +-480), ``e4m3_element_size_2`` (the launcher takes an e4m3 element for
  2 bytes, as the bf16 route's: the tensor maps' strides double),
  ``e4m3_second_head_tile_dropped`` (the values' product leaves heads 8-15
  out), ``e4m3_rows_past_end_weighted`` (rows at or past a split's end
  keep their scores), ``e4m3_tile_into_next_stage`` (a tile's copies land
  in the ring stage of the next tile, while its own stage's barrier
  completes), ``e4m3_pair_exchange_dropped`` (a warp pair's two halves of
  the scores are not summed);
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
- tiered_matmul (its checks at the serving shapes in both dtypes, at the
  dry run's M = 128 products in bf16, the edge cases -- the wgmma route's
  threshold, ragged M, K and N among them -- and those behind a NaN fill
  of shared memory; each tensor-core case also launched into a buffer
  whose rows past M must stay untouched):
  ``split_partial_dropped`` (the merge leaves the first K split's partial
  out), ``empty_barrier_not_awaited`` (the producer refills a ring stage
  before the consumers release it), ``last_k_tile_skipped`` (the ragged
  last 64-row stage of K is not read), ``ragged_n_unmasked`` (columns past
  N of the last tile are written); of its warpgroup kernel
  (``tiered_wgmma_kernel``): ``wgmma_second_warpgroup_dropped`` (both
  warpgroups read x's first 64 rows, so rows 64-127 of a tile are rows
  0-63's), ``wgmma_stage_released_early`` (a stage is released as soon as
  its products are issued, before the wgmma_wait that retires them),
  ``wgmma_last_k_stage_skipped`` (the last 64-row stage of K is never
  read), ``wgmma_rows_past_m_stored`` (the merge stores all 128 rows of
  the last row tile, past M), ``wgmma_x_from_next_slot`` (x's tile is read
  from the next ring slot), ``wgmma_split_partial_dropped`` (the K splits'
  merge leaves the first split's partial out);
- tiered_matmul's expert route (its checks at moonshot-v1-16b-a3b's and
  dbrx-132b's decode shapes and the edge cases, both dtypes):
  ``expert_index_ignored`` (every slot's weight tiles come from expert 0),
  ``group_rows_capped_at_8`` (an expert's rows past its first tile are
  never computed), ``ranks_restart_every_32_rows`` (an expert's rows are
  ranked within each warp-wide chunk of 32 rows only, so past row 31 the
  tiles take the wrong rows);
- the knapsack DP (chip_smoke.py's knapsack checks: both routes, the
  tie-heavy case, sizes past the capacity and of 0, sizes that cross one
  and two ranks, last ranks full, short and empty, clusters of 1 to 16
  ranks, behind a NaN fill of shared memory): ``tie_breaks_to_new``
  (``>=`` where the DP takes an item only on ``>``), ``bit_order_reversed``
  (each packed byte's bits in the other order: column c at bit c & 7),
  ``oversize_item_applied`` (the guard of sizes past the capacity dropped,
  so 2^32 + 3 is narrowed to 3 and applied, and 2^31 + 7 reads out of
  range); of route 1's cluster: ``item_barrier_removed`` (no rank waits for
  the others' last item before it reads their buffers and overwrites its
  own), ``barrier_counts_one_rank`` (the items' mbarriers complete on the
  first rank's arrival), ``remote_reads_from_own_block`` (a column whose c
  - s lies in another rank reads this rank's buffer at that offset),
  ``parity_not_flipped`` (every item reads the same buffer and writes the
  other), ``last_rank_columns_dropped`` (a short last rank takes no
  column), ``bytes_at_rank0_offset`` (every rank stores its keep bytes
  where rank 0's go), ``exit_barrier_removed`` (a block leaves without
  waiting for the last item's arrivals: others still read its buffers and
  arrive on its mbarriers).
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
KNAPSACK = "src/repro_torch/csrc/knapsack_dp.cu"
# the e4m3 route's decode, as it stands in decode_attention.cu
E4M3_DECODE = (
    '  asm("{\\n.reg .b16 l, h;\\nmov.b32 {l, h}, %2;\\n"\n'
    '      "cvt.rn.f16x2.e4m3x2 %0, l;\\ncvt.rn.f16x2.e4m3x2 %1, h;\\n}\\n"\n'
    '      : "=r"(lo), "=r"(hi) : "r"(w));')
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
    "long_key_tile_dropped": (
        FLASH, "      // online softmax on the fp32 scores\n",
        "      if (i == 1 && n_tiles > 16)\n"
        "        for (int v = 0; v < kN / 2; ++v) s[v] = -INFINITY;\n"
        "      // online softmax on the fp32 scores\n", "flash_long"),
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
    "merge_split_dropped": (
        DECODE, "      if (s < n_split) {", "      if (s < n_split && s != 1) {",
        "decode_long"),
    # the decode: the card's conversion, then each value halved (what an
    # exponent bias of 8 gives)
    "e4m3_bias_off_by_one": (
        DECODE, E4M3_DECODE,
        E4M3_DECODE + "\n"
        "  const __half2 half2 = __float2half2_rn(0.5f);\n"
        "  __half2 l2 = __hmul2(*reinterpret_cast<__half2*>(&lo), half2);\n"
        "  __half2 h2 = __hmul2(*reinterpret_cast<__half2*>(&hi), half2);\n"
        "  lo = *reinterpret_cast<uint32_t*>(&l2);\n"
        "  hi = *reinterpret_cast<uint32_t*>(&h2);", "decode_e4m3"),
    # the decode by bit operations with no NaN case: S.1111.111 as +-480
    "e4m3_nan_decoded_as_number": (
        DECODE, E4M3_DECODE,
        "  const uint32_t x = __byte_perm(w, 0, 0x3120);\n"
        "  const uint32_t x8 = x << 8;\n"
        "  lo = (x8 & 0x80008000u) | ((x8 & 0x7F007F00u) >> 1);\n"
        "  hi = (x & 0x80008000u) | ((x & 0x7F007F00u) >> 1);\n"
        "  const __half2 s256 = __float2half2_rn(256.f);\n"
        "  __half2 l2 = __hmul2(*reinterpret_cast<__half2*>(&lo), s256);\n"
        "  __half2 h2 = __hmul2(*reinterpret_cast<__half2*>(&hi), s256);\n"
        "  lo = *reinterpret_cast<uint32_t*>(&l2);\n"
        "  hi = *reinterpret_cast<uint32_t*>(&h2);", "decode_e4m3"),
    "e4m3_element_size_2": (
        DECODE, "    case 2: return 1;", "    case 2: return 2;",
        "decode_e4m3"),
    "e4m3_second_head_tile_dropped": (
        DECODE, "for (int nt = 0; nt < kNT; ++nt)   // every head tile",
        "for (int nt = 0; nt < 1; ++nt)   // every head tile", "decode_e4m3"),
    "e4m3_rows_past_end_weighted": (
        DECODE,
        "const bool v0 = 16 * sl + g < nv, v1 = 16 * sl + g + 8 < nv;",
        "const bool v0 = true, v1 = true;", "decode_e4m3"),
    "e4m3_tile_into_next_stage": (
        DECODE, "    char* kt = ring + s * 2 * tile_bytes;\n",
        "    char* kt = ring + (i + 1) % S * 2 * tile_bytes;\n", "decode_e4m3"),
    "e4m3_pair_exchange_dropped": (
        DECODE, "            sc[0][0][nt][e] += theirs[nt * 4 + e][lane];",
        "            sc[0][0][nt][e] += 0.f;", "decode_e4m3"),
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
    "wgmma_second_warpgroup_dropped": (
        MATMUL, "const uint32_t xa = base + wg * (64 * 128);",
        "const uint32_t xa = base;", "matmul"),
    "wgmma_stage_released_early": (
        MATMUL,
        "      hopper::wgmma_wait<1>();\n"
        "      if (s > 0 && lane == 0)\n"
        "        hopper::mbar_arrive(&empty[(s - 1) % kWgStages]);\n",
        "      if (lane == 0) hopper::mbar_arrive(&empty[slot]);\n"
        "      hopper::wgmma_wait<1>();\n", "matmul"),
    "wgmma_last_k_stage_skipped": (
        MATMUL, "  const int k_tiles = (a.K + kBK - 1) / kBK;",
        "  const int k_tiles = (a.K - 1) / kBK;", "matmul"),
    "wgmma_rows_past_m_stored": (
        MATMUL, "  const int m_rows = min(kWgRows, a.M - row0);",
        "  const int m_rows = kWgRows;", "matmul"),
    "wgmma_split_partial_dropped": (
        MATMUL, "        v[b][p] = live && p < n_split",
        "        v[b][p] = live && 0 < p && p < n_split", "matmul"),
    "wgmma_x_from_next_slot": (
        MATMUL, "const uint32_t xa = base + wg * (64 * 128);",
        "const uint32_t xa = hopper::smem_addr(ring + (slot + 1) % kWgStages"
        " * kWgStageBytes) + wg * (64 * 128);", "matmul"),
    "expert_index_ignored": (
        MATMUL, "(kt0 + i) * kBK, ex,", "(kt0 + i) * kBK, 0,", "experts"),
    "group_rows_capped_at_8": (
        MATMUL, "const int tiles = (counts[e] + tm - 1) / tm;",
        "const int tiles = min(counts[e], 1);", "experts"),
    "ranks_restart_every_32_rows": (
        MATMUL, "      seen += __popc(ballot);\n", "", "experts"),
    "tie_breaks_to_new": (
        KNAPSACK, "  return cand > old;", "  return cand >= old;", "knapsack"),
    "bit_order_reversed": (
        KNAPSACK, "  return __byte_perm(__brev(mask), 0, 0x0123);",
        "  return mask;", "knapsack"),
    "oversize_item_applied": (
        KNAPSACK, "  return (uint64_t)s > (uint64_t)qcap;", "  return false;",
        "knapsack"),
    "item_barrier_removed": (
        KNAPSACK,
        "      if (k > 0) item_wait(bars, k - 1);  // the last item ended "
        "everywhere\n", "", "knapsack"),
    "barrier_counts_one_rank": (
        KNAPSACK, "  if (tid == 0) bars_init(bars, R);",
        "  if (tid == 0) bars_init(bars, 1);", "knapsack"),
    "remote_reads_from_own_block": (
        KNAPSACK, "load_rank(old_addr + 8u * (uint32_t)off, src)",
        "load_rank(old_addr + 8u * (uint32_t)off, rank)", "knapsack"),
    "parity_not_flipped": (KNAPSACK, "      p ^= 1;\n", "", "knapsack"),
    "last_rank_columns_dropped": (
        KNAPSACK, "const int own = max(0, min(width, cells - start));",
        "const int own = start + width <= cells ? width : 0;", "knapsack"),
    "bytes_at_rank0_offset": (
        KNAPSACK, "store_bits(row, start + j * T + warp_c, row_bytes,",
        "store_bits(row, j * T + warp_c, row_bytes,", "knapsack"),
    "exit_barrier_removed": (
        KNAPSACK, "  if (k > 0) item_wait(bars, k - 1);\n}", "}", "knapsack"),
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
          (1, 2, 16, 300, 300, 128, True, 8.0),
          (1, 4, 1, 300, 300, 96, True), (1, 2, 12, 300, 300, 192, True),
          (1, 4, 1, 300, 300, 96, True, 8.0),
          (1, 2, 12, 300, 300, 192, True, 8.0)]:
    fwd, _ = cs._flash_case(timer, torch.bfloat16, *c[:7], gen, *c[7:])
    print(json.dumps(dict(case=c, ok=fwd["ok"], err=fwd["max_abs_err"],
                          lse_err=fwd["lse_max_abs_err"])), flush=True)
''',
    # chip_smoke.py's flash rows at the dry run's lengths: the fitted train
    # microbatches (q x 8 decides; q x 1 beside it, "peak1_ok") and the
    # prefill cells' forward on sampled query tiles
    "flash_long": _HEAD + r'''
timer = cs.Timer()
for shape in dict.fromkeys(cs._fitted_flash_shapes()):
    one = cs._flash_case(None, torch.bfloat16, *shape, True, gen)
    eight = cs._flash_case(None, torch.bfloat16, *shape, True, gen, peak=8.0)
    for a, b in zip(one, eight):
        print(json.dumps(dict(case=shape, kernel=b["kernel"], ok=b["ok"],
                              err=b["max_abs_err"], peak1_ok=a["ok"],
                              peak1_err=a["max_abs_err"])), flush=True)
    torch.cuda.empty_cache()
for cell, shape in cs._prefill_flash_shapes():
    r = cs._flash_long_case(timer, gen, cell, *shape)
    print(json.dumps(dict(case=cell, ok=r["ok"], err=r["max_abs_err"])),
          flush=True)
    torch.cuda.empty_cache()
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
    cases += [(dt, 4, K, G, D, 1024, n, True)
              for K, G, D in ((32, 1, 96), (8, 12, 192))
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
    # chip_smoke.py's e4m3 check cases, untimed: the NaN encoding, behind
    # a NaN fill of shared memory, and the C entry point's refusals
    "decode_e4m3": _HEAD + r'''
for r in cs._e4m3_cases(None, gen):
    print(json.dumps(dict(case=str(r["shape"]), dtype=r["dtype"], ok=r["ok"],
                          err=r["max_abs_err"])), flush=True)
''',
    # chip_smoke.py's decode cases at the main path's longest reads,
    # untimed; "plain_ok" is the verdict against the plain version alone
    "decode_long": _HEAD + r'''
for r in cs._long_decode_cases(None, gen):
    print(json.dumps(dict(case=str(r["shape"]), dtype=r["dtype"], ok=r["ok"],
                          err=r["max_abs_err"],
                          plain_ok=r.get("plain_ok", r["ok"]),
                          err64=r.get("float64_max_abs_err"),
                          limit64=r.get("float64_limit"))), flush=True)
''',
    # chip_smoke.py's tiered_matmul check cases, untimed: the reference
    # tests' shapes and the serving products in both dtypes, the dry run's
    # products at M = 128 in bf16, the edge cases and those behind a NaN
    # fill of shared memory
    "matmul": _HEAD + r'''
gemma, zamba = cs._path_products()
shapes = [(256, 512, 256), (300, 700, 500), (128, 128, 128)]
shapes += [(4, K, N) for _, K, N in gemma + zamba]
shapes += [(4, K, N) for arch in ("yi-6b", "chatglm3-6b", "musicgen-large",
                                  "phi-3-vision-4.2b")
           for _, K, N in cs._layer_products(cs.get_config(arch))]
rows = [cs._matmul_case(None, dt, M, K, N, gen)
        for dt in (torch.float32, torch.bfloat16) for M, K, N in shapes]
rows += [cs._matmul_case(None, torch.bfloat16, 128, K, N, gen, label,
                         want_route="wgmma")
         for label, K, N in cs._m128_products()]
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
    # chip_smoke.py's knapsack DP check cases, untimed
    "knapsack": _HEAD + r'''
for r in cs._knapsack_cases(None):
    print(json.dumps(dict(case=str(r["shape"]), ok=r["ok"],
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
