"""The knapsack DP on a device (``repro_torch.kernels.knapsack_dp`` and
``core/knapsack.py``'s ``use_device``) against the reference's DPs, run
live in the same process on the same numpy draws.

On the CPU the wrapper runs its plain version, a per-item loop of torch
ops in float64; its keep tables must be the same bytes as the reference's
numpy DP (``_numpy_dp``) and its jitted scan (``_jax_dp``), and the
planner through it must build the reference planner's plan.  The kernel
itself runs only on a card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The reference's jitted DP imports ``jax.experimental.enable_x64``, which
this jax no longer has, and then returns None and leaves the solve to
numpy (ROADMAP.md, queue 3, R6).  These tests put jax's own ``enable_x64``
context manager under that name for the test's duration, so that the scan
really runs, and check that it did.  Every test meant to run above the
device threshold asserts its filtered ``n * qcap``: the reference's own
device-DP test keeps 453 of its 600 items, 7.4M cells, under the 8M
threshold (R6).
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.core import knapsack as ref_knapsack  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.core import phase as ref_phase  # noqa: E402
from repro.core.data_objects import DataObject as RefDataObject  # noqa: E402
from repro.core.data_objects import (  # noqa: E402
    ObjectRegistry as RefObjectRegistry)
from repro_torch.core import knapsack as port_knapsack  # noqa: E402
from repro_torch.kernels import knapsack_dp as kdp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sim import planner_fixture  # noqa: E402

MB = 1024 ** 2
QCAP = 1 << 14          # the planner's grid at max_cells 16,384


@pytest.fixture
def jax_dp(monkeypatch):
    """The reference's ``_jax_dp`` with x64 under the name it imports; a
    call that returns None fails the test."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    monkeypatch.setattr(ref_knapsack, "_jax_state", None)
    dp = ref_knapsack._jax_dp

    def run(values, qsizes, qcap):
        keep = dp(values, qsizes, qcap)
        assert keep is not None, "the reference's jitted DP did not run"
        return keep
    return run


@pytest.fixture
def dp_calls(monkeypatch):
    """Calls of ``ops.knapsack_dp`` (the wrapper counts only kernel
    launches, none on the CPU), as a one-element list."""
    calls, op = [0], ops.knapsack_dp

    def counted(*args, **kwargs):
        calls[0] += 1
        return op(*args, **kwargs)
    monkeypatch.setattr(ops, "knapsack_dp", counted)
    return calls


def _reference_draw(n_items):
    """The reference's device-DP test draw (tests/test_planner_scale.py):
    random.Random(7), values U(-0.5, 2), sizes 1-4 MiB; (values, sizes)."""
    rng = random.Random(7)
    draws = [(rng.uniform(-0.5, 2.0), rng.randint(1, 4) * MB)
             for _ in range(n_items)]
    return (np.array([v for v, _ in draws], dtype=np.float64),
            np.array([s for _, s in draws], dtype=np.int64))


def _filtered(values, sizes, capacity):
    """(values, qsizes, qcap) as ``solve_arrays`` hands them to its DP."""
    keep = (values > 0.0) & (sizes <= capacity)
    qsizes, qcap = port_knapsack._quantize(sizes[keep], capacity, 1 << 14)
    return values[keep], qsizes, qcap


def _inputs(kind, n, qcap, seed):
    """As ``chip_smoke.py``'s check cases: "planner" values U(0, 1) over
    sizes of 16-256 quanta; "ties" integer values and sizes from {1, 2,
    3}; "edges" small sizes with items past the capacity and of size 0."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return (rng.integers(1, 4, n).astype(np.float64),
                rng.integers(1, 4, n).astype(np.int64))
    values = rng.uniform(1e-3, 1.0, n)
    if kind == "planner":
        return values, rng.integers(16, 257, n).astype(np.int64)
    sizes = rng.integers(0, max(qcap // 4, 1), n).astype(np.int64)
    for i, s in enumerate((qcap + 1, 0, qcap + 2, 10 ** 6, 0, 2 ** 31 + 7,
                           2 ** 32 + 3)):
        sizes[(i * 37 + 3) % n] = s
    return values, sizes


def _jax_safe(qsizes, qcap):
    """The sizes with those the jitted scan reads as a wrapped slice (qcap
    + 2 to 3 (qcap + 1), R7) set to qcap + 1: each such item fits no
    column in the numpy DP either, so its row and the table stay the
    same."""
    out = qsizes.copy()
    out[(out >= qcap + 2) & (out <= 3 * (qcap + 1))] = qcap + 1
    return out


def _plain(values, qsizes, qcap):
    return kdp.knapsack_dp_plain(torch.from_numpy(values),
                                 torch.from_numpy(qsizes), qcap).numpy()


# The check phase's cases at tier-1 sizes: the planner's item counts at a
# tenth of its grid, the reference draw and n 489 at the grid itself.
CASES = [("planner", n, qcap, 10 + i) for i, (n, qcap) in enumerate(
    ((489, QCAP), (489, 1638), (1000, 1638), (2000, 1638), (3051, 1638)))]
CASES += [("planner", 40, 20_000, 20),       # 20,001 cells: 16 ranks of 1,280
          ("planner", 70, 1000, 21),         # 1,001 cells: no multiple of 8
          ("edges", 300, 1000, 22), ("edges", 40, 0, 23),
          ("planner", 1, QCAP, 24), ("edges", 1, 7, 25),
          ("ties", 2000, 1500, 26), ("ties", 300, QCAP, 27)]


@pytest.mark.parametrize("kind,n,qcap,seed", CASES)
def test_plain_keep_table_is_both_reference_dps_bytes(jax_dp, kind, n, qcap,
                                                      seed):
    values, qsizes = _inputs(kind, n, qcap, seed)
    keep = _plain(values, qsizes, qcap)
    assert keep.shape == (n, (qcap + 8) // 8) and keep.dtype == np.uint8
    np.testing.assert_array_equal(
        keep, ref_knapsack._numpy_dp(values, qsizes, qcap))
    safe = _jax_safe(qsizes, qcap)
    np.testing.assert_array_equal(_plain(values, safe, qcap),
                                  jax_dp(values, safe, qcap))


def test_plain_keep_table_on_the_grown_reference_draw(jax_dp):
    """The reference test's draw grown from 600 to 800 items: 617 keep a
    positive value, 10.1M cells, above the device threshold."""
    values, qsizes, qcap = _filtered(*_reference_draw(800), 256 * MB)
    assert len(values) * qcap >= port_knapsack._DEVICE_MIN_WORK
    keep = _plain(values, qsizes, qcap)
    np.testing.assert_array_equal(
        keep, ref_knapsack._numpy_dp(values, qsizes, qcap))
    np.testing.assert_array_equal(keep, jax_dp(values, qsizes, qcap))


def test_jax_dp_reads_a_wrapped_slice_past_the_capacity_r7(jax_dp):
    """R7: an item of qcap + 2 quanta takes every column in the reference's
    jitted scan (lax.dynamic_slice wraps the negative start), none in its
    numpy DP; the port follows the numpy DP.  solve_arrays never passes
    such a size: a size within the capacity quantizes to <= qcap + 1."""
    qcap = 20
    values = np.array([1.0, 2.0, 3.0])
    qsizes = np.array([3, qcap + 2, 4], dtype=np.int64)
    numpy_keep = ref_knapsack._numpy_dp(values, qsizes, qcap)
    jax_keep = jax_dp(values, qsizes, qcap)
    assert not np.unpackbits(numpy_keep[1]).any()
    assert np.unpackbits(jax_keep[1])[:qcap + 1].all()
    np.testing.assert_array_equal(_plain(values, qsizes, qcap), numpy_keep)


@pytest.mark.parametrize("n_items", [800, 1200])
def test_solve_arrays_on_the_device_path_selects_the_reference_items(
        monkeypatch, dp_calls, n_items):
    values, sizes = _reference_draw(n_items)
    cap = 256 * MB
    pvals, _, qcap = _filtered(values, sizes, cap)
    assert len(pvals) * qcap >= port_knapsack._DEVICE_MIN_WORK
    monkeypatch.setattr(port_knapsack, "use_device", True)
    monkeypatch.setattr(port_knapsack, "dp_device", "cpu")
    idx = port_knapsack.solve_arrays(values, sizes, cap)
    assert dp_calls[0] == 1
    items = [ref_knapsack.Item(f"o{i}", float(v), int(s))
             for i, (v, s) in enumerate(zip(values, sizes))]
    assert [items[i].name for i in idx] == \
        ref_knapsack.solve_reference(items, cap)


def test_reference_device_dp_test_stays_under_the_threshold_r6(
        monkeypatch, dp_calls):
    """R6: the reference's device-DP test (600 items) keeps 453, 7,421,952
    cells, so with the switch on its solve still runs the numpy DP."""
    values, sizes = _reference_draw(600)
    pvals, _, qcap = _filtered(values, sizes, 256 * MB)
    assert (len(pvals), len(pvals) * qcap) == (453, 7_421_952)
    monkeypatch.setattr(port_knapsack, "use_device", True)
    monkeypatch.setattr(port_knapsack, "dp_device", "cpu")
    port_knapsack.solve_arrays(values, sizes, 256 * MB)
    assert dp_calls[0] == 0


def _reference_chunk_fixture(n_objs, n_phases=12, seed=0):
    """The reference's own chunk fixture (tests/test_policy.py
    ``build_chunk_fixture``) on the reference's modules."""
    rng = random.Random(seed)
    reg = RefObjectRegistry()
    per = n_objs // 10
    for p in range(10):
        for k in range(per):
            reg.register(RefDataObject(
                name=f"par{p}#{k}", size_bytes=rng.randint(1, 4) * MB,
                parent=f"par{p}", chunk_index=k))
    refs, times = [], []
    for _ in range(n_phases):
        r = {f"par{p}": rng.uniform(1e5, 1e7) for p in range(10)
             if rng.random() < 0.7}
        refs.append(r)
        times.append(rng.uniform(0.01, 0.2))
    graph = ref_core.build_phase_graph(
        [(f"ph{i}", rr) for i, rr in enumerate(refs)], times=times)
    machine = ref_core.PAPER_DRAM_NVM.scaled(bw_scale=0.5, lat_scale=2.0)
    prof = ref_core.PhaseProfiler(machine, seed=seed)
    for i, rr in enumerate(refs):
        prof.observe(ref_phase.PhaseTraceEvent(i, times[i], dict(rr)))
    prof.annotate_graph(graph)
    ref_partition.resplit_refs(graph, reg)
    planner = ref_core.Planner(machine, reg, ref_core.CalibrationConstants(),
                               256 * MB)
    local = planner.plan_local(graph, prof)
    glob = planner.plan_global(graph, prof)
    return ref_core.PlanProgram.from_plan(
        local, policy="unimem", provenance=[], profile_epoch=prof.epoch,
        chunk_generation=reg.generation, capacity_bytes=256 * MB,
        phase_decisions=local.phase_decisions,
        global_contribs=glob.global_contribs,
        graph_digest=local.graph_digest)


def test_planner_with_the_device_dp_builds_the_reference_plan(
        monkeypatch, jax_dp, dp_calls):
    """700 chunks: the global search's knapsack is 700 items over 16,384
    cells (11.5M), above the threshold; the port plans it through its DP
    on the CPU, the reference through its jitted scan (``use_jax``)."""
    cells, quantize = [], port_knapsack._quantize

    def counted(sizes, capacity, max_cells):
        out = quantize(sizes, capacity, max_cells)
        cells.append(len(sizes) * out[1])
        return out
    monkeypatch.setattr(port_knapsack, "_quantize", counted)
    monkeypatch.setattr(port_knapsack, "use_device", True)
    monkeypatch.setattr(port_knapsack, "dp_device", "cpu")
    fx = planner_fixture.build_chunk_fixture(700)
    port = planner_fixture.plan_program(*fx[:3], 256 * MB)
    above = [c for c in cells if c >= port_knapsack._DEVICE_MIN_WORK]
    assert above and max(cells) <= 50_000_000
    assert dp_calls[0] == len(above)

    jax_runs = [0]

    def ran(*args):
        jax_runs[0] += 1
        return jax_dp(*args)
    monkeypatch.setattr(ref_knapsack, "_jax_dp", ran)
    monkeypatch.setattr(ref_knapsack, "use_jax", True)
    ref = _reference_chunk_fixture(700)
    assert jax_runs[0] == len(above)
    assert port.to_json() == ref.to_json()
    assert isinstance(port, port_core.PlanProgram)


# ------------------------------------------- route 1's cluster layout
LAYOUT_GRIDS = [0, 7, 1000, 4095, 16_383, QCAP, 16_415, 100_000,
                kdp.ROUTE1_CELLS - 1]


def _plans(qcap):
    """The default plan of a grid and every cluster size that holds it."""
    plans = [kdp.cluster_plan(qcap)]
    for r in range(1, kdp.MAX_RANKS + 1):
        try:
            plans.append(kdp.cluster_plan(qcap, r))
        except ValueError:
            assert ((qcap + r) // r + 31) // 32 * 32 > kdp.MAX_WIDTH
    return plans


@pytest.mark.parametrize("qcap", LAYOUT_GRIDS)
def test_cluster_plan_covers_every_cell_once(qcap):
    """Every column of the grid belongs to one thread of one rank; rank
    starts are multiples of 32, so a warp's 32 columns are 4 whole keep
    bytes of one rank; at most 16 ranks of at most 1,024 threads."""
    cells = qcap + 1
    for plan in _plans(qcap):
        assert 1 <= plan.ranks <= kdp.MAX_RANKS
        assert plan.width % 32 == 0 and plan.threads % 32 == 0
        assert 64 <= plan.threads <= kdp.MAX_RANK_THREADS
        workers = plan.threads - 32
        owner = np.zeros(plan.ranks * plan.width, dtype=np.int64)
        for r in range(plan.ranks):
            start = r * plan.width
            assert start % 32 == 0
            for j in range(plan.cols):
                col = j * workers + np.arange(workers)
                col = col[col < plan.width]
                assert len(col) % 32 == 0      # whole warps in the rank
                np.add.at(owner, start + col, 1)
        assert (owner[:cells] == 1).all(), plan
        assert plan.ranks * plan.width >= cells


@pytest.mark.parametrize("qcap", LAYOUT_GRIDS)
def test_cluster_plan_fits_a_blocks_shared_memory(qcap):
    for plan in _plans(qcap):
        assert plan.smem == kdp.BAR_BYTES + 2 * plan.width * 8
        assert plan.smem <= kdp.MAX_SMEM == 232_448
    assert kdp.cluster_plan(qcap).ranks == kdp.pick_ranks(qcap)


def test_cluster_plan_refuses_what_no_cluster_holds():
    with pytest.raises(ValueError, match="past"):
        kdp.cluster_plan(kdp.ROUTE1_CELLS)
    with pytest.raises(ValueError, match="past"):
        kdp.cluster_plan(QCAP, 1)             # 2 x 16,416 doubles
    for ranks in (0, 17):
        with pytest.raises(ValueError, match="out of"):
            kdp.cluster_plan(QCAP, ranks)


def test_small_grids_run_on_few_ranks_and_the_planners_on_16():
    assert [kdp.pick_ranks(q) for q in (0, 7, 1000)] == [1, 1, 4]
    assert kdp.pick_ranks(4095) == 16
    assert kdp.pick_ranks(QCAP) == kdp.pick_ranks(100_000) == 16


def test_pick_route_takes_route_1_up_to_its_cells_and_route_2_past():
    assert kdp.ROUTE1_CELLS == 16 * kdp.MAX_WIDTH == 231_936
    for qcap in (0, QCAP, 100_000, kdp.ROUTE1_CELLS - 1):
        assert kdp.pick_route(qcap) == 1
        kdp.cluster_plan(qcap)
    for qcap in (kdp.ROUTE1_CELLS, 250_000, 10 ** 6):
        assert kdp.pick_route(qcap) == 2


@pytest.mark.parametrize("qcap,ranks", [(QCAP, 16), (QCAP, 2), (16_415, 16),
                                        (16_383, 16), (1000, 3)])
def test_source_rank_and_offset_are_direct_indexing(qcap, ranks):
    """Where column c of rank r reads table[c - s] (the kernel's ``relax``,
    mirrored by ``kdp.source``), held against direct indexing of a numpy
    table cut into the ranks' columns."""
    plan = kdp.cluster_plan(qcap, ranks)
    W, cells = plan.width, qcap + 1
    table = np.random.default_rng(ranks).uniform(size=ranks * W)
    per_rank = table.reshape(ranks, W)
    for s in (0, 1, W - 1, W, 2 * W + 5, qcap):
        for c in range(cells):
            r, col = divmod(c, W)
            src, off = kdp.source(r, col, s, W)
            if c < s:
                assert src < 0
                continue
            assert 0 <= off < W and src in (r - s // W, r - s // W - 1)
            assert per_rank[src, off] == table[c - s]


def _emulate_cluster(values, qsizes, qcap, ranks):
    """Route 1's algorithm on the host: each rank's registers and two
    buffers, reads through ``kdp.source``, the strict compare, each warp's
    ballot stored at its rank's offset; the keep table."""
    plan = kdp.cluster_plan(qcap, ranks)
    R, W, cells = plan.ranks, plan.width, qcap + 1
    reg = np.zeros((R, W))
    bufs = np.zeros((2, R, W))
    keep = np.zeros((len(values), (qcap + 8) // 8), dtype=np.uint8)
    cols = np.arange(W)
    p = 0
    for i, (s, v) in enumerate(zip(qsizes.tolist(), values.tolist())):
        if s < 0 or s > qcap:
            continue
        bits = np.zeros(R * W, dtype=bool)
        for r in range(R):
            own = max(0, min(W, cells - r * W))
            src, off = np.vectorize(kdp.source)(r, cols, s, W)
            has = (cols < own) & (src >= 0)
            cand = np.where(has, bufs[p, np.maximum(src, 0), off] + v, 0.0)
            better = has & (cand > reg[r])
            reg[r] = np.where(better, cand, reg[r])
            bits[r * W:(r + 1) * W] = better
        bufs[1 - p] = reg
        p = 1 - p
        keep[i] = np.packbits(bits)[:keep.shape[1]]
    return keep


@pytest.mark.parametrize("kind,n,qcap,seed,ranks", [
    ("planner", 80, 1638, 40, 16), ("planner", 80, 1638, 41, 3),
    ("ties", 200, 150, 42, 5), ("edges", 60, 1000, 43, 16),
    ("edges", 40, 0, 44, 16), ("edges", 60, 1000, 45, 1)])
def test_route_1_emulated_on_the_host_is_the_reference_dps_bytes(
        kind, n, qcap, seed, ranks):
    values, qsizes = _inputs(kind, n, qcap, seed)
    if kind == "planner":                     # sizes across the ranks
        qsizes = np.random.default_rng(seed).integers(0, qcap + 1, n)
    np.testing.assert_array_equal(
        _emulate_cluster(values, qsizes, qcap, ranks),
        ref_knapsack._numpy_dp(values, qsizes, qcap))
