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
CASES += [("planner", 40, 20_000, 20),       # past route 1's 17,408 cells
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
