"""The port's attribution source (``core.OperandAttributionSource``)
against the reference's ``XlaCostAnalysisSource``, on the CPU.

* A run whose ops read three registered leaves whole 3, 1 and 2 times
  gives the same ``PhaseSample``, bit for bit, as the reference bound to a
  hand-written HLO ENTRY whose parameters have those uses, with equal-width
  bins and with one bin per leaf.
* Each kernel wrapper charges its operands once a call, not once per op of
  its plain version.
* An operand charges only the bytes it covers: decode at ``pos = S/2``
  leaves the cache rows past ``pos`` empty.
* A reduced gemma-2b decode step reads the same leaves (one bin per leaf)
  as the reference's attribution of its lowered decode step; the counts
  differ by design (ROADMAP P13: per-op uses of a run against XLA's
  textual uses after fusion).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve.engine import build_decode_step  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from _torch_models import reduced_case  # noqa: E402

HLO = """HloModule step
ENTRY %main {
  p0 = f32[64,16]{1,0} parameter(0)
  p1 = f32[32]{0} parameter(1)
  p2 = bf16[8,8]{1,0} parameter(2)
  p3 = f32[4]{0} parameter(3)
  t0 = f32[64,16]{1,0} add(p0, p0)
  t1 = f32[64,16]{1,0} multiply(t0, p0)
  t2 = f32[32]{0} negate(p1)
  t3 = bf16[8,8]{1,0} add(p2, p2)
  ROOT out = f32[4]{0} add(p3, p3)
}
"""
#: leaf -> (shape, dtype); HLO parameters 0..2 in the flatten order
TABLE = {"a": ((64, 16), "float32"), "b": ((32,), "float32"),
         "c": ((8, 8), "bfloat16")}


def _sample_pair(edges, n_bins):
    rs = ref_core.Session(ref_core.PAPER_DRAM_NVM)
    rs.register("table", {k: jax.ShapeDtypeStruct(s, getattr(jnp, d))
                          for k, (s, d) in TABLE.items()}, chunkable=True)
    ref = ref_core.XlaCostAnalysisSource(rs, n_bins=n_bins, edges=edges)
    want = ref.bind("step", HLO, ["table", 1])
    ps = port_core.Session(port_core.PAPER_DRAM_NVM)
    t = {k: torch.ones(s, dtype=getattr(torch, d))
         for k, (s, d) in TABLE.items()}
    ps.register("table", t, chunkable=True)
    src = port_core.OperandAttributionSource(ps, n_bins=n_bins, edges=edges)
    with src.record("step"):
        t0 = t["a"] + t["a"]
        t0 * t["a"]
        -t["b"]
        t["c"] + t["c"]
        x = torch.ones(4)
        x + x                               # unregistered
    return want, src.collect("step")


@pytest.mark.parametrize("edges,n_bins", [("uniform", 64), ("uniform", 7),
                                          ("leaf", 64)])
def test_sample_is_bit_equal_to_the_reference_on_whole_leaf_reads(edges,
                                                                  n_bins):
    want, got = _sample_pair(edges, n_bins)
    assert got.accesses == want.accesses
    assert got.accesses["table"] == (3 * 64 * 16 * 4 + 32 * 4 + 2 * 128) / 64
    assert got.elapsed is want.elapsed is None
    (wb,), (gb,) = want.access_bins.values(), got.access_bins.values()
    if edges == "leaf":
        np.testing.assert_array_equal(gb.edges, wb.edges)
        np.testing.assert_array_equal(gb.counts, wb.counts)
    else:
        assert gb == wb                     # lists of floats, bit for bit


def _registered(**tensors):
    sess = port_core.Session(port_core.PAPER_DRAM_NVM)
    for name, t in tensors.items():
        sess.register(name, t)
    return port_core.OperandAttributionSource(sess, n_bins=8)


def _bytes(sample, name):
    return sample.accesses.get(name, 0.0) * port_core.PAPER_DRAM_NVM \
        .cacheline_bytes


def _call(kernel, g):
    """(call, {registered name: bytes it must charge}) of one kernel."""
    r = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))
    if kernel == "tiered_matmul":
        x, w = r(4, 64), r(64, 40)
        return (lambda: ops.tiered_matmul(x, w)), dict(w=w, x=x)
    if kernel == "tiered_matmul_experts":
        x, w = r(6, 32), r(5, 32, 16)
        e = torch.tensor([3, 0, 3, 1, 0, 3], dtype=torch.int32)
        want = dict(w=3 * w[0].numel() * 4, x=x)
        return (lambda: ops.tiered_matmul_experts(x, w, e)), dict(w=w, x=x), \
            want
    if kernel == "decode_attention":
        q, k, v = r(2, 1, 4, 16), r(2, 1, 64, 16), r(2, 1, 64, 16)
        want = dict(k=2 * 20 * 16 * 4, v=2 * 20 * 16 * 4, q=q)
        return (lambda: ops.decode_attention(q, k, v, 20)), dict(
            q=q, k=k, v=v), want
    if kernel == "flash_attention":
        q, k, v = r(1, 1, 2, 24, 16), r(1, 1, 24, 16), r(1, 1, 24, 16)
        return (lambda: ops.flash_attention(q, k, v)), dict(q=q, k=k, v=v)
    a = torch.from_numpy(g.uniform(0.9, 1.0, (1, 2, 40)).astype(np.float32))
    k, v, q = r(1, 2, 40, 8), r(1, 2, 40, 8), r(1, 2, 40, 8)
    return (lambda: ops.ssd_scan(a, k, v, q, chunk=16)), dict(a=a, k=k, v=v,
                                                              q=q)


@pytest.mark.parametrize("kernel", ["tiered_matmul", "tiered_matmul_experts",
                                    "decode_attention", "flash_attention",
                                    "ssd_scan"])
def test_each_kernel_call_charges_its_operands_once(kernel):
    """The plain versions read each input several times (casts, einsums);
    the wrapper charges what it reads once: whole tensors, the picked
    experts' weights, the cache's first ``length`` rows."""
    made = _call(kernel, np.random.default_rng(0))
    call, tensors = made[:2]
    want = made[2] if len(made) > 2 else {}
    src = _registered(**tensors)
    with src.record("step"):
        call()
    got = src.collect("step")
    for name, t in tensors.items():
        w = want.get(name, t)
        w = w.numel() * w.element_size() if isinstance(w, torch.Tensor) else w
        assert _bytes(got, name) == w, name


def test_a_view_charges_only_its_range():
    """Decode at pos = S/2 over a registered cache, one bin a cache row:
    rows 0..pos-1 read once, row pos written and read, the rest empty."""
    cfg = reduced_case("gemma-2b")
    params = port_lm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    B, S = 2, 16
    pos = S // 2
    cache = port_lm.init_cache(cfg, B, S, device="cpu")
    L, K, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    sess = port_core.Session(port_core.PAPER_DRAM_NVM)
    sess.register("kv_cache", cache, chunkable=True)
    rows = 2 * L * B * S                  # k then v, (L, B, S) each
    src = port_core.OperandAttributionSource(sess, n_bins=rows)
    with src.record("step"):
        port_lm.decode_step(params, cfg, cache, torch.zeros(B, dtype=int), pos)
    bins = np.asarray(src.collect("step").access_bins["kv_cache"])
    row = K * D * 2
    want = np.zeros((2 * L * B, S))
    want[:, :pos] = row
    want[:, pos] = 2 * row
    np.testing.assert_array_equal(bins.reshape(2 * L * B, S), want)


def _leaves_read(hist):
    return {i for i, c in enumerate(hist.counts) if c > 0}


def test_decode_step_reads_the_reference_leaves():
    cfg = reduced_case("gemma-2b")
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    B, S, pos = 2, 16, 5
    jc = ref_lm.init_cache(cfg, B, S)
    tc = port_lm.init_cache(cfg, B, S, device="cpu")
    tok = np.arange(B)
    lowered = jax.jit(build_decode_step(cfg)).lower(
        jp, jc, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
    rs = ref_core.Session(ref_core.TPU_V5E)
    ps = port_core.Session(port_core.H100_HBM_HOST)
    for sess, p, c in ((rs, jp, jc), (ps, tp, tc)):
        sess.register("params", p)
        sess.register("kv_cache", c, chunkable=True)
    want = ref_core.XlaCostAnalysisSource(rs, edges="leaf").bind(
        "step", lowered, ["params", "kv_cache", jnp.asarray(tok, jnp.int32),
                          jnp.int32(pos)])
    src = port_core.OperandAttributionSource(ps, edges="leaf")
    with src.record("step"):
        port_lm.decode_step(tp, cfg, tc, torch.from_numpy(tok), pos)
    got = src.collect("step")
    assert set(got.accesses) == set(want.accesses) == {"params", "kv_cache"}
    for name in ("params", "kv_cache"):
        g, w = got.access_bins[name], want.access_bins[name]
        np.testing.assert_array_equal(g.edges, w.edges)
        assert _leaves_read(g) == _leaves_read(w)
    assert _leaves_read(got.access_bins["params"]) == set(
        range(len(ps.registry["params"].leaf_spans)))


def test_no_recorder_outside_a_recording():
    from repro_torch import record
    src = _registered(w=torch.ones(3))
    with src.record("step"):
        assert record.recorder is not None
    assert record.recorder is None
    with pytest.raises(ValueError, match="uniform"):
        port_core.OperandAttributionSource(src, edges="nope")


def test_the_runtime_core_loads_no_kernel_module():
    # the recorder lives in ``repro_torch.record``, which imports nothing of
    # the port, so the core layer does not depend on the kernels layer
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\nimport repro_torch.core\n"
            "assert 'repro_torch.record' in sys.modules\n"
            "bad = [m for m in sys.modules\n"
            "       if m.startswith('repro_torch.kernels')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
