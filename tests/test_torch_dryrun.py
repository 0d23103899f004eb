"""The port's dry run (``launch/dryrun.py``) and its roofline
(``launch/roofline.py``), on the CPU.

* The fit loop at reduced configs, with stated HBM sizes: a bf16 cache
  where it fits, e4m3 where only that fits, and no fit (nothing run).
  At the full configs, with no allocation (the weights' shapes from
  FakeTensorMode, the cache's on the meta device), the cells the H100's
  memory holds.
* The record's keys, as the reference's where they have meaning.
* ``roofline.analyze`` bit-equal to the reference's on the same records,
  given the reference's chip counts and rates.
* ``count_params`` equal to the reference's on reduced configs.
* The train and prefill cells, at reduced configs with stated HBM sizes:
  each mode's program against the reference's on the same numpy batch and
  on parameters carried across by ``convert.py`` (the offload mode's
  gradients against ``build_grads_step`` at the same microbatches, the
  fused step's parameters against ``build_train_step``, the prefill
  logits against ``lm.forward``, with frontend embeddings); the fit loop's
  branches and its exact state bytes; the offload rule against the
  reference's formula; the cost probes' extrapolation against the
  reference's arithmetic; ``offload_programs``' keys and slices and its
  update against the reference's ``adamw_update``; the attribution of a
  fused step.  At the full configs, with nothing allocated, the table of
  mode, microbatches and fit an H100's memory gives.

Tolerances: fp32 parameters on both sides; logits, losses and fp32
gradients 1e-5 absolute and relative (``test_torch_train.py``'s
``MODEL_TOL``: summation order only); the offload mode's bf16 accumulator
one bf16 rounding apart (rtol 2^-7, as ``test_torch_train.py`` holds bf16
moments: a per-microbatch fp32 gradient a hair from a bf16 rounding
boundary rounds the other way); a fused step's parameters 2 x lr absolute
(Adam's first step is +-lr an element); AdamW's state 1e-5 relative.  At
the reduced size the card's workspace constants are set to 0 where a test
states HBM sizes of a few MB, so that the offload rule (0.35 x HBM) and a
fit can meet.
"""

import dataclasses
import importlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.tiers import (V5E_HBM_BW, V5E_ICI_BW,  # noqa: E402
                              V5E_PEAK_FLOPS_BF16)
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models.common import count_params as ref_count  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402
from repro.train.step import build_grads_step as ref_grads_step  # noqa: E402
from repro.train.step import build_train_step as ref_train_step  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.common import tree_bytes  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402

# the reference's dry run sets XLA_FLAGS (512 host devices) when imported;
# put it back before any test starts a JAX backend
_xla_flags = os.environ.get("XLA_FLAGS")
ref_dryrun = importlib.import_module("repro.launch.dryrun")
if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

#: reduced gemma-2b cut to batch 2 x 64 rows: weights 156,288 bytes, the
#: cache 16,384 (bf16) or 8,192 (e4m3), beside the 2 GiB workspace
SMALL = dict(reduced=True, batch=2, seq_len=64, device="cpu", steps=2)
BF16_PEAK = 156_288 + 16_384 + dryrun.DECODE_WORKSPACE
E4M3_PEAK = 156_288 + 8_192 + dryrun.DECODE_WORKSPACE
#: HBM sizes whose 0.95 holds both predictions, only the e4m3 one, neither
FIT_CASES = [(int(BF16_PEAK / 0.95) + 1, "bfloat16", True),
             (int(E4M3_PEAK / 0.95) + 1, "float8_e4m3fn", True),
             (int(E4M3_PEAK / 0.95) - 1, "float8_e4m3fn", False)]
#: an H100 80GB HBM3's torch total_memory
H100_BYTES = 85_029_158_912
#: a reduced train or prefill cell: batch 4 x 32 tokens, two steps
CUT = dict(reduced=True, batch=4, seq_len=32, device="cpu", steps=2)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hbm,kv,fits", FIT_CASES)
def test_fit_loop_takes_each_branch(hbm, kv, fits):
    r = dryrun.run_cell("gemma-2b", "decode_32k", hbm_bytes=hbm, **SMALL)
    assert (r["kv_dtype"], r["fits_hbm"], r["ran"]) == (kv, fits, fits)
    mem = r["memory"]
    assert mem["peak_bytes"] == (mem["weights_bytes"] + mem["cache_bytes"]
                                 + mem["workspace_bytes"])
    assert [a["kv_dtype"] for a in r["fit_attempts"]] == (
        ["bfloat16"] if kv == "bfloat16" else ["bfloat16", "float8_e4m3fn"])
    assert mem["cache_bytes"] == (16384 if kv == "bfloat16" else 8192)
    if fits:
        assert r["logits_shape"] == [2, 128] and r["logits_finite"]
        assert r["pos"] == 63 and len(r["ms_per_step"]) == 2
        assert "launches" in r and "ms_a_step" in r
    else:
        assert "ms_a_step" not in r and "launches" not in r


def test_xlstm_has_no_cache_to_switch():
    r = dryrun.run_cell("xlstm-350m", "decode_32k", hbm_bytes=10 ** 9,
                        **SMALL)
    assert r["kv_dtype"] == "bfloat16" and not r["fits_hbm"]
    assert len(r["fit_attempts"]) == 1 and not r["ran"]


@pytest.mark.parametrize("arch,shape,kv,fits", [
    ("gemma-2b", "decode_32k", "float8_e4m3fn", True),
    ("chatglm3-6b", "decode_32k", "float8_e4m3fn", True),
    ("zamba2-1.2b", "long_500k", "bfloat16", True),
    ("zamba2-1.2b", "decode_32k", "float8_e4m3fn", False),
    ("xlstm-350m", "decode_32k", "bfloat16", True),
    ("xlstm-350m", "long_500k", "bfloat16", True),
    ("yi-6b", "decode_32k", "float8_e4m3fn", False)])
def test_full_cells_the_card_holds(arch, shape, kv, fits):
    r = dryrun.run_cell(arch, shape, hbm_bytes=H100_BYTES, device="cpu",
                        predict_only=True)
    assert (r["kv_dtype"], r["fits_hbm"], r["ran"]) == (kv, fits, False)
    # the weights' bytes are the reference's parameter shapes' (bf16, and
    # zamba2's fp32 SSM leaves)
    shapes = jax.eval_shape(lambda k: ref_lm.init_params(ref_config(arch), k),
                            jax.random.PRNGKey(0))
    assert r["memory"]["weights_bytes"] == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(shapes))


def test_record_keys_and_json(tmp_path, monkeypatch):
    out = tmp_path / "dryrun"
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "gemma", "--shape", "decode_32k", "--reduced",
        "--batch", "2", "--seq-len", "64", "--hbm", "3000000000",
        "--device", "cpu", "--steps", "1", "--attribution",
        "--out", str(out)])
    dryrun.main()
    r = json.loads((out / "gemma-2b-smoke_decode_32k_1xH100.json").read_text())
    assert r["cell"] == "gemma-2b-smoke|decode_32k|1xH100"
    for key in ("status", "mode", "n_chips", "kv_dtype", "memory",
                "fits_hbm", "unimem_attribution"):
        assert key in r, key
    assert (r["status"], r["mode"], r["n_chips"]) == ("ok", "decode", 1)
    assert {"argument_bytes", "peak_bytes"} <= set(r["memory"])
    att = r["unimem_attribution"]
    assert set(att) == {"params", "kv_cache"}
    for entry in att.values():
        assert entry["n_bins"] == 64 and len(entry["bins"]) == 64
        assert entry["accesses"] > 0 and entry["nonzero_bins"] > 0
    # the whole cache is read at pos = S - 1, and row pos written
    cache = 2 * 2 * 2 * 64 * 16 * 2
    assert att["kv_cache"]["accesses"] * 128 == cache + 2 * 2 * 2 * 16 * 2
    row = roofline.analyze(r)
    assert row["measured_ms_a_step"] == r["ms_a_step"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_train_and_prefill_cells_are_skipped(shape):
    """Train and prefill cells are no longer skipped: a reduced cell runs
    in its mode with the reference's keys.  long_500k stays skipped for a
    pure full-attention config, as in the reference."""
    r = dryrun.run_cell("gemma-2b", shape, hbm_bytes=10 ** 10, **CUT)
    mode = "fused" if shape == "train_4k" else "prefill"
    assert (r["status"], r["mode"], r["n_chips"], r["ran"]) == (
        "ok", mode, 1, True)
    for key in ("microbatches", "memory", "fits_hbm", "roofline_inputs",
                "ms_a_step", "ms_a_step_extrapolated", "launches",
                "launches_per_step", "reduced"):
        assert key in r, key
    assert "peak_bytes" in r["memory"] and r["fits_hbm"]
    r = dryrun.run_cell("gemma-2b", "long_500k", device="cpu", hbm_bytes=1)
    assert r["status"] == "skipped" and "quadratic" in r["reason"]


def _record(cell, kv="bfloat16", mode="decode", mb=None):
    return {"cell": cell, "status": "ok", "mode": mode, "microbatches": mb,
            "kv_dtype": kv, "fits_hbm": True,
            "memory": {"argument_bytes": 7.5e9, "peak_bytes": 1.25e10},
            "collectives_raw": {"all-reduce": {"count": 3, "bytes": 1e6},
                                "all-gather": {"count": 0, "bytes": 0.0}}}


RECORDS = [
    _record("gemma-2b|decode_32k|16x16", kv="float8_e4m3fn"),
    _record("chatglm3-6b|decode_32k|16x16"),
    _record("zamba2-1.2b|long_500k|16x16"),
    _record("xlstm-350m|decode_32k|16x16"),
    _record("yi-6b|train_4k|16x16", mode="fused", mb=4),
    _record("nemotron-4-340b|train_4k|16x16", mode="offload-grads", mb=16),
    _record("dbrx-132b|prefill_32k|16x16", mode="prefill"),
    _record("moonshot-v1-16b-a3b|decode_32k|16x16")]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_roofline_is_the_reference_s_at_its_rates(i):
    r = RECORDS[i]
    want = ref_roofline.analyze(r)
    got = roofline.analyze(r, roofline.Rates(
        chips=ref_roofline.CHIPS, dp=ref_roofline.DP, tp=ref_roofline.TP,
        flops=V5E_PEAK_FLOPS_BF16, hbm_bw=V5E_HBM_BW, link_bw=V5E_ICI_BW))
    assert {k: got[k] for k in want} == want
    assert got["measured_ms_a_step"] is None


def test_h100_roofline_of_gemma_decode_32k():
    """One card: no link term; the e4m3 cache counts 1 byte a value, the
    weights 2 a parameter: 13.0 ms at the data sheet's 3.35 TB/s."""
    row = roofline.analyze(dict(RECORDS[0], cell="gemma-2b|decode_32k|1xH100",
                                ms_a_step=20.0))
    cfg = get_port_config("gemma-2b")
    cache = 2 * 18 * 128 * 32768 * 1 * 256
    assert row["memory_s"] == (2 * cfg.n_params() + cache) / 3.35e12
    assert row["collective_s"] == 0.0 and row["dominant"] == "memory"
    assert abs(row["step_bound_s"] - 0.01303) < 1e-4
    assert row["measured_ms_a_step"] == 20.0


def get_port_config(name):
    from repro_torch.configs import get_config
    return get_config(name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_params_matches_reference(arch):
    cfg = ref_config(arch).reduced()
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    tp = port_lm.init_params(get_port_config(arch).reduced(),
                             torch.Generator().manual_seed(0), device="cpu")
    assert count_params(tp) == ref_count(jp) > 0
    assert count_params(tp) == sum(int(np.prod(x.shape))
                                   for x in jax.tree_util.tree_leaves(jp))


# ----------------------------------------------------- train and prefill
def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaf_paths(tree):
    return dict(_tree.flatten_with_path(tree)[0])


def _jax_leaf_paths(tree):
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_case(arch, n_layers=None):
    """The reference's reduced config (``n_layers`` if given), its fp32
    parameters and the same carried across."""
    cfg = ref_config(arch).reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _cell_shape(shape_name, batch=4, seq_len=32):
    return dataclasses.replace(SHAPES[shape_name], global_batch=batch,
                               seq_len=seq_len)


def _cell_batch(cfg, shape_name, seed=3):
    """A reduced cell's inputs as the dry run draws them
    (``input_batch``), and the same as JAX arrays."""
    tb = dryrun.input_batch(cfg, _cell_shape(shape_name),
                            torch.Generator().manual_seed(seed), "cpu")
    jb = {k: jnp.asarray(tb[k].numpy(), jnp.int32)
          for k in ("tokens", "labels")}
    if "frontend" in tb:
        jb["frontend"] = jnp.asarray(tb["frontend"].float().numpy(),
                                     jnp.bfloat16)
    return tb, jb


@pytest.mark.parametrize("arch", ["gemma-2b", "phi-3-vision-4.2b"])
def test_offload_grads_match_reference(arch):
    """The offload mode's program (``build_grads_step``, a bf16
    accumulator) at 2 microbatches against the reference's, phi-3-vision
    with its patch embeddings before the tokens."""
    cfg, jp, tp = _ref_case(arch)
    tb, jb = _cell_batch(cfg, "train_4k")
    got = dryrun.build_cell(cfg, "offload-grads", microbatches=2)(
        tp, None, tb)
    jg, jm = jax.jit(ref_grads_step(cfg, microbatches=2))(jp, jb)
    assert float(got["metrics"]["nll"]) == pytest.approx(float(jm["nll"]),
                                                         rel=1e-5)
    want = _jax_leaf_paths(jg)
    got_leaves = _leaf_paths(got["grads"])
    assert sorted(got_leaves) == sorted(want)
    for path, g in got_leaves.items():
        w = _as_np(want[path])
        assert g.dtype == torch.bfloat16 and want[path].dtype == jnp.bfloat16
        np.testing.assert_allclose(_as_np(g), w, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b"])
def test_fused_step_matches_reference(arch):
    """The fused program (``build_train_step``, fp32 accumulator, AdamW at
    the default lr) at 2 microbatches: its loss, gradient norm and the
    parameters after one step against the reference's."""
    cfg, jp, tp = _ref_case(arch)
    tb, jb = _cell_batch(cfg, "train_4k")
    opt = AdamWConfig()
    js = ref_init_opt_state(jp, RefAdamWConfig())
    ts = params_from_numpy(jax.device_get(js), device="cpu")
    got = dryrun.build_cell(cfg, "fused", microbatches=2, opt_cfg=opt)(
        tp, ts, tb)
    jp2, _, jm = jax.jit(ref_train_step(cfg, RefAdamWConfig(),
                                        microbatches=2))(jp, js, jb)
    for k in ("loss", "grad_norm", "step"):
        assert float(got["metrics"][k]) == pytest.approx(float(jm[k]),
                                                         rel=1e-5)
    want = _jax_leaf_paths(jp2)
    for path, t in _leaf_paths(tp).items():
        np.testing.assert_allclose(_as_np(t), _as_np(want[path]), rtol=0,
                                   atol=2 * opt.lr, err_msg=path)


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b",
                                  "musicgen-large", "phi-3-vision-4.2b"])
def test_prefill_logits_match_reference(arch):
    """The prefill program's logits against the reference's
    ``lm.forward(..., remat=False)``, musicgen-large's audio frames and
    phi-3-vision's patch embeddings before the tokens."""
    cfg, jp, tp = _ref_case(arch)
    tb, jb = _cell_batch(cfg, "prefill_32k")
    got = dryrun.build_cell(cfg, "prefill")(tp, None, tb)["logits"]
    want, _ = jax.jit(lambda p, t, f: ref_lm.forward(
        p, cfg, t, f, remat=False))(jp, jb["tokens"], jb.get("frontend"))
    assert list(got.shape) == [4, 32 + cfg.frontend_tokens, cfg.vocab_size]
    assert not got.requires_grad
    np.testing.assert_allclose(_as_np(got), _as_np(want), **MODEL_TOL)


@pytest.mark.parametrize("arch,shape,hbm,mode", [
    ("gemma-2b", "train_4k", 3_000_000, "offload-grads"),
    ("zamba2-1.2b", "train_4k", 10 ** 10, "fused"),
    ("musicgen-large", "prefill_32k", 10 ** 10, "prefill")])
def test_run_cell_runs_the_program_on_its_seeded_inputs(arch, shape, hbm,
                                                        mode, monkeypatch):
    """A run cell's loss is its program's on the seeded bf16 weights and
    inputs (the same draws, in the same order), after the warm-up and the
    timed steps (a fused step updates the weights); the programs are held
    to the reference above."""
    monkeypatch.setattr(dryrun, "TRAIN_WORKSPACE", 0)
    r = dryrun.run_cell(arch, shape, hbm_bytes=hbm, probes=False,
                        microbatches_run=None, **CUT)
    assert (r["mode"], r["ran"], r["fits_hbm"]) == (mode, True, True)
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    params = port_lm.init_params(cfg, gen, device="cpu",
                                 dtype=torch.bfloat16)
    state = init_opt_state(params, AdamWConfig()) if mode == "fused" \
        else None
    batch = dryrun.input_batch(cfg, _cell_shape(shape), gen, "cpu")
    step = dryrun.build_cell(cfg, mode, microbatches=r["microbatches"] or 1)
    for _ in range(1 + CUT["steps"]):
        out = step(params, state, batch)
    if mode == "prefill":
        assert r["logits_shape"] == list(out["logits"].shape)
        assert r["logits_finite"]
    else:
        m = out["metrics"]
        assert r["loss"] == float(m["loss"] if "loss" in m else m["nll"])
        assert r["loss_finite"] and np.isfinite(r["grad_norm"])
    if mode == "offload-grads":
        off = r["offload"]
        assert off["slice_peak_bytes"] == off["slice_peak_bytes_predicted"]
        # the slice ran; the CPU measures no peak
        assert off["slice_finite"] and not off["slice_peak_measured"]


#: reduced gemma-2b train_4k at batch 16 x 32: the fit loop's attempts
FIT_BATCH = 16


def _fit_peaks():
    cfg = get_config("gemma-2b").reduced()
    shape = _cell_shape("train_4k", FIT_BATCH)
    return {mb: dryrun.predict_train(cfg, shape, "fused", mb)["peak_bytes"]
            for mb in (1, 2, 4, 8)}


@pytest.mark.parametrize("branch", ["first", "doubling", "none"])
def test_train_fit_loop_takes_each_branch(branch):
    """Stated HBM sizes: the first attempt fits; one doubling fits; after
    4 attempts nothing fits (and nothing runs)."""
    peaks = _fit_peaks()
    assert peaks[1] > peaks[2] > peaks[4] > peaks[8]
    hbm = {"first": int(peaks[1] / 0.95) + 1,
           "doubling": int(peaks[2] / 0.95) + 1,
           "none": int(peaks[8] / 0.95) - 1}[branch]
    r = dryrun.run_cell("gemma-2b", "train_4k", hbm_bytes=hbm,
                        **dict(CUT, batch=FIT_BATCH, steps=1))
    want = {"first": [1], "doubling": [1, 2], "none": [1, 2, 4, 8]}[branch]
    assert [a["microbatches"] for a in r["fit_attempts"]] == want
    assert [a["peak_bytes"] for a in r["fit_attempts"]] == [
        peaks[mb] for mb in want]
    fits = branch != "none"
    assert (r["mode"], r["microbatches"], r["fits_hbm"], r["ran"]) == (
        "fused", want[-1], fits, fits)
    if fits:
        assert r["microbatches_run"] == want[-1]
        assert r["launches_per_microbatch"] == {}      # no kernel on the CPU


def test_prefill_that_does_not_fit_is_not_run():
    r = dryrun.run_cell("gemma-2b", "prefill_32k", hbm_bytes=10 ** 9,
                        **CUT)
    assert (r["mode"], r["fits_hbm"], r["ran"]) == ("prefill", False, False)
    assert len(r["fit_attempts"]) == 1 and r["microbatches"] is None


@pytest.mark.parametrize("arch,mode", [("gemma-2b", "fused"),
                                       ("gemma-2b", "offload-grads"),
                                       ("zamba2-1.2b", "fused"),
                                       ("phi-3-vision-4.2b", "offload-grads")])
def test_predicted_state_bytes_are_the_trees(arch, mode):
    """The prediction's exact parts equal the bytes of the trees the cell
    allocates: the bf16 weights, the optimizer state, the accumulator and
    one microbatch's gradients, the inputs."""
    cfg = get_config(arch).reduced()
    shape = _cell_shape("train_4k")
    p = dryrun.predict_train(cfg, shape, mode, 2)
    gen = torch.Generator().manual_seed(0)
    params = port_lm.init_params(cfg, gen, device="cpu",
                                 dtype=torch.bfloat16)
    n = sum(t.numel() for t in _tree.leaves(params))
    assert p["weights_bytes"] == p["grads_bytes"] == tree_bytes(params)
    assert p["opt_state_bytes"] == (
        tree_bytes(init_opt_state(params, AdamWConfig()))
        if mode == "fused" else 0)
    assert p["accumulator_bytes"] == (4 if mode == "fused" else 2) * n
    assert p["input_bytes"] == tree_bytes(
        dryrun.input_batch(cfg, shape, gen, "cpu"))
    assert dryrun.predict_train(cfg, shape, mode, 1)["accumulator_bytes"] == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_offload_decision_is_the_reference_s(arch):
    """``offload_mode`` against the reference's inline rule
    (``n_params x 14 / n_chips > 0.35 x HBM``) at one H100 and at the
    reference's mesh of 256 chips of 16 GiB."""
    n = ref_config(arch).n_params()
    for hbm, chips in ((H100_BYTES, 1), (ref_dryrun.HBM_PER_CHIP, 256)):
        assert dryrun.offload_mode(get_config(arch), hbm, chips) == (
            n * (2 + 12) / chips > 0.35 * hbm)


#: the full configs at an H100's memory, nothing allocated: train_4k's
#: (mode, microbatches, fits) and whether prefill_32k fits whole
H100_TABLE = {
    "chatglm3-6b": ("offload-grads", 128, True, False),
    "dbrx-132b": ("offload-grads", 256, False, False),
    "gemma-2b": ("offload-grads", 128, True, False),
    "moonshot-v1-16b-a3b": ("offload-grads", 256, False, False),
    "musicgen-large": ("offload-grads", 128, True, True),
    "nemotron-4-340b": ("offload-grads", 256, False, False),
    "phi-3-vision-4.2b": ("offload-grads", 128, True, False),
    "xlstm-350m": ("fused", 32, True, False),
    "yi-6b": ("offload-grads", 256, True, False),
    "zamba2-1.2b": ("fused", 128, True, False)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_train_and_prefill_cells_the_card_holds(arch):
    r = dryrun.run_cell(arch, "train_4k", hbm_bytes=H100_BYTES,
                        device="cpu", predict_only=True)
    p = dryrun.run_cell(arch, "prefill_32k", hbm_bytes=H100_BYTES,
                        device="cpu", predict_only=True)
    assert (r["mode"], r["microbatches"], r["fits_hbm"],
            p["fits_hbm"]) == H100_TABLE[arch]
    assert not r["ran"] and not p["ran"]
    assert ("offload" in r) == (r["mode"] == "offload-grads")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_layer_counts_are_the_reference_s(arch):
    assert dryrun._reduced_layer_counts(get_config(arch)) == \
        ref_dryrun._reduced_layer_counts(ref_config(arch))


class _Compiled:
    """A stand-in for a compiled probe of the reference: its layer count."""

    def __init__(self, n_layers):
        self.n_layers = n_layers

    def lower(self, *args):
        return self

    def compile(self):
        return self

    def as_text(self):
        return ""


@pytest.mark.parametrize("arch,shape,mode", [
    ("gemma-2b", "train_4k", "offload-grads"),
    ("zamba2-1.2b", "train_4k", "fused"),
    ("musicgen-large", "prefill_32k", "prefill")])
def test_cost_probes_extrapolate_as_the_reference(arch, shape, mode,
                                                  monkeypatch):
    """The reference's ``cost_probes``, its compiles replaced by stand-ins
    whose costs are the port's probes' numbers, gives the port's
    extrapolated flops, bytes, collective bytes and (fed the probes' ms)
    ms a step."""
    cfg = get_config(arch).reduced()
    mb = 2 if mode != "prefill" else 1
    got = dryrun.cost_probes(cfg, _cell_shape(shape), mode, mb,
                             device="cpu")
    probes = got["probes"]
    monkeypatch.setattr(ref_dryrun, "build_cell",
                        lambda c, *a, **kw: (_Compiled(c.n_layers), (), {}))

    def ref(key):
        monkeypatch.setattr(ref_dryrun, "_cost", lambda c: {
            "flops": key(probes[f"L{c.n_layers}"]), "bytes": 0.0})
        return ref_dryrun.cost_probes(ref_config(arch).reduced(),
                                      REF_SHAPES[shape], None,
                                      offload=mode == "offload-grads")
    want = ref(lambda p: p["cost"]["flops"])
    assert got["probe_layers"] == want["probe_layers"]
    assert got["flops_per_device"] == want["flops_per_device"]
    assert got["bytes_per_device"] == ref(
        lambda p: p["cost"]["bytes"])["flops_per_device"]
    assert got["collective_bytes"] == want["collective_bytes"] == {
        k: 0.0 for k in ref_dryrun.COLLECTIVES}
    if mode == "fused":
        upd = ref(lambda p: p["update_ms"])["flops_per_device"]
        fb = ref(lambda p: p["ms"] - p["update_ms"])["flops_per_device"]
        assert got["ms_a_step_extrapolated"] == pytest.approx(
            fb * mb + upd, rel=1e-12)
    else:
        assert got["ms_a_step_extrapolated"] == ref(
            lambda p: p["ms"])["flops_per_device"] * mb
    for p in probes.values():
        assert p["ms"] == min(p["ms_per_run"]) and len(
            p["ms_per_run"]) == 3
        assert p["measured_peak_bytes"] is None


@pytest.mark.parametrize("arch,shape,mode", [
    ("gemma-2b", "train_4k", "offload-grads"),
    ("zamba2-1.2b", "train_4k", "fused")])
def test_cost_probes_extrapolate_their_profiled_device_time(arch, shape,
                                                            mode,
                                                            monkeypatch):
    """Given ``profile``, each probe is profiled over ``PROBE_BATCH`` more
    runs of its program, its ``device_ms`` is the profile's busy time a
    run (plus ``update_ms``, fused), and the reference's ``cost_probes``
    fed ``device_ms`` gives the port's ms a step, whatever the wall
    times."""
    cfg = get_config(arch).reduced()
    mb = 2
    busy = iter([5.0, 8.0])
    calls = []

    def profile(run, runs, wall_ms):
        run()
        calls.append((runs, wall_ms))
        return {"device_busy_ms_per_step": next(busy)}

    got = dryrun.cost_probes(cfg, _cell_shape(shape), mode, mb,
                             device="cpu", profile=profile)
    probes = got["probes"]
    assert got["extrapolated_from"] == "device_ms"
    assert [c[0] for c in calls] == [dryrun.PROBE_BATCH] * 2
    for (runs, wall_ms), p, b in zip(
            calls, probes.values(), (5.0, 8.0)):
        upd = p.get("update_ms", 0.0)
        assert (mode == "fused") == ("update_ms" in p)
        assert wall_ms == pytest.approx(p["ms"] - upd, rel=1e-12)
        assert p["device_ms"] == b + upd
    monkeypatch.setattr(ref_dryrun, "build_cell",
                        lambda c, *a, **kw: (_Compiled(c.n_layers), (), {}))

    def ref(key):
        monkeypatch.setattr(ref_dryrun, "_cost", lambda c: {
            "flops": key(probes[f"L{c.n_layers}"]), "bytes": 0.0})
        return ref_dryrun.cost_probes(ref_config(arch).reduced(),
                                      REF_SHAPES[shape], None,
                                      offload=mode == "offload-grads")[
            "flops_per_device"]
    if mode == "fused":
        upd = ref(lambda p: p["update_ms"])
        fb = ref(lambda p: p["device_ms"] - p["update_ms"])
        assert got["ms_a_step_extrapolated"] == pytest.approx(
            fb * mb + upd, rel=1e-12)
    else:
        assert got["ms_a_step_extrapolated"] == ref(
            lambda p: p["device_ms"]) * mb


def test_run_cell_profiles_its_probes_with_probe_profile():
    """``probe_profile`` reaches the cost probes (each profiled once, the
    extrapolation from their device time) and not the cell's steps."""
    calls = []

    def probe_profile(run, runs, wall_ms):
        run()
        calls.append(runs)
        return {"device_busy_ms_per_step": 1.0 + len(calls)}

    r = dryrun.run_cell("gemma-2b", "prefill_32k", hbm_bytes=H100_BYTES,
                        probe_profile=probe_profile, **CUT)
    ri = r["roofline_inputs"]
    assert calls == [dryrun.PROBE_BATCH] * 2 and "profile" not in r
    assert ri["extrapolated_from"] == "device_ms"
    assert [p["device_ms"] for p in ri["probes"].values()] == [2.0, 3.0]
    assert r["ms_a_step_extrapolated"] == dryrun._extrap(2.0, 3.0, *ri[
        "probe_layers"], r["n_layers"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_offload_programs_keys_and_slices(arch):
    """At the full configs, nothing allocated: the reference's keys, its
    slice of ``max(1, L // 12)`` layers' ``blocks`` leaves and that
    slice's state bytes (the reference's shapes), and n_params x 12 bytes
    on the host tier."""
    rcfg = ref_config(arch)
    off = dryrun.offload_programs(get_config(arch), SHAPES["train_4k"])
    assert {"n_slices", "layers_per_slice", "slice_peak_bytes",
            "slice_state_bytes_per_chip", "host_resident_bytes_per_chip",
            "note"} <= set(off)
    L_slice = max(1, rcfg.n_layers // 12)
    assert (off["n_slices"], off["layers_per_slice"]) == (12, L_slice)
    shapes = jax.eval_shape(lambda k: ref_lm.init_params(
        dataclasses.replace(rcfg, n_layers=L_slice), k),
        jax.random.PRNGKey(0))
    blocks = {k: v for k, v in shapes.items() if "blocks" in k}
    ostate = jax.eval_shape(lambda b: ref_init_opt_state(
        b, RefAdamWConfig()), blocks)
    assert off["slice_state_bytes_per_chip"] == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(ostate))
    assert off["host_resident_bytes_per_chip"] == rcfg.n_params() * 12
    assert off["slice_peak_bytes"] == off["slice_peak_bytes_predicted"] > (
        off["slice_state_bytes_per_chip"])


def test_offload_slice_update_matches_reference():
    """A reduced slice's program (one layer's ``blocks`` leaves, fresh
    fp32 state, one AdamW update at the slice's lr) against the
    reference's ``adamw_update``."""
    cfg, jp, tp = _ref_case("gemma-2b", n_layers=1)
    jb = {k: v for k, v in jp.items() if "blocks" in k}
    tb = {k: v for k, v in tp.items() if "blocks" in k}
    rng = np.random.default_rng(11)
    ng = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
        jax.device_get(jb))
    state = dryrun.offload_slice_step(
        tb, params_from_numpy(ng, device="cpu"), AdamWConfig())
    jp2, js2, _ = ref_adamw_update(
        jax.tree_util.tree_map(jnp.asarray, ng), jb,
        ref_init_opt_state(jb, RefAdamWConfig()), RefAdamWConfig(),
        jnp.float32(dryrun.OFFLOAD_LR))
    for got, want in ((tb, jp2), (state["master"], js2["master"]),
                      (state["mu"], js2["mu"]), (state["nu"], js2["nu"])):
        want = _jax_leaf_paths(want)
        for path, t in _leaf_paths(got).items():
            np.testing.assert_allclose(_as_np(t), _as_np(want[path]),
                                       rtol=1e-5, atol=1e-9, err_msg=path)
    assert int(state["step"]) == int(js2["step"]) == 1


@pytest.mark.parametrize("arch,shape,mode,objects", [
    ("gemma-2b", "train_4k", "fused", {"params", "opt_state"}),
    ("zamba2-1.2b", "prefill_32k", "prefill", {"params"})])
def test_attribution_of_a_step(arch, shape, mode, objects):
    """A fused step's attribution shows ``params`` and ``opt_state``, and
    the backward's ops reach the source: the step reads the parameters
    more than twice as often as the loss's forward alone (the forward,
    the remat's recompute and the backward's products)."""
    r = dryrun.run_cell(arch, shape, hbm_bytes=10 ** 10, attribution=True,
                        probes=False, **CUT)
    assert r["mode"] == mode
    att = r["unimem_attribution"]
    assert set(att) == objects == set(dryrun.ATTRIBUTION_OBJECTS[mode])
    for entry in att.values():
        assert entry["accesses"] > 0 and entry["nonzero_bins"] > 0
    if mode != "prefill":
        assert r["params_step_over_forward"] > 2.0
        assert set(r["unimem_attribution_forward"]) == {"params"}


def test_roofline_row_of_a_train_cell():
    """A train record's row: the analytic terms of its whole step beside
    the measured ms and the probes' extrapolation."""
    rec = dict(_record("zamba2-1.2b|train_4k|1xH100", mode="fused", mb=128),
               ms_a_step=1700.0, ms_a_step_extrapolated=108000.0)
    row = roofline.analyze(rec)
    cfg = get_port_config("zamba2-1.2b")
    t = roofline.analytic_terms(cfg, SHAPES["train_4k"], rec)
    assert (row["compute_s"], row["memory_s"]) == (t["compute_s"],
                                                   t["memory_s"])
    assert row["measured_ms_a_step"] == 1700.0
    assert row["ms_a_step_extrapolated"] == 108000.0
    assert row["collective_s"] == 0.0


@pytest.mark.parametrize("r0,r1", [(0, 16), (40, 72), (100, 128)])
def test_flash_plain_rows_are_the_plain_versions_rows(r0, r1):
    """The plain version on a tile of causal query rows (what the card's
    checks hold the prefill's 32,768-position forward to) gives the plain
    version's rows over the whole sequence, to fp32 rounding."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = torch.Generator().manual_seed(9)
    q = torch.randn((1, 2, 3, 128, 16), generator=g)
    k, v = (torch.randn((1, 2, 128, 16), generator=g) for _ in range(2))
    out, lse = fa.flash_attention_plain(q, k, v, True)
    rows, rows_lse = fa.flash_attention_plain_rows(q, k, v, r0, r1)
    torch.testing.assert_close(rows, out[..., r0:r1, :], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(rows_lse, lse[..., r0:r1], rtol=1e-6,
                               atol=1e-6)
