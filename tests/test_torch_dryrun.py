"""The port's dry run of the decode cells (``launch/dryrun.py``) and its
roofline (``launch/roofline.py``), on the CPU.

* The fit loop at reduced configs, with stated HBM sizes: a bf16 cache
  where it fits, e4m3 where only that fits, and no fit (nothing run).
  At the full configs, with no allocation (the weights' shapes from
  FakeTensorMode, the cache's on the meta device), the cells the H100's
  memory holds.
* The record's keys, as the reference's where they have meaning.
* ``roofline.analyze`` bit-equal to the reference's on the same records,
  given the reference's chip counts and rates.
* ``count_params`` equal to the reference's on reduced configs.
* ``train`` and ``prefill`` cells reported as skipped.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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
    r = dryrun.run_cell("gemma-2b", shape, device="cpu", hbm_bytes=1)
    assert r["status"] == "skipped" and "not ported" in r["reason"]
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
