"""The port's distributed layer against the reference, on the CPU.

* (a) every case of ``tests/test_sharding.py`` through the port's rules;
* (b) ``param_specs``, ``opt_specs`` (fp32, bf16 and int8 moments),
  ``batch_specs`` and ``cache_specs`` for all ten configs at full size on
  the (16, 16) and (2, 16, 16) production meshes, flat DP off and on:
  equal specs leaf by leaf (after the 1-tuple canonicalisation of
  ``test_sharding.spec_eq``), and ``shard_bytes`` equal to the sum of the
  reference's ``NamedSharding(AbstractMesh, spec).shard_shape`` bytes.
  Shapes from ``jax.eval_shape`` and the port's fake and meta tensors;
* (c) the int8 quantizer's bits against the reference's;
* (d) one run of 4 gloo ranks (``_torch_dist_helper.py port``) against the
  reference on 4 host devices (``_torch_dist_helper.py ref``), each in its
  own processes, on a (2, 2) mesh: the sharded embedding (forward bits;
  the table's gradient within 1e-6 relative in fp32, 2e-2 in bf16),
  ``compressed_psum`` (each rank's sent value and error bits, the reduced
  value within 1e-6 relative), ``pipeline_forward`` at S 4, M 6 (the
  reference's last stage within 2e-5; the port's sequential application
  bit for bit) and elastic restore of a checkpoint the reference saved,
  onto ``param_specs`` under flat DP (each rank's shard the bytes of the
  reference's shard at the same mesh position);
* (e) R8: the reference's ``pipeline_forward`` returns zeros at S 2 and 4;
* (f) ``shard_hint`` refuses a plain tensor over an axis of size 2 and
  returns its input with no hint;
* (g) the dry run's ``--mesh 16x16 --predict-only`` cells of gemma-2b and
  yi-6b against (b)'s reference bytes.
"""

import functools
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.checkpoint import CheckpointManager as RefCkpt  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import grad_compression as ref_gc  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.distributed import grad_compression as gc  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh as PortAbstractMesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import common, lm  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402

HELPER = os.path.join(os.path.dirname(__file__), "_torch_dist_helper.py")
MESH = make_production_mesh()
MESH3 = make_production_mesh(multi_pod=True)
REF_MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
              "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
PORT_MESHES = {"16x16": MESH, "2x16x16": MESH3}
MOMENTS = ("float32", "bfloat16", "int8")
#: an H100 80GB HBM3's torch total_memory
H100_BYTES = 85_029_158_912
#: the multi-rank run's time limit (it takes ~10 s)
RUN_TIMEOUT_S = 240


def canon(spec):
    """``test_sharding.spec_eq``'s form: 1-tuples as bare names."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def spec_eq(a, b):
    return canon(a) == canon(b)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def flat_dp_off():
    yield
    shd.set_flat_dp(False)
    ref_shd.set_flat_dp(False)


# ----------------------------------------------- (a) test_sharding's cases
def test_fit_drops_nondivisible_axes():
    assert spec_eq(shd.fit(MESH, (8, 128), "model", None), (None, None))
    assert spec_eq(shd.fit(MESH, (32, 128), "model", None), ("model", None))


def test_fit_keeps_divisible_prefix():
    spec = shd.fit(MESH3, (4, 64), ("pod", "data"), None)
    assert spec_eq(spec, ("pod", None))


def test_param_specs_rules():
    pshapes = {"embed": meta(64000, 4096), "head": meta(4096, 64000),
               "blocks": {"attn": {"wq": meta(32, 4096, 4096)},
                          "mlp": {"w_down": meta(32, 11008, 4096)}}}
    specs = shd.param_specs(MESH, pshapes)
    assert spec_eq(specs["embed"], (None, "model"))
    assert spec_eq(specs["head"], (None, "model"))
    assert spec_eq(specs["blocks"]["attn"]["wq"], (None, ("data",), "model"))
    assert spec_eq(specs["blocks"]["mlp"]["w_down"],
                   (None, "model", ("data",)))


def test_tied_embed_vocab_sharded():
    specs = shd.param_specs(MESH, {"embed": meta(256000, 2048)}, tied=True)
    assert spec_eq(specs["embed"], ("model", None))


def test_cache_specs_kv_head_fallback_to_sequence():
    cache = {"k": meta(28, 128, 32768, 2, 128),
             "v": meta(28, 128, 32768, 2, 128)}
    specs = shd.cache_specs(MESH, None, cache, batch=128)
    assert spec_eq(specs["k"], (None, ("data",), "model", None, None))


def test_cache_specs_kv_heads_when_divisible():
    specs = shd.cache_specs(MESH, None, {"k": meta(32, 128, 32768, 32, 128)},
                            batch=128)
    assert spec_eq(specs["k"], (None, ("data",), None, "model", None))


def test_cache_specs_sp_when_batch_too_small():
    specs = shd.cache_specs(MESH, None, {"k": meta(7, 1, 524288, 32, 64)},
                            batch=1)
    assert spec_eq(specs["k"], (None, None, "data", "model", None))


def test_opt_specs_mirror_params():
    pshapes = {"w": meta(4096, 4096)}
    pspecs = shd.param_specs(MESH, pshapes)
    oshapes = {"mu": {"w": meta(4096, 4096, dtype=torch.float32)},
               "step": meta(dtype=torch.int32)}
    ospecs = shd.opt_specs(MESH, oshapes, pshapes, pspecs)
    assert ospecs["mu"]["w"] == pspecs["w"]
    assert spec_eq(ospecs["step"], ())


# ----------------------------------------- (b) all configs at full size
def _ref_specs(tree):
    """{path: canonical spec} of a reference spec tree."""
    pairs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {ref_shd._path_str(p): canon(s) for p, s in pairs}


def _port_specs(tree):
    pairs = _tree.flatten_with_keys(tree, shd.is_spec)[0]
    return {"/".join(map(str, k)): canon(s) for k, s in pairs}


def _ref_bytes(shapes, specs, mesh) -> int:
    """One device's bytes, from the reference's ``shard_shape``."""
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(l.shape)))
               * l.dtype.itemsize for l, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    """The reference's parameter, optimizer (each moment dtype) and cache
    (each decode shape) shapes of ``arch`` at full size."""
    cfg = ref_config(arch)
    params = jax.eval_shape(functools.partial(ref_lm.init_params, cfg),
                            jax.random.PRNGKey(0))
    opts = {m: jax.eval_shape(functools.partial(
        ref_init_opt_state, cfg=RefAdamWConfig(moments_dtype=m)), params)
        for m in MOMENTS}
    caches = {}
    for name, shape in SHAPES.items():
        if shape.kind == "decode" and cfg.shape_applicable(shape)[0]:
            caches[name] = jax.eval_shape(lambda s=shape: ref_lm.init_cache(
                cfg, s.global_batch, s.seq_len))
    return params, opts, caches


def _port_shapes(arch: str):
    cfg = get_config(arch)
    params = dryrun._param_shapes(cfg)
    opts = {}
    for m in MOMENTS:
        with FakeTensorMode():
            leaves, treedef = _tree.flatten(params)
            fake = _tree.unflatten(treedef, [
                torch.empty(t.shape, dtype=t.dtype) for t in leaves])
            opts[m] = init_opt_state(fake, AdamWConfig(moments_dtype=m))
    caches = {name: lm.init_cache(cfg, s.global_batch, s.seq_len,
                                  device="meta")
              for name, s in SHAPES.items()
              if s.kind == "decode" and cfg.shape_applicable(s)[0]}
    return params, opts, caches


def _ref_cell_bytes(arch: str, mesh_name: str, flat: bool) -> dict:
    """The reference's per-device bytes of (g)'s cells: params, fp32
    optimizer state, each decode shape's cache."""
    ref_shd.set_flat_dp(flat)
    try:
        mesh, cfg = REF_MESHES[mesh_name], ref_config(arch)
        params, opts, caches = _ref_shapes(arch)
        pspecs = ref_shd.param_specs(mesh, params)
        out = {"params": _ref_bytes(params, pspecs, mesh),
               "opt_state": _ref_bytes(opts["float32"], ref_shd.opt_specs(
                   mesh, opts["float32"], params, pspecs), mesh)}
        for name, cache in caches.items():
            out[name] = _ref_bytes(cache, ref_shd.cache_specs(
                mesh, cfg, cache, SHAPES[name].global_batch), mesh)
        return out
    finally:
        ref_shd.set_flat_dp(False)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_shard_bytes_match_reference_at_full_size(arch,
                                                            flat_dp_off):
    rcfg, cfg = ref_config(arch), get_config(arch)
    rparams, ropts, rcaches = _ref_shapes(arch)
    pparams, popts, pcaches = _port_shapes(arch)
    for mesh_name in REF_MESHES:
        rmesh, pmesh = REF_MESHES[mesh_name], PORT_MESHES[mesh_name]
        for flat in (False, True):
            ref_shd.set_flat_dp(flat)
            shd.set_flat_dp(flat)
            where = f"{arch} {mesh_name} flat_dp={flat}"
            rps = ref_shd.param_specs(rmesh, rparams)
            pps = shd.param_specs(pmesh, pparams)
            assert _port_specs(pps) == _ref_specs(rps), where
            assert shd.shard_bytes(pparams, pps, pmesh) == \
                _ref_bytes(rparams, rps, rmesh), where
            for m in MOMENTS:
                ros = ref_shd.opt_specs(rmesh, ropts[m], rparams, rps)
                pos = shd.opt_specs(pmesh, popts[m], pparams, pps)
                assert _port_specs(pos) == _ref_specs(ros), (where, m)
                assert shd.shard_bytes(popts[m], pos, pmesh) == \
                    _ref_bytes(ropts[m], ros, rmesh), (where, m)
            for name, s in SHAPES.items():
                rb = ref_shd.batch_specs(rmesh, rcfg, s)
                pb = shd.batch_specs(pmesh, cfg, s)
                assert {k: canon(v) for k, v in pb.items()} == \
                    {k: canon(v) for k, v in rb.items()}, (where, name)
            assert sorted(pcaches) == sorted(rcaches)
            for name in rcaches:
                B = SHAPES[name].global_batch
                rcs = ref_shd.cache_specs(rmesh, rcfg, rcaches[name], B)
                pcs = shd.cache_specs(pmesh, cfg, pcaches[name], B)
                assert _port_specs(pcs) == _ref_specs(rcs), (where, name)
                assert shd.shard_bytes(pcaches[name], pcs, pmesh) == \
                    _ref_bytes(rcaches[name], rcs, rmesh), (where, name)


def test_flat_dp_splits_a_dim_over_both_axes(flat_dp_off):
    """Under flat DP the DP axes are ("data", "model"): a weight's FSDP dim
    splits over both, in the mesh's order, as DTensor places it."""
    shd.set_flat_dp(True)
    spec = shd.param_specs(MESH, {"attn": {"wq": meta(2048, 2048)}})
    assert spec["attn"]["wq"] == (("data", "model"), None)


# ------------------------------------------------------ (c) the quantizer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1000, 12295, 1 << 20])
def test_quantizer_gives_reference_bits(n, dtype):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
         ).astype(np.float32)
    x[:256] = 0.0                                   # an all-zero block
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    rq, rs = ref_gc.quantize_int8(jx)
    q, s = gc.quantize_int8(tx)
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.float().numpy(), np.asarray(rs, np.float32))
    assert s.dtype == tx.dtype
    rd = np.asarray(ref_gc.dequantize_int8(rq, rs, jx.shape))
    pd = gc.dequantize_int8(q, s, tx.shape)
    assert pd.dtype == torch.float32 and rd.dtype == np.float32
    assert np.array_equal(pd.numpy().view(np.uint32), rd.view(np.uint32))


# ---------------------------------------------- (d) 4 ranks against 4 devices
def _inputs(rng) -> dict:
    return dict(
        table=rng.standard_normal((64, 16)).astype(np.float32),
        tokens=rng.integers(0, 64, (4, 8)).astype(np.int32),
        g=rng.standard_normal((4, 8, 16)).astype(np.float32),
        gc_x=(rng.standard_normal((4, 1000))
              * np.exp(rng.uniform(-4, 4, (4, 1000)))).astype(np.float32),
        gc_err=(1e-3 * rng.standard_normal((4, 1000))).astype(np.float32),
        pipe_w=(0.5 * rng.standard_normal((4, 8, 8))).astype(np.float32),
        pipe_b=(0.1 * rng.standard_normal((4, 8))).astype(np.float32),
        pipe_xs=rng.standard_normal((6, 2, 8)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 4 host devices and the port on 4 gloo ranks, all
    five processes at once: (reference outputs, [each rank's outputs],
    inputs, the checkpoint's state)."""
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs(np.random.default_rng(0))
    np.savez(d / "inputs.npz", **inp)
    cfg = ref_config("gemma-2b").reduced()
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(3))
    state = {"params": params, "step": jnp.asarray(7, jnp.int32)}
    RefCkpt(str(d / "ckpt")).save(5, state, blocking=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4"))
    procs = [subprocess.Popen([sys.executable, HELPER, "ref", str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)]
    port_env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    port_env["OMP_NUM_THREADS"] = "1"
    procs += [subprocess.Popen(
        [sys.executable, HELPER, "port", str(d), str(r), "4"], env=port_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ref = dict(np.load(d / "ref.npz"))
    port = [dict(np.load(d / f"port_{r}.npz")) for r in range(4)]
    return ref, port, inp, jax.device_get(state)


def test_host_mesh_clamps_as_the_reference(runs):
    ref, port, _, _ = runs
    assert tuple(ref["host_mesh_8x8"]) == (4, 1)
    for r, out in enumerate(port):
        assert tuple(out["host_mesh_8x8"]) == tuple(ref["host_mesh_8x8"])
        assert tuple(out["coordinate"]) == divmod(r, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [True, False])
def test_sharded_embedding_matches_reference_on_4_ranks(runs, tied, dtype):
    ref, port, _, _ = runs
    rtol = 1e-6 if dtype == "float32" else 2e-2
    rx, rg = ref[f"embed_x_{tied}_{dtype}"], ref[f"embed_grad_{tied}_{dtype}"]
    assert np.abs(rg).max() > 0
    for out in port:
        assert np.array_equal(out[f"embed_x_{tied}_{dtype}"], rx)
        np.testing.assert_allclose(out[f"embed_grad_{tied}_{dtype}"], rg,
                                   rtol=rtol, atol=rtol * np.abs(rg).max())
    # tied: x replicated over "model"; untied: its d split over "model"
    want = ("(Shard(dim=0), Replicate())" if tied
            else "(Shard(dim=0), Shard(dim=2))")
    assert str(port[0][f"embed_x_placements_{tied}_{dtype}"]) == want


def test_compressed_psum_matches_reference_on_4_ranks(runs):
    ref, port, inp, _ = runs
    for r, out in enumerate(port):
        x = jnp.asarray(inp["gc_x"][r] + inp["gc_err"][r])
        q, s = ref_gc.quantize_int8(x)
        sent = np.asarray(ref_gc.dequantize_int8(q, s, x.shape))
        assert np.array_equal(out["gc_sent"].view(np.uint32),
                              sent.view(np.uint32))
        for axis in ("data", "model"):
            assert np.array_equal(out[f"gc_error_{axis}"].view(np.uint32),
                                  ref[f"gc_error_{axis}"][r].view(np.uint32))
            np.testing.assert_allclose(
                out[f"gc_reduced_{axis}"], ref[f"gc_reduced_{axis}"][r],
                rtol=1e-6, atol=1e-6 * np.abs(ref[f"gc_reduced_{axis}"]).max())
        assert bool(out["gc_tree_same"])
    # the reduced value is the sum of the sent values over the axis' ranks
    sents = np.stack([o["gc_sent"] for o in port])
    np.testing.assert_allclose(port[0]["gc_reduced_data"],
                               sents[0] + sents[2], rtol=1e-6)
    np.testing.assert_allclose(port[0]["gc_reduced_model"],
                               sents[0] + sents[1], rtol=1e-6)


def test_pipeline_matches_reference_last_stage_on_4_ranks(runs):
    ref, port, _, _ = runs
    want = ref["pipe_last_stage_4_reversed"]
    assert np.abs(want).max() > 0.1
    for out in port:
        np.testing.assert_allclose(out["pipe_out"], want, rtol=2e-5,
                                   atol=2e-5)


def test_pipeline_is_bit_equal_to_sequential_stages(runs):
    _, port, _, _ = runs
    for out in port:
        assert np.array_equal(out["pipe_out"], out["pipe_sequential"])


def test_reference_pipeline_returns_zeros_r8(runs):
    """R8: the reference's ``pipeline_forward`` returns stage 0's buffer,
    zeros for S >= 2, though its last stage holds the right outputs."""
    ref, port, inp, _ = runs
    for tag in ("4_inorder", "2_inorder"):
        assert np.abs(ref[f"pipe_returned_{tag}"]).max() == 0.0
    np.testing.assert_allclose(ref["pipe_last_stage_4_inorder"],
                               port[0]["pipe_out"], rtol=2e-5, atol=2e-5)
    S2 = inp["pipe_xs"]
    for s in range(2):
        S2 = np.tanh(S2 @ inp["pipe_w"][s] + inp["pipe_b"][s])
    np.testing.assert_allclose(ref["pipe_last_stage_2_inorder"], S2,
                               rtol=2e-5, atol=2e-5)


def test_elastic_restore_matches_reference_shards_on_4_ranks(runs):
    ref, port, _, state = runs
    paths = sorted(k[len("ckpt_spec/"):] for k in ref
                   if k.startswith("ckpt_spec/"))
    both_axes = [p for p in paths
                 if "('data', 'model')" in str(ref[f"ckpt_spec/{p}"])]
    assert both_axes, "a dim split over both axes"
    for r, out in enumerate(port):
        for p in paths:
            assert str(out[f"ckpt_spec/{p}"]) == str(ref[f"ckpt_spec/{p}"])
            assert out[f"ckpt/{p}"].tobytes() == ref[f"ckpt/{p}@{r}"].tobytes(), \
                (r, p)
        assert bool(out["ckpt_step_is_plain"])
        assert str(out["ckpt_step_device"]) == "cpu"


# ------------------------------------------------------------ (f) the hint
def test_shard_hint_refuses_a_plain_tensor_over_an_axis_of_2(runs):
    _, port, _, _ = runs
    for out in port:
        assert "'data' of size 2" in str(out["shard_hint_plain_raised"])
        assert bool(out["shard_hint_no_hint_is_input"])
        # a DTensor (dim 1 over "data") redistributed to ("data", None,
        # "model"): dim 0 over "data", dim 2 over "model", the same values
        assert str(out["shard_hint_dtensor_placements"]) == \
            "(Shard(dim=0), Shard(dim=2))"
        assert bool(out["shard_hint_dtensor_same"])


def test_shard_hint_without_a_hint_and_on_a_mesh_of_ones():
    x = torch.zeros(4, 8, 16)
    assert common.get_mesh_hint() is None
    assert common.shard_hint(x, "dp", None, "model") is x
    table, tok = torch.randn(64, 16), torch.randint(0, 64, (4, 8))
    assert torch.equal(common.embed_lookup(table, tok), table[tok])
    try:
        common.set_mesh_hint(PortAbstractMesh((1, 1), ("data", "model")))
        assert common.shard_hint(x, "dp", None, "model") is x
        common.set_mesh_hint(PortAbstractMesh((2, 2), ("data", "model")))
        with pytest.raises(ValueError, match="'model' of size 2"):
            common.shard_hint(x, None, None, "model")
    finally:
        common.set_mesh_hint(None)


def test_placements_refuse_axes_out_of_the_mesh_order():
    class Mesh:                                    # what placements reads
        mesh_dim_names = ("data", "model")
    assert len(shd.placements(Mesh, (("data", "model"), None))) == 2
    with pytest.raises(ValueError, match="order"):
        shd.placements(Mesh, (("model", "data"), None))


# ------------------------------------------------- (g) the dry run's mesh
@pytest.mark.parametrize("arch", ["gemma-2b", "yi-6b"])
@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_dryrun_mesh_cells_match_reference_bytes(arch, mesh_name):
    cfg = ref_config(arch)
    for flat in (False, True):
        want = _ref_cell_bytes(arch, mesh_name, flat)
        for name, shape in SHAPES.items():
            rec = dryrun.run_cell(arch, name, device="cpu",
                                  hbm_bytes=H100_BYTES, predict_only=True,
                                  mesh=mesh_name, flat_dp=flat)
            assert rec["cell"] == f"{cfg.name}|{name}|{mesh_name}"
            if not cfg.shape_applicable(shape)[0]:
                assert rec["status"] == "skipped"
                continue
            per = rec["per_device_bytes"]
            assert per["params"] == want["params"]
            n_chips = 256 if mesh_name == "16x16" else 512
            assert rec["n_chips"] == n_chips and rec["ran"] is False
            if shape.kind == "train":
                assert per["opt_state"] == want["opt_state"]
                offload = cfg.n_params() * 14 / n_chips > 0.35 * H100_BYTES
                assert rec["mode"] == ("offload-grads" if offload
                                       else "fused")
            if shape.kind == "decode":
                assert per["cache"] == want[name]
    assert not shd.flat_dp()


def test_dryrun_mesh_is_predicted_only():
    with pytest.raises(ValueError, match="predicted only"):
        dryrun.run_cell("gemma-2b", "train_4k", device="cpu",
                        hbm_bytes=H100_BYTES, mesh="16x16")
