"""The port's xlstm (mLSTM + sLSTM) against the reference, on the CPU at
small sizes: the parameters, both blocks' forward and decode, the model's
``forward`` / ``loss_fn`` / every gradient, ``decode_step`` with its
caches, greedy tokens through ``ServeEngine``, a training step, the scan at
a wide state (N 128, P 129), the runtime's leaf spans and the launchers.

Two configs: the reference's ``reduced()`` xlstm (4 heads: N = 32, P = 33
before and after the normalizer's ones column; one mLSTM and one sLSTM
layer) and the same at one head (N = 128, P = 129: the state the SSD
kernels take by their wide route on the card).  Inputs are numpy draws;
the reference's fp32 parameters and optimizer state are carried across by
``repro_torch.convert``.  On CPU tensors the port's wrappers run their
plain versions; the kernels are held against those on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances (``tests/test_torch_ssm.py``): MODEL_TOL (1e-5) for blocks,
logits, loss and gradients with fp32 parameters -- fp32 summation order;
SSD_TOL (1e-4, the reference's SSD tolerance) for the scan and the
mLSTM's carried state; 2 * lr for a training step's parameters.

The reference forms exp(cum_i - cum_j) for every pair of a chunk and masks
afterwards (ROADMAP R4).  With xlstm's gates (log f about -0.8) that
overflows within a chunk of 256 and its gradient is NaN at the model's own
initialization; the gradient tests use sequences short enough that the
reference stays finite (asserted first), and one test pins the NaN.
"""

import dataclasses
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mamba2 as ref_mamba  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.train.step import build_train_step as ref_build_train_step  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import mamba2 as port_mamba  # noqa: E402
from repro_torch.models import xlstm as port_xlstm  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402
from test_torch_ssm import (MODEL_TOL, SSD_TOL, as_np,  # noqa: E402
                            jax_leaf_paths, scan_inputs)

CASES = ["reduced", "one-head"]


def xlstm_config(case: str):
    cfg = get_config("xlstm").reduced()
    if case == "one-head":
        cfg = dataclasses.replace(cfg, name=cfg.name + "-h1", n_heads=1,
                                  n_kv_heads=1)
    return cfg


@pytest.fixture(scope="module", params=CASES)
def xl(request):
    """(cfg, reference fp32 params, the port's copy, tokens (2, 40))."""
    cfg = xlstm_config(request.param)
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40))
    return cfg, jp, tp, toks


def _block(tree, i=0):
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def _x(cfg, seed, *lead):
    return np.random.default_rng(seed).standard_normal(
        (*lead, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("case", CASES)
def test_port_init_params_has_the_reference_keys_shapes_and_dtypes(case):
    cfg = xlstm_config(case)
    jp = jax.eval_shape(lambda: ref_lm.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    tp = port_lm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ref_shapes = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
                  for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    port_shapes = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for p, t in _tree.flatten_with_path(tp)[0]}
    assert port_shapes == ref_shapes
    assert tp["mlstm_blocks"]["in_proj"].shape[0] == 1        # stacked
    assert port_lm._xlstm_layout(get_config("xlstm")) == [
        ("m", 0, 7), ("s", 0, 1), ("m", 7, 7), ("s", 1, 1), ("m", 14, 7),
        ("s", 2, 1)]


def test_params_from_numpy_carries_the_stacked_blocks(xl):
    cfg, jp, tp, _ = xl
    for group in ("mlstm_blocks", "slstm_blocks"):
        for name, leaf in jp[group].items():
            t = tp[group][name]
            assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


# ---------------------------------------------------------------- blocks
def test_mlstm_forward_matches_reference(xl):
    cfg, jp, tp, _ = xl
    x = _x(cfg, 7, 2, 40)
    for chunk in (256, 16):                # one chunk, and ragged chunks
        gold = ref_xlstm.mlstm_forward(_block(jp["mlstm_blocks"]),
                                       jnp.asarray(x), cfg, chunk=chunk)
        out = port_xlstm.mlstm_forward(_block(tp["mlstm_blocks"]),
                                       torch.from_numpy(x), cfg, chunk=chunk)
        np.testing.assert_allclose(as_np(out), as_np(gold), **MODEL_TOL)


def test_slstm_forward_matches_reference(xl):
    cfg, jp, tp, _ = xl
    x = _x(cfg, 8, 2, 40)
    gold = ref_xlstm.slstm_forward(_block(jp["slstm_blocks"]),
                                   jnp.asarray(x), cfg)
    out = port_xlstm.slstm_forward(_block(tp["slstm_blocks"]),
                                   torch.from_numpy(x), cfg)
    np.testing.assert_allclose(as_np(out), as_np(gold), **MODEL_TOL)


def test_slstm_scan_backward_equals_autograd_through_the_cell():
    """The sLSTM's sequence Function (forward with no graph, the cell's
    gradient written out) against autograd through a loop of
    ``_slstm_cell``, in float64: the same values and gradients, ties of
    both maxima included (i_t = f_t at the first step, where m = 0, makes
    m' = i_t = f_t + m and |n'| = 1 exactly)."""
    rng = np.random.default_rng(14)
    B, S, H, P = 2, 9, 2, 8
    gates = torch.from_numpy(rng.standard_normal((B, S, H, 4 * P)) * 1.5)
    gates[:, 0, :, P:2 * P] = gates[:, 0, :, 2 * P:3 * P]
    r = torch.from_numpy(rng.standard_normal((H, P, 4 * P)) / P ** 0.5)
    g_out = torch.from_numpy(rng.standard_normal((B, S, H, P)))
    leaves = [t.clone().requires_grad_() for t in (gates, r)]
    zeros = torch.zeros((B, H, P), dtype=torch.float64)
    carry, hs = (zeros,) * 4, []
    for t in range(S):
        carry = port_xlstm._slstm_cell(leaves[1], carry, leaves[0][:, t])
        hs.append(carry[0])
    want_h = torch.stack(hs, dim=1)
    want = torch.autograd.grad((want_h * g_out).sum(), leaves)
    live = [t.clone().requires_grad_() for t in (gates, r)]
    got_h = port_xlstm._SLSTMScan.apply(*live)
    got = torch.autograd.grad((got_h * g_out).sum(), live)
    torch.testing.assert_close(got_h, want_h.detach(), rtol=1e-12,
                               atol=1e-12)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_mlstm_decode_matches_reference_and_updates_its_state_in_place(xl):
    cfg, jp, tp, _ = xl
    jblk, tblk = _block(jp["mlstm_blocks"]), _block(tp["mlstm_blocks"])
    jc = ref_xlstm.init_mlstm_cache(cfg, 2)
    tc = port_xlstm.init_mlstm_cache(cfg, 2, device="cpu")
    state = tc["state"]
    for x in _x(cfg, 9, 6, 2):
        gold, jc = ref_xlstm.mlstm_decode(jblk, jnp.asarray(x)[:, None], jc,
                                          cfg)
        out = port_xlstm.mlstm_decode(tblk, torch.from_numpy(x), tc, cfg)
        np.testing.assert_allclose(as_np(out), as_np(gold)[:, 0], **MODEL_TOL)
    assert tc["state"] is state
    np.testing.assert_allclose(as_np(state), as_np(jc["state"]), **SSD_TOL)


def test_slstm_decode_matches_reference_and_updates_its_cache_in_place(xl):
    cfg, jp, tp, _ = xl
    jblk, tblk = _block(jp["slstm_blocks"]), _block(tp["slstm_blocks"])
    jc = ref_xlstm.init_slstm_cache(cfg, 2)
    tc = port_xlstm.init_slstm_cache(cfg, 2, device="cpu")
    held = dict(tc)
    for x in _x(cfg, 10, 6, 2):
        gold, jc = ref_xlstm.slstm_decode(jblk, jnp.asarray(x)[:, None], jc,
                                          cfg)
        out = port_xlstm.slstm_decode(tblk, torch.from_numpy(x), tc, cfg)
        np.testing.assert_allclose(as_np(out), as_np(gold)[:, 0], **MODEL_TOL)
    for name in ("h", "c", "n", "m"):
        assert tc[name] is held[name]
        np.testing.assert_allclose(as_np(tc[name]), as_np(jc[name]),
                                   **MODEL_TOL, err_msg=name)


# -------------------------------------------------- forward, loss, grads
@pytest.fixture(scope="module")
def xl_ref(xl):
    cfg, jp, _, toks = xl
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32)}
    jlogits, _ = jax.jit(lambda p: ref_lm.forward(p, cfg, jb["tokens"]))(jp)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, cfg, jb), has_aux=True))(jp)
    return jlogits, jloss, jm, jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_xlstm_forward_loss_and_every_gradient_match_reference(
        xl, xl_ref, remat):
    cfg, _, tp, toks = xl
    jlogits, jloss, jm, jgrads = xl_ref
    want = jax_leaf_paths(jgrads)
    # 40 positions, one chunk: the reference's unmasked exponentials stay
    # finite (R4)
    assert all(np.isfinite(np.asarray(g)).all() for g in want.values())
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    ops.reset_launch_counts()
    tlogits, aux = port_lm.forward(tp, cfg, tb["tokens"], remat=remat)
    np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), **MODEL_TOL)
    assert float(aux) == 0.0
    leaves, treedef = _tree.flatten(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    tloss, tm = port_lm.loss_fn(_tree.unflatten(treedef, live), cfg, tb,
                                remat=remat)
    tgrads = torch.autograd.grad(tloss, live)
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(tm["nll"].detach()) == pytest.approx(float(jm["nll"]),
                                                     rel=1e-5)
    got = {p: g for (p, _), g in zip(_tree.flatten_with_path(tp)[0], tgrads)}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(as_np(g), as_np(want[path]), **MODEL_TOL,
                                   err_msg=path)
    assert set(ops.launch_counts().values()) == {0}     # CPU: no kernel


def test_xlstm_forward_runs_the_scan_once_per_mlstm_layer(xl, monkeypatch):
    cfg, _, tp, toks = xl
    calls = {"ssd_scan": 0, "flash_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    port_lm.forward(tp, cfg, torch.from_numpy(toks))
    assert calls == {"ssd_scan": port_lm._xlstm_counts(cfg)[0],
                     "flash_attention": 0}


def test_reference_gradient_is_nan_at_chunk_256_and_the_ports_finite_r4():
    """One mLSTM block at its own initialization over 256 positions, one
    chunk: the reference's exp(cum_i - cum_j) above the diagonal overflows
    and its gradient is NaN; the port forms the decays only where i >= j
    and its gradient is finite."""
    cfg = xlstm_config("reduced")
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    x = _x(cfg, 12, 1, 256)
    dy = np.random.default_rng(13).standard_normal(x.shape).astype(
        np.float32)
    gold = jax.grad(lambda xx: jnp.sum(ref_xlstm.mlstm_forward(
        _block(jp["mlstm_blocks"]), xx, cfg, chunk=256) * dy))(
        jnp.asarray(x))
    assert np.isnan(np.asarray(gold)).any()
    xt = torch.from_numpy(x).requires_grad_()
    out = port_xlstm.mlstm_forward(_block(tp["mlstm_blocks"]), xt, cfg,
                                   chunk=256)
    (got,) = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), xt)
    assert bool(torch.isfinite(got).all())


# ------------------------------------------------ the scan at a wide state
@pytest.mark.parametrize("with_initial", [False, True])
def test_chunked_linear_scan_at_a_wide_state_matches_reference(with_initial):
    """N 128, P 129 (the one-head xlstm's state), 100 positions in chunks
    of 32 (the last ragged), decays as the mLSTM's (a sigmoid)."""
    B, H, S, N, P, chunk = 1, 2, 100, 128, 129, 32
    a, k, v, q = scan_inputs(17, B, H, S, N, P)
    bshp = [np.ascontiguousarray(np.moveaxis(x, 1, 2)) for x in (a, k, v, q)]
    s0 = (np.random.default_rng(18).standard_normal((B, H, N, P)) * 0.3
          ).astype(np.float32) if with_initial else None
    jy, jfin = ref_mamba.chunked_linear_scan(
        *(jnp.asarray(x) for x in bshp), chunk=chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    ty, tfin = port_mamba.chunked_linear_scan(
        *(torch.from_numpy(x) for x in bshp), chunk=chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    assert ty.shape == (B, S, H, P) and tfin.shape == (B, H, N, P)
    np.testing.assert_allclose(as_np(ty), as_np(jy), **SSD_TOL)
    np.testing.assert_allclose(as_np(tfin), as_np(jfin), **SSD_TOL)
    # the normalizer's column on its own (the kernels' ragged P tile)
    np.testing.assert_allclose(as_np(ty)[..., -1], as_np(jy)[..., -1],
                               **SSD_TOL)


def test_augmented_value_pads_its_rows_and_hides_the_padding():
    v = torch.randn(2, 3, 4, 8)
    i = torch.rand(2, 3, 4)
    aug = port_xlstm._augment(v, i)
    assert aug.shape == (2, 3, 4, 9) and aug.stride(-2) == 12
    torch.testing.assert_close(aug[..., :8], v * i[..., None])
    torch.testing.assert_close(aug[..., 8], i)


# ------------------------------------------------------------ decode_step
def test_xlstm_decode_step_and_caches_match_reference(xl):
    cfg, jp, tp, toks = xl
    B, S, steps = 2, 16, 6
    jc = ref_lm.init_cache(cfg, B, S)
    tc = port_lm.init_cache(cfg, B, S, device="cpu")
    assert {p: tuple(t.shape) for p, t in _tree.flatten_with_path(tc)[0]} \
        == {p: tuple(a.shape) for p, a in jax_leaf_paths(jc).items()}
    held = {p: t for p, t in _tree.flatten_with_path(tc)[0]}
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, cfg, c, t, pos))
    for i in range(steps):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i], jnp.int32),
                      jnp.int32(i))
        tl = port_lm.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, i]), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    want = jax_leaf_paths(jc)
    for path, t in _tree.flatten_with_path(tc)[0]:
        assert t is held[path] and t.dtype == torch.float32, path
        tol = SSD_TOL if path == "['mlstm']['state']" else MODEL_TOL
        np.testing.assert_allclose(as_np(t), as_np(want[path]), **tol,
                                   err_msg=path)


def test_serve_engine_greedy_tokens_and_kv_cache_spans_match_reference(xl):
    cfg, jp, tp, toks = xl
    out = []
    for core, make, params, kw in (
            (ref_core, RefEngine, jp, {}),
            (port_core, ServeEngine, tp, dict(device="cpu"))):
        rt = core.UnimemRuntime(core.PAPER_DRAM_NVM,
                                core.RuntimeConfig(backend="sim"))
        eng = make(cfg, params, max_seq=16, batch=2, runtime=rt,
                   tenant="t0", **kw)
        prompts = toks[:, :5]
        tokens = eng.generate(torch.from_numpy(prompts) if kw
                              else jnp.asarray(prompts, jnp.int32), 6)
        out.append((np.asarray(tokens),
                    rt.registry["t0/kv_cache"].leaf_spans,
                    rt.registry["t0/kv_cache"].size_bytes))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1:] == out[0][1:]
    assert any("['mlstm']['state']" in s[0] for s in out[1][1])


# ------------------------------------------------ runtime spans and a step
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_runtime_leaf_spans_match_reference(xl, moments):
    cfg, jp, tp, _ = xl
    js = ref_init_opt_state(jp, RefAdamWConfig(moments_dtype=moments))
    ts = init_opt_state(tp, AdamWConfig(moments_dtype=moments))
    spans = []
    for core, p, s in ((ref_core, jp, js), (port_core, tp, ts)):
        rt = core.UnimemRuntime(core.PAPER_DRAM_NVM,
                                core.RuntimeConfig(backend="sim"))
        a = rt.register("opt_state", s, chunkable=True, manage_payload=False)
        b = rt.register("params", p, pinned=True, manage_payload=False)
        spans.append((a.leaf_spans, a.size_bytes, b.leaf_spans,
                      b.size_bytes))
    assert spans[0] == spans[1]
    assert any("['slstm_blocks']" in s[0] for s in spans[1][2])


def test_xlstm_train_step_matches_reference(xl):
    cfg, jp, _, toks = xl
    js = ref_init_opt_state(jp, RefAdamWConfig(lr=1e-3))
    ts = params_from_numpy(jax.device_get(js), device="cpu")
    tp = params_from_numpy(jax.device_get(jp), device="cpu")   # a copy
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32)}
    jp2, _, jm = jax.jit(ref_build_train_step(
        cfg, RefAdamWConfig(lr=1e-3), lr=1e-3))(jp, js, jb)
    t = torch.from_numpy(toks)
    tp2, _, tm = build_train_step(cfg, AdamWConfig(lr=1e-3), lr=1e-3)(
        tp, ts, {"tokens": t, "labels": t})
    for k in ("loss", "grad_norm", "step", "aux"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7)
    want = jax_leaf_paths(jp2)
    for path, leaf in _tree.flatten_with_path(tp2)[0]:
        np.testing.assert_allclose(as_np(leaf), as_np(want[path]), rtol=0,
                                   atol=2e-3, err_msg=path)


# ----------------------------------------------------------- the launchers
def test_train_launcher_runs_xlstm_on_cpu(capsys):
    from repro_torch.launch.train import main
    ops.reset_launch_counts()
    main(["--arch", "xlstm", "--reduced", "--device", "cpu", "--steps", "3",
          "--batch", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    final, first = re.search(r"final loss: (\S+) \(first: (\S+)\)",
                             out).groups()
    assert np.isfinite(float(final)) and np.isfinite(float(first))
    assert set(ops.launch_counts().values()) == {0}


def test_serve_launcher_runs_xlstm_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "xlstm",
                                      "--reduced", "--device", "cpu",
                                      "--new", "4", "--prompt-len", "5"])
    serve.main()
    assert "generated (4, 9)" in capsys.readouterr().out


# ------------------------------------------------- five steps at lr 3e-4
Q1_LR = 3e-4
Q1_STEPS = 5


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-4)])
def test_five_adamw_steps_at_3e_4_follow_the_reference(dtype, rtol):
    """ROADMAP's Q1: xlstm-350m's loss holds flat at lr 3e-4 on the card.
    From the same reduced parameters, both packages take five AdamW steps
    at 3e-4 on the same five batches of the train loop's synthetic stream,
    and their losses agree step by step: the port's training follows the
    reference's, so a flat loss at this rate is the model's and not the
    port's.  Tolerances: fp32 parameters 1e-5 relative (summation order);
    bf16 parameters (fp32 master copy, as the card trains) 2e-4: the two
    packages round the bf16 forward's products and activations at their
    own places, which puts the first step's losses 2.9e-5 apart and the
    third's 1.3e-4.  In both the loss falls over the five steps at this
    size (4.874 to 4.822)."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    cfg = get_config("xlstm").reduced()
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jd)
    ropt, popt = RefAdamWConfig(lr=Q1_LR), AdamWConfig(lr=Q1_LR)
    js = ref_init_opt_state(jp, ropt)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    ts = params_from_numpy(jax.device_get(js), device="cpu")
    ref_step = jax.jit(ref_build_train_step(cfg, ropt, lr=Q1_LR))
    port_step = build_train_step(cfg, popt, lr=Q1_LR)
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 40, 4, seed=3),
                                  device="cpu")
    ref_losses, port_losses = [], []
    for step in range(Q1_STEPS):
        batch = data.batch_at(step)
        toks = batch["tokens"].numpy()
        jb = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(toks, jnp.int32)}
        jp, js, jm = ref_step(jp, js, jb)
        tp, ts, tm = port_step(tp, ts, batch)
        ref_losses.append(float(jm["loss"]))
        port_losses.append(float(tm["loss"]))
    assert all(np.isfinite(ref_losses + port_losses))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=rtol, atol=0)
    print(dtype, "losses, reference:", ref_losses, "port:", port_losses)
