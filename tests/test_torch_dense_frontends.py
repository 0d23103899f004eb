"""The port's plain two-layer MLP and its vision and audio frontends
against the reference, on the CPU at the reduced size: the MLP's forward
and one-token decode (gelu: musicgen-large; squared ReLU:
nemotron-4-340b), ``forward`` / ``loss_fn`` / every gradient with frontend
embeddings fed (phi-3-vision-4.2b's patches through ``frontend_proj``,
musicgen-large's frames as they are), the parameter trees and their
conversion, and the config registry.  The models' text-only logits,
losses, gradients, decode and greedy tokens are held in
``test_torch_train.py`` and ``test_torch_serve.py`` (cases ``musicgen``,
``phi3v``, ``nemotron`` and ``nemotron-g12`` of
``_torch_models.MODEL_CASES``).

Inputs are drawn with numpy and handed to both packages; the reference's
fp32 parameters are carried across with ``repro_torch.convert``.
Tolerances: fp32 1e-5 absolute and relative (``MODEL_TOL``: summation
order over at most a few hundred terms); bf16 2e-2 (the reference's
kernel tolerance: each package rounds the products and the activation to
bf16 at its own places).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import mlp as port_mlp  # noqa: E402
from _torch_models import reduced_case  # noqa: E402

MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NEW_CASES = ("musicgen", "phi3v", "nemotron")
FRONTEND_CASES = ("musicgen", "phi3v")


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_leaf_paths(tree):
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------- plain MLP
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["musicgen", "nemotron"])
def test_plain_mlp_forward_and_decode_match_reference(case, dtype):
    """``mlp_forward`` over (2, 24, d) and ``mlp_decode`` over (3, d)
    against the reference's ``mlp_forward``: act(x @ w_up) @ w_down."""
    cfg = reduced_case(case)
    assert cfg.mlp_type == "mlp"
    assert cfg.activation == {"musicgen": "gelu",
                              "nemotron": "squared_relu"}[case]
    jd, td = DTYPES[dtype]
    jp = ref_mlp.init_mlp_params(jax.random.PRNGKey(1), cfg, dtype=jd)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    assert sorted(tp) == ["w_down", "w_up"]
    tol = MODEL_TOL if dtype == "float32" else BF16_TOL
    x = _x((2, 24, cfg.d_model), 2)
    want = ref_mlp.mlp_forward(jp, jnp.asarray(x, jd), cfg)
    got = port_mlp.mlp_forward(tp, torch.from_numpy(x).to(td), cfg)
    assert got.dtype == td
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    x1 = _x((3, cfg.d_model), 3)
    want = ref_mlp.mlp_forward(jp, jnp.asarray(x1, jd)[:, None], cfg)[:, 0]
    got = port_mlp.mlp_decode(tp, torch.from_numpy(x1).to(td), cfg)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


@pytest.mark.parametrize("case", NEW_CASES)
def test_mlp_decode_sends_every_product_through_tiered_matmul(case,
                                                              monkeypatch):
    """Two launches a plain MLP, three a gated one (phi-3-vision)."""
    cfg = reduced_case(case)
    tp = port_mlp.init_mlp_params(torch.Generator().manual_seed(0), cfg,
                                  None, torch.float32)
    calls = []
    real = ops.tiered_matmul
    monkeypatch.setattr(ops, "tiered_matmul",
                        lambda x, w: calls.append(tuple(w.shape))
                        or real(x, w))
    port_mlp.mlp_decode(tp, torch.zeros((2, cfg.d_model)), cfg)
    d, f = cfg.d_model, cfg.d_ff
    assert calls == ([(d, f), (f, d)] if cfg.mlp_type == "mlp"
                     else [(d, f), (d, f), (f, d)])


# ------------------------------------------------------------- frontends
@pytest.fixture(scope="module", params=FRONTEND_CASES)
def front(request):
    """(cfg, reference fp32 params, the port's copy, tokens (2, 20),
    frontend embeddings (2, frontend_tokens, d)) of a frontend config,
    and the reference's logits, loss and gradients (parameters' and the
    embeddings') with the embeddings fed."""
    cfg = reduced_case(request.param)
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20))
    fe = _x((2, cfg.frontend_tokens, cfg.d_model), 6)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32)}
    jlogits, _ = jax.jit(lambda p, f: ref_lm.forward(
        p, cfg, jb["tokens"], f))(jp, jnp.asarray(fe))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, f: ref_lm.loss_fn(p, cfg, dict(jb, frontend=f)),
        argnums=(0, 1), has_aux=True))(jp, jnp.asarray(fe))
    return cfg, tp, toks, fe, (jlogits, jloss, jm, jgrads)


@pytest.mark.parametrize("remat", [False, True])
def test_frontend_forward_loss_and_every_gradient_match_reference(front,
                                                                  remat):
    cfg, tp, toks, fe, (jlogits, jloss, jm, (jgp, jgf)) = front
    n_front = cfg.frontend_tokens
    t = torch.from_numpy(toks)
    tlogits, _ = port_lm.forward(tp, cfg, t, torch.from_numpy(fe),
                                 remat=remat)
    assert tlogits.shape == (2, n_front + 20, cfg.vocab_size)
    np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), **MODEL_TOL)

    leaves, treedef = _tree.flatten(tp)
    live = [x.clone().requires_grad_() for x in leaves]
    tfe = torch.from_numpy(fe).requires_grad_()
    tloss, tm = port_lm.loss_fn(_tree.unflatten(treedef, live), cfg,
                                {"tokens": t, "labels": t, "frontend": tfe},
                                remat=remat)
    *tgrads, gfe = torch.autograd.grad(tloss, live + [tfe])
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(tm["nll"]) == pytest.approx(float(jm["nll"]), rel=1e-5)
    np.testing.assert_allclose(as_np(gfe), as_np(jgf), **MODEL_TOL)
    assert float(gfe.abs().max()) > 0
    want = _jax_leaf_paths(jgp)
    got = {p: g for (p, _), g in zip(_tree.flatten_with_path(tp)[0], tgrads)}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(as_np(g), as_np(want[path]), **MODEL_TOL,
                                   err_msg=path)
    if cfg.frontend == "vision":
        assert float(got["['frontend_proj']"].abs().max()) > 0


def test_frontend_positions_come_first_and_carry_no_loss(front):
    """The text's logits with frontend embeddings fed are those of the
    text at positions n_front.. (rope counts the frontend), and the loss
    is the text's next-token loss over exactly those logits."""
    cfg, tp, toks, fe, _ = front
    t = torch.from_numpy(toks)
    logits, _ = port_lm.forward(tp, cfg, t, torch.from_numpy(fe))
    text_only, _ = port_lm.forward(tp, cfg, t)
    assert logits.shape[1] == text_only.shape[1] + cfg.frontend_tokens
    # the frontend changes what the text attends to
    assert not torch.allclose(logits[:, cfg.frontend_tokens:], text_only)
    loss, m = port_lm.loss_fn(tp, cfg, {"tokens": t, "labels": t,
                                        "frontend": torch.from_numpy(fe)})
    lg = logits[:, cfg.frontend_tokens:-1].float()
    want = torch.nn.functional.cross_entropy(
        lg.reshape(-1, cfg.vocab_size), t[:, 1:].reshape(-1))
    assert float(m["nll"]) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("case", FRONTEND_CASES)
def test_frontend_forward_matches_reference_in_bf16(case):
    """bf16 parameters and embeddings, as the card's train phases run."""
    cfg = reduced_case(case)
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12))
    fe = _x((2, cfg.frontend_tokens, cfg.d_model), 9)
    want, _ = ref_lm.forward(jp, cfg, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(fe, jnp.bfloat16))
    got, _ = port_lm.forward(tp, cfg, torch.from_numpy(toks),
                             torch.from_numpy(fe).bfloat16())
    assert got.dtype == torch.bfloat16
    scale = 1 + np.abs(as_np(want)).max()
    assert np.abs(as_np(got) - as_np(want)).max() <= 2e-2 * scale


# ---------------------------------------------------- parameter trees
@pytest.mark.parametrize("case", NEW_CASES)
def test_port_init_params_has_the_reference_keys_shapes_and_dtypes(case):
    cfg = reduced_case(case)
    jp = jax.eval_shape(lambda: ref_lm.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    tp = port_lm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ref_shapes = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
                  for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    port_shapes = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for p, t in _tree.flatten_with_path(tp)[0]}
    assert port_shapes == ref_shapes
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    assert port_shapes["['blocks']['mlp']['w_up']"] == ((L, d, f), "bfloat16")
    assert port_shapes["['blocks']['mlp']['w_down']"] == ((L, f, d),
                                                          "bfloat16")
    assert ("['blocks']['mlp']['w_gate']" in port_shapes) == (
        cfg.mlp_type != "mlp")
    assert ("['frontend_proj']" in port_shapes) == (cfg.frontend == "vision")
    if cfg.frontend == "vision":
        assert port_shapes["['frontend_proj']"] == ((d, d), "bfloat16")
        # dense_init: std 1/sqrt(d)
        std = float(tp["frontend_proj"].float().std())
        assert std == pytest.approx(d ** -0.5, rel=0.1)


@pytest.mark.parametrize("case", NEW_CASES)
def test_params_convert_bit_for_bit(case):
    """``frontend_proj`` and the two-leaf MLP among every leaf."""
    jp = jax.device_get(ref_lm.init_params(reduced_case(case),
                                           jax.random.PRNGKey(3)))
    tp = params_from_numpy(jp, device="cpu")
    paths = set()
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
        paths.add(jax.tree_util.keystr(path))
    assert "['blocks']['mlp']['w_up']" in paths
    assert ("['frontend_proj']" in paths) == (case == "phi3v")


@pytest.mark.parametrize("case", NEW_CASES + ("nemotron-g12",))
def test_reduced_caches_match_reference_shapes(case):
    cfg = reduced_case(case)
    tc = port_lm.init_cache(cfg, 2, 16, device="cpu")
    jc = jax.eval_shape(lambda: ref_lm.init_cache(cfg, 2, 16))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tc.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}


# ------------------------------------------------------------ registry
def test_archs_and_aliases_equal_the_reference():
    assert sorted(port_configs.ARCHS) == sorted(ref_configs.ARCHS)
    for name, cfg in ref_configs.ARCHS.items():
        assert dataclasses.asdict(port_configs.ARCHS[name]) == \
            dataclasses.asdict(cfg)
    assert port_configs.ALIASES == ref_configs.ALIASES
    assert port_configs.list_archs() == ref_configs.list_archs()


@pytest.mark.parametrize("alias", ["musicgen", "phi3v", "nemotron",
                                   "musicgen-large", "phi-3-vision-4.2b",
                                   "nemotron-4-340b"])
def test_get_config_resolves_the_new_aliases(alias):
    cfg = port_configs.get_config(alias)
    assert cfg.name == get_config(alias).name
    assert cfg.n_params() == get_config(alias).n_params()
    with pytest.raises(KeyError):
        port_configs.get_config(alias + "-x")


# ------------------------------------------------------------------ init
def test_init_draws_a_matrix_of_many_rows_in_runs_of_rows(monkeypatch):
    """Above ONE_DRAW_MAX elements, a 2-D slab is filled in runs of as many
    rows as SLAB_MAX holds, each run its own draw from the same generator
    (nemotron-4-340b's 256000 x 18432 embedding: 18 draws, not 256,000);
    slabs of more dimensions are still filled one leading slab at a time
    (``test_torch_moe.py::test_init_draws_large_leaves_slab_by_slab``)."""
    from repro_torch.models import common as port_common
    monkeypatch.setattr(port_common, "ONE_DRAW_MAX", 50)
    monkeypatch.setattr(port_common, "SLAB_MAX", 30)
    got = port_common._normal(torch.Generator().manual_seed(4), (10, 7),
                              torch.bfloat16, 0.5)
    g = torch.Generator().manual_seed(4)
    want = torch.cat([(torch.randn((n, 7), generator=g) * 0.5)
                      .to(torch.bfloat16) for n in (4, 4, 2)])
    assert torch.equal(got, want)
    stacked = port_common._normal(torch.Generator().manual_seed(4),
                                  (2, 10, 7), torch.bfloat16, 0.5)
    g = torch.Generator().manual_seed(4)
    want = torch.stack([torch.cat([(torch.randn((n, 7), generator=g) * 0.5)
                                   .to(torch.bfloat16) for n in (4, 4, 2)])
                        for _ in range(2)])
    assert torch.equal(stacked, want)


# --------------------------------------------------- five training steps
@pytest.mark.parametrize("case", NEW_CASES)
def test_five_adamw_steps_follow_the_reference(case):
    """From the same reduced fp32 parameters, both packages take five
    AdamW steps at lr 3e-4 on the same five batches of the train loop's
    synthetic stream: their losses agree step by step within 1e-5
    relative (fp32 summation order), so the port's training of the plain
    MLP and of phi-3-vision's tree (its frontend_proj takes a zero
    gradient and its weight decay, as under jax.grad) follows the
    reference's."""
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import init_opt_state as ref_init_opt_state
    from repro.train.step import build_train_step as ref_build_train_step
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import build_train_step
    cfg = reduced_case(case)
    lr = 3e-4
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    js = ref_init_opt_state(jp, RefAdamWConfig(lr=lr))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    ts = params_from_numpy(jax.device_get(js), device="cpu")
    ref_step = jax.jit(ref_build_train_step(cfg, RefAdamWConfig(lr=lr),
                                            lr=lr))
    port_step = build_train_step(cfg, AdamWConfig(lr=lr), lr=lr)
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 24, 4, seed=3),
                                  device="cpu")
    ref_losses, port_losses = [], []
    for step in range(5):
        batch = data.batch_at(step)
        toks = jnp.asarray(batch["tokens"].numpy(), jnp.int32)
        jp, js, jm = ref_step(jp, js, {"tokens": toks, "labels": toks})
        tp, ts, tm = port_step(tp, ts, batch)
        ref_losses.append(float(jm["loss"]))
        port_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-5, atol=0)
    if cfg.frontend == "vision":
        np.testing.assert_allclose(as_np(tp["frontend_proj"]),
                                   as_np(jp["frontend_proj"]),
                                   rtol=0, atol=1e-6)
