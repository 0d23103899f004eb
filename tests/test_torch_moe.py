"""The port's MoE family against the reference, on the CPU at the reduced
size: ``moe_forward`` and its aux loss (with dropped tokens, and over 8192
positions, which takes the 4096-token chunked path), every gradient
against ``jax.grad``, the one-token ``moe_decode`` against the reference's
``moe_forward`` at S = 1, the expert route's plain version against a dense
einsum, ``layer_norm``, the parameter trees of moonshot-v1-16b-a3b and
dbrx-132b, the runtime's leaf spans, the kernel entry points of a decode
step, the routing margins at the tests' seeds, and the init's slab draws.
The models' logits, losses, gradients, decode and greedy tokens are held
in ``test_torch_train.py`` and ``test_torch_serve.py`` (their cases
``moonshot``, ``dbrx`` and ``dbrx-g6`` of ``_torch_models.MODEL_CASES``).

Inputs are drawn with numpy and handed to both packages.  Tolerances:
- fp32 1e-5 absolute and relative (``MODEL_TOL``: summation order over at
  most a few hundred terms); over 8192 positions the gradients 2e-4
  (``LONG_TOL``): the router's gradient sums 8192 signed terms a chunk,
  and there both packages' fp32 values lie up to 1.4e-4 (relative) from
  the same gradient in float64, 7.4e-5 from each other;
- bf16 2e-2 (the reference's kernel tolerance) relative to the size of
  the terms an output element sums, the routed experts' and the shared
  experts' (:func:`_assert_bf16_close`): each package rounds the
  products and the activation to bf16 at its own places (``jax.nn.silu``
  and ``F.silu`` differ by an ulp), so the shared term alone lies up to a
  few of its ulps apart (1.516 against 1.484), and where the routed term
  cancels it the output does too (0.0 against 0.031).
Routing: the experts each token picks must be the same in both packages,
and at the seeds used every token's k-th and (k+1)-th router
probabilities lie more than ``MARGIN`` apart, far above the ~4e-7 by which
the two packages' router probabilities differ, so a near-tie that could
flip the choice fails loudly here rather than as a stray mismatch (over
8192 positions, and at the model tests' inputs, see :func:`_margin` and
``MODEL_MARGIN``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tiered_matmul as mm  # noqa: E402
from repro_torch.models import common as port_common  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from _torch_models import reduced_case  # noqa: E402

MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
LONG_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MARGIN = 1e-4
# the least gap at the model tests' inputs: dbrx's reduced config routes
# one token with a gap of 5.2e-5 there, still ~100 times the packages'
# distance in router probabilities
MODEL_MARGIN = 1e-5
MOE_CASES = ("moonshot", "dbrx", "dbrx-g6")


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer(case, dtype=jnp.float32, seed=0, **changes):
    """(cfg, reference MoE params of one layer, the same in the port)."""
    cfg = dataclasses.replace(reduced_case(case), **changes)
    jp = ref_moe.init_moe_params(jax.random.PRNGKey(seed), cfg, dtype)
    return cfg, jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _both(a, jdtype=jnp.float32, tdtype=torch.float32):
    return jnp.asarray(a, jdtype), torch.from_numpy(a).to(tdtype)


def _assert_same_routing(cfg, jp, tp, jx, tx, margin=MARGIN):
    """Both packages pick the same experts, every token's k-th and
    (k+1)-th probabilities more than ``margin`` apart.  ``margin=None``:
    twice the largest distance between the two packages' probabilities,
    the least gap at which neither package's rounding can swap the k-th
    and the (k+1)-th expert."""
    jprobs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, cfg.moe_top_k)
    probs, _, idx = port_moe._route(tp, tx, cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if margin is None:
        margin = 2 * float(np.abs(probs.numpy() - np.asarray(jprobs)).max())
    top = torch.sort(probs, dim=-1, descending=True).values
    gap = top[..., cfg.moe_top_k - 1] - top[..., cfg.moe_top_k]
    assert float(gap.min()) > margin


def _assert_bf16_close(cfg, jp, jx, out, jout):
    """bf16 outputs within 2e-2 (1 + |output| + |shared term|), the shared
    term the reference's (0 without shared experts: then this is the
    reference's rtol = atol = 2e-2)."""
    scale = 1 + np.abs(as_np(jout))
    if cfg.moe_shared_experts:
        act = jax.nn.silu if cfg.activation == "silu" else jax.nn.gelu
        shared = (act(jx @ jp["shared_gate"])
                  * (jx @ jp["shared_up"])) @ jp["shared_down"]
        scale = scale + np.abs(as_np(shared))
    err = np.abs(as_np(out) - as_np(jout))
    assert (err <= 2e-2 * scale).all(), float((err / scale).max())


def _dropped(cfg, tp, tx):
    """Pairs past capacity in the port's dispatch of tx (B, S, d)."""
    B, S, _ = tx.shape
    _, _, idx = port_moe._route(tp, tx, cfg)
    pair_slot, _ = port_moe.dispatch_maps(
        idx.reshape(B, -1), cfg.moe_experts, port_moe._capacity(S, cfg))
    return int((pair_slot == cfg.moe_experts
                * port_moe._capacity(S, cfg)).sum())


# (case, B, S, changes): the reduced layer as it is; with capacity factor
# 0.5 (C 16 for 64 tokens of 2 choices over 4 experts: pairs are dropped);
# and 8192 positions, two chunks of 4096 dispatched one after the other
FORWARD_CASES = [("moonshot", 2, 24, {}), ("dbrx", 2, 24, {}),
                 ("moonshot", 2, 64, {"moe_capacity_factor": 0.5}),
                 ("dbrx", 1, 64, {"moe_capacity_factor": 0.5}),
                 ("moonshot", 1, 8192, {})]
FORWARD_SEEDS = {"moonshot": 3, "dbrx": 4}


def _margin(S):
    """MARGIN, but over 8192 positions (16,384 routings of 4 experts) a few
    gaps fall below 1e-4 at any seed (3 to 5 at seeds 3, 5, 7, the least
    2.3e-6 to 8.4e-6), so there the routing is held to the least gap that
    rounding cannot cross (:func:`_assert_same_routing`)."""
    return None if S > port_moe.CHUNK else MARGIN


@pytest.mark.parametrize("case,B,S,changes", FORWARD_CASES)
def test_moe_forward_and_aux_match_reference(case, B, S, changes):
    cfg, jp, tp = _layer(case, **changes)
    jx, tx = _both(_x((B, S, cfg.d_model), FORWARD_SEEDS[case]))
    _assert_same_routing(cfg, jp, tp, jx, tx, _margin(S))
    dropped = _dropped(cfg, tp, tx)
    if changes:
        assert dropped > 0
    jout, jaux = ref_moe.moe_forward(jp, jx, cfg)
    out, aux = port_moe.moe_forward(tp, tx, cfg)
    np.testing.assert_allclose(as_np(out), as_np(jout), **MODEL_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("case,B,S,changes", FORWARD_CASES[:4])
def test_moe_forward_matches_reference_in_bf16(case, B, S, changes):
    cfg, jp, tp = _layer(case, jnp.bfloat16, **changes)
    xa = _x((B, S, cfg.d_model), FORWARD_SEEDS[case])
    jx, tx = _both(xa, jnp.bfloat16, torch.bfloat16)
    _assert_same_routing(cfg, jp, tp, jx, tx)
    jout, jaux = ref_moe.moe_forward(jp, jx, cfg)
    out, aux = port_moe.moe_forward(tp, tx, cfg)
    assert out.dtype == torch.bfloat16
    _assert_bf16_close(cfg, jp, jx, out, jout)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("case,B,S,changes", FORWARD_CASES)
def test_moe_gradients_match_jax_grad(case, B, S, changes):
    """d/d(params, x) of <out, cot> + aux, every leaf."""
    cfg, jp, tp = _layer(case, **changes)
    xa = _x((B, S, cfg.d_model), FORWARD_SEEDS[case])
    cot = _x((B, S, cfg.d_model), 11)

    def ref_loss(p, x):
        out, aux = ref_moe.moe_forward(p, x, cfg)
        return jnp.sum(out * cot) + aux

    jgp, jgx = jax.grad(ref_loss, argnums=(0, 1))(jp, jnp.asarray(xa))
    leaves, treedef = _tree.flatten(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    tx = torch.from_numpy(xa).requires_grad_()
    out, aux = port_moe.moe_forward(_tree.unflatten(treedef, live), tx, cfg)
    loss = (out * torch.from_numpy(cot)).sum() + aux
    grads = torch.autograd.grad(loss, live + [tx])
    tol = MODEL_TOL if S <= port_moe.CHUNK else LONG_TOL
    np.testing.assert_allclose(as_np(grads[-1]), as_np(jgx), **tol)
    want = {jax.tree_util.keystr(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(jgp)[0]}
    got = {p: g for (p, _), g in zip(_tree.flatten_with_path(tp)[0], grads)}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(as_np(g), as_np(want[path]), **tol,
                                   err_msg=path)


def test_dispatch_maps_are_inverse_and_follow_the_reference_rank():
    """pair -> slot and slot -> pair invert each other; positions are the
    rank among a row's pairs of the same expert in pair order; pairs past
    C are dropped and empty slots name no pair."""
    rng = np.random.default_rng(0)
    B, P, E, C = 3, 40, 5, 6
    flat = torch.from_numpy(rng.integers(0, E, (B, P)))
    pair_slot, slot_pair = port_moe.dispatch_maps(flat, E, C)
    for b in range(B):
        seen = {}
        for p in range(P):
            e = int(flat[b, p])
            pos = seen.get(e, 0)
            seen[e] = pos + 1
            want = e * C + pos if pos < C else E * C
            assert int(pair_slot[b, p]) == want
            if pos < C:
                assert int(slot_pair[b, want]) == p
        for s in range(E * C):
            e, c = divmod(s, C)
            if c >= seen.get(e, 0):
                assert int(slot_pair[b, s]) == P


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_matches_reference_moe_forward_at_one_token(case, dtype):
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    cfg, jp, tp = _layer(case, jd)
    xa = _x((6, cfg.d_model), 5)
    jx, tx = _both(xa, jd, td)
    _assert_same_routing(cfg, jp, tp, jx, tx)
    jout, _ = ref_moe.moe_forward(jp, jx[:, None, :], cfg)
    ops.reset_launch_counts()
    out = port_moe.moe_decode(tp, tx, cfg)
    assert out.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(as_np(out), as_np(jout[:, 0]),
                                   **MODEL_TOL)
    else:
        _assert_bf16_close(cfg, jp, jx, out, jout[:, 0])
    assert set(ops.launch_counts().values()) == {0}      # CPU: no kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,E,K,N", [(12, 4, 64, 32), (13, 8, 100, 264),
                                     (20, 3, 32, 8), (1, 5, 7, 3)])
def test_tiered_matmul_experts_plain_matches_dense_einsum(dtype, R, E, K, N):
    rng = np.random.default_rng(R)
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32))
    # experts E - 1 left unpicked where E > 3; every row on one where E = 3
    ex = rng.integers(0, max(1, E - 1), R) if E != 3 else np.full(R, 2)
    expert = torch.from_numpy(ex.astype(np.int32))
    x, w = x.to(dtype), w.to(dtype)
    want = torch.einsum("rk,rkn->rn", x.double(), w[expert.long()].double())
    for fn in (mm.tiered_matmul_experts_plain, ops.tiered_matmul_experts):
        got = fn(x, w, expert)
        assert got.dtype == dtype and got.shape == (R, N)
        tol = MODEL_TOL if dtype == torch.float32 else BF16_TOL
        np.testing.assert_allclose(as_np(got), want.numpy(), **tol)


def test_tiered_matmul_experts_refuses_what_the_kernel_does_not_take():
    x, w = torch.zeros((4, 8)), torch.zeros((3, 8, 16))
    ex = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.tiered_matmul_experts(x, torch.zeros((3, 9, 16)), ex)
    with pytest.raises(ValueError):
        ops.tiered_matmul_experts(x, w, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.tiered_matmul_experts(x, w, ex.long())
    with pytest.raises(TypeError):
        ops.tiered_matmul_experts(x.double(), w.double(), ex)
    with pytest.raises(ValueError):
        ops.tiered_matmul_experts(x, w[0], ex)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    xa = _x((3, 5, 64), 7) * 3 + 1
    scale, bias = _x((64,), 8), _x((64,), 9)
    jx, tx = _both(xa, jd, td)
    want = ref_common.layer_norm(jx, jnp.asarray(scale, jd),
                                 jnp.asarray(bias, jd))
    got = port_common.layer_norm(tx, torch.from_numpy(scale).to(td),
                                 torch.from_numpy(bias).to(td))
    assert got.dtype == td
    tol = MODEL_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


# ------------------------------------------------------- parameter trees
def _ref_params(cfg, seed=0, dtype=jnp.bfloat16):
    return ref_lm.init_params(cfg, jax.random.PRNGKey(seed), dtype=dtype)


@pytest.mark.parametrize("case", MOE_CASES)
def test_port_init_params_has_the_reference_keys_and_shapes(case):
    cfg = reduced_case(case)
    jp = jax.eval_shape(lambda: _ref_params(cfg))
    tp = port_lm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ref_shapes = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
                  for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    port_shapes = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for p, t in _tree.flatten_with_path(tp)[0]}
    assert port_shapes == ref_shapes
    blocks = port_shapes
    L, d, E = cfg.n_layers, cfg.d_model, cfg.moe_experts
    f = cfg.moe_d_ff
    assert blocks["['blocks']['moe']['router']"] == ((L, d, E), "float32")
    assert blocks["['blocks']['moe']['w_gate']"] == ((L, E, d, f), "bfloat16")
    assert blocks["['blocks']['moe']['w_down']"] == ((L, E, f, d), "bfloat16")
    assert ("['blocks']['moe']['shared_gate']" in blocks) == (
        cfg.moe_shared_experts > 0)
    assert ("['final_ln_bias']" in blocks) == (cfg.norm == "layer")
    if cfg.norm == "layer":
        assert float(tp["final_ln_scale"].float().min()) == 1.0
        assert not tp["blocks"]["ln1_bias"].any()


@pytest.mark.parametrize("case", MOE_CASES)
def test_params_convert_bit_for_bit(case):
    jp = jax.device_get(_ref_params(reduced_case(case), seed=3))
    tp = params_from_numpy(jp, device="cpu")
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(a)
        fp32 = a.dtype == np.float32        # the router; the rest bf16
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16)
        got = t.view(torch.int32 if fp32 else torch.int16).numpy()
        np.testing.assert_array_equal(got, a.view(np.int32 if fp32
                                                  else np.int16))


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_runtime_leaf_spans_match_reference(case, moments):
    cfg = reduced_case(case)
    jp = _ref_params(cfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
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
    assert any("['moe']['router']" in s[0] for s in spans[1][2])


# ----------------------------------------------------- decode, end to end
@pytest.mark.parametrize("case", MOE_CASES)
def test_decode_goes_through_the_kernel_entry_points(case, monkeypatch):
    """Per layer and step: one decode_attention, 4 attention products and
    3 shared-expert products through tiered_matmul (dbrx has no shared
    expert), the 3 routed products through tiered_matmul_experts."""
    cfg = reduced_case(case)
    tp = params_from_numpy(jax.device_get(_ref_params(cfg, dtype=jnp.float32)),
                           device="cpu")
    names = ("decode_attention", "tiered_matmul", "tiered_matmul_experts")
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(ops, name, spy)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 3)))
    ServeEngine(cfg, tp, max_seq=16, batch=2, device="cpu").generate(
        prompts, 2)
    steps, L = 3 + 2, cfg.n_layers
    shared = 3 if cfg.moe_shared_experts else 0
    assert calls == {"decode_attention": L * steps,
                     "tiered_matmul": (4 + shared) * L * steps,
                     "tiered_matmul_experts": 3 * L * steps}


def _routing_gaps(case, monkeypatch, run):
    """The smallest k-th to (k+1)-th probability gap of every routing the
    port makes while ``run(cfg, tp)`` runs."""
    cfg = reduced_case(case)
    tp = params_from_numpy(jax.device_get(_ref_params(cfg, dtype=jnp.float32)),
                           device="cpu")
    gaps = []
    real = port_moe._route

    def spy(params, x, cfg_):
        probs, gates, idx = real(params, x, cfg_)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg_.moe_top_k
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return probs, gates, idx
    monkeypatch.setattr(port_moe, "_route", spy)
    run(cfg, tp)
    return gaps


@pytest.mark.parametrize("case", MOE_CASES)
def test_routing_margins_at_the_model_tests_inputs(case, monkeypatch):
    """The model tests (test_torch_train.py, test_torch_serve.py) hold the
    port's logits within 1e-5 of the reference's; with every routing's
    k-th and (k+1)-th probabilities more than MODEL_MARGIN apart at their
    inputs, both packages routed every token to the same experts."""
    def run(cfg, tp):
        toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
        port_lm.forward(tp, cfg, torch.from_numpy(toks))
        cache = port_lm.init_cache(cfg, 2, 16, device="cpu")
        steps = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6))
        for i in range(6):
            port_lm.decode_step(tp, cfg, cache, torch.from_numpy(steps[:, i]),
                                i)
        for r in range(3):
            prompts = np.random.default_rng(10 + r).integers(
                0, cfg.vocab_size, (2, 5))
            ServeEngine(cfg, tp, max_seq=16, batch=2, device="cpu").generate(
                torch.from_numpy(prompts), 4)
    gaps = _routing_gaps(case, monkeypatch, run)
    assert len(gaps) > 50 and min(gaps) > MODEL_MARGIN


# ------------------------------------------------------------------ init
def test_init_draws_large_leaves_slab_by_slab(monkeypatch):
    """Above ONE_DRAW_MAX elements a leaf is allocated in its dtype and
    filled one leading slab at a time (recursively down to SLAB_MAX), each
    slab its own draw from the same generator; at or below it, one draw,
    as before (so the dense, hybrid and xlstm configs keep their numbers)."""
    shape, std = (3, 4, 5, 6), 0.5
    one = port_common._normal(torch.Generator().manual_seed(1), shape,
                              torch.bfloat16, std)
    g = torch.Generator().manual_seed(1)
    assert torch.equal(one, (torch.randn(shape, generator=g) * std)
                       .to(torch.bfloat16))
    monkeypatch.setattr(port_common, "ONE_DRAW_MAX", 100)
    monkeypatch.setattr(port_common, "SLAB_MAX", 30)
    slabs = port_common._normal(torch.Generator().manual_seed(1), shape,
                                torch.bfloat16, std)
    g = torch.Generator().manual_seed(1)
    want = torch.stack([torch.stack([(torch.randn((5, 6), generator=g)
                                      * std).to(torch.bfloat16)
                                     for _ in range(4)]) for _ in range(3)])
    assert slabs.dtype == torch.bfloat16 and torch.equal(slabs, want)
    assert not torch.equal(slabs, one)
    big = port_common.dense_init(torch.Generator().manual_seed(2),
                                 (4, 50, 40), torch.bfloat16)
    assert abs(float(big.float().std()) - 1 / 50 ** 0.5) < 0.01
