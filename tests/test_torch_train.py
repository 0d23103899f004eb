"""The port's training path against the reference, on the CPU at the
reduced size: flash attention and its gradient, ``attn_forward``,
``lm.forward`` / ``loss_fn`` and every parameter's gradient, AdamW with
fp32, bf16 and int8 moments, microbatching, checkpoints in both
directions, the data pipeline and the runtime's registration.

Inputs are drawn with numpy and handed to both packages; the reference's
parameters and optimizer state are carried across with
``repro_torch.convert``.  The reference runs as its own tests run it: the
Pallas kernel in interpret mode, or the pure-JAX code.  On CPU tensors the
port's wrappers run their plain versions; the CUDA kernels are held
against those on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances, each with its reason:
- flash attention forward and gradient: the reference's kernel
  tolerances (``tests/test_kernels.py``), fp32 2e-5 and bf16 2e-2; both
  sides compute in fp32 and differ in summation order only (observed
  about 1e-6 in fp32).
- model logits, loss and gradients with fp32 parameters: 1e-5 absolute
  and relative -- fp32 summation order over at most a few hundred terms
  (observed below 1e-6).
- AdamW: 1e-5 relative on fp32 state: the global norm sums the squares
  of every gradient in another order (observed 1.4e-6 relative over 29k
  elements), and the clip factor carries that into every moment; bf16
  moments may land one bf16 ulp apart where the fp32 value sits on a
  rounding boundary (rtol 2**-7); an int8 moment may round one step apart
  at a .5 tie (atol = one quantization step); an element whose moment
  rounded apart takes another update, so with quantized moments the
  master copy is held to steps x lr everywhere and to the fp32 tolerance
  on 99 % of its elements.
- a training step's parameters: 2 * lr absolute -- Adam's first update is
  +-lr per element, so a gradient that differs in its last bits near zero
  may flip an element's sign.
"""

import importlib
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.checkpoint import CheckpointManager as RefCkpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models.common import rope_frequencies as ref_rope  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402
from repro.train.step import build_train_step as ref_build_train_step  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models.common import rope_frequencies  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update,  # noqa: E402
                               init_opt_state, opt_state_bytes)
from repro_torch.train.step import (auto_microbatches,  # noqa: E402
                                    build_grads_step, build_train_step)
from repro.train import step as ref_step  # noqa: E402
from _torch_models import (MODEL_CASES, random_biases,  # noqa: E402
                           reduced_case)

port_fa = importlib.import_module("repro_torch.kernels.flash_attention")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(a: np.ndarray, name: str):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def draws(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def leaf_paths(tree):
    return {p: leaf for p, leaf in _tree.flatten_with_path(tree)[0]}


def jax_leaf_paths(tree):
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


models = pytest.mark.parametrize("gemma", sorted(MODEL_CASES), indirect=True)


@pytest.fixture(scope="module")
def gemma(request):
    """Reduced gemma-2b with the reference's fp32 parameters on both
    sides, and one batch of tokens; or another case of
    ``tests/_torch_models.MODEL_CASES`` where a test parametrizes it
    (``@models``): yi-6b and chatglm3-6b reduced and at their real G,
    chatglm3-6b's qkv biases drawn at random."""
    cfg = reduced_case(getattr(request, "param", "gemma-2b"))
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = random_biases(cfg, jp)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    return cfg, jp, tp, toks


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,S,T,D", [
    (1, 1, 1, 128, 128, 128),
    (2, 2, 2, 256, 256, 128),
    (1, 2, 4, 128, 384, 128),     # GQA, T > S
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_kernel(B, K, G, S, T, D, dtype, causal):
    qa, ka, va = draws(0, (B, K, G, S, D), (B, K, T, D), (B, K, T, D))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (qa, ka, va))
    gold = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                   force_pallas=True, interpret=True)
    out, lse = port_fa.flash_attention_plain(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and lse.shape == (B, K, G, S)
    np.testing.assert_allclose(as_np(out), as_np(gold), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,causal", [(128, 300, False), (100, 100, True),
                                        (100, 37, True), (37, 200, False)])
def test_flash_masks_keys_past_the_end_r1(S, T, causal, dtype):
    """At T % 128 != 0 the Pallas wrapper zero-pads K/V and, without the
    causal mask, lets the padded keys into the softmax (ROADMAP R1); the
    port masks them, so it is held against the oracle."""
    B, K, G, D = 1, 2, 4, 64
    qa, ka, va = draws(1, (B, K, G, S, D), (B, K, T, D), (B, K, T, D))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (qa, ka, va))
    gold = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(as_np(out), as_np(gold), **tol(dtype))
    np.testing.assert_allclose(
        as_np(ref.flash_attention_ref(tq, tk, tv, causal=causal)),
        as_np(gold), **tol(dtype))
    if not causal:
        padded = ref_ops.flash_attention(jq, jk, jv, causal=False,
                                         force_pallas=True, interpret=True)
        assert np.abs(as_np(padded) - as_np(gold)).max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,S,T,D,causal", [
    (1, 2, 4, 24, 40, 16, True), (2, 1, 3, 20, 20, 8, True),
    (1, 2, 2, 18, 30, 16, False)])
def test_flash_gradient_matches_jax_grad(B, K, G, S, T, D, causal, dtype):
    """The autograd entry on CPU tensors: plain forward, then the
    backward's plain version (recomputed from the saved log-sum-exp),
    against jax.grad of the reference oracle."""
    qa, ka, va, ga = draws(2, (B, K, G, S, D), (B, K, T, D), (B, K, T, D),
                           (B, K, G, S, D))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (both(a, dtype)
                                              for a in (qa, ka, va, ga))

    def f(q, k, v):
        out = ref_ref.flash_attention_ref(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    gold = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, tg)
    for g, want in zip(grads, gold):
        assert g.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(as_np(g), as_np(want), **tol(dtype))
    assert ops.launch_counts()["flash_attention_bwd"] == 0   # CPU: no kernel


# The cases the card's checks add for the tensor-core kernels, at reduced
# size: q scaled by 8 ("peaked": the running max moves between key tiles,
# so a missing rescale shows), S and T not multiples of any tile, S != T,
# and G = 1 over many KV heads (zamba2's shared attention).
def _peaked(seed, B, K, G, S, T, D, peak):
    qa, = draws(seed, (B, K, G, S, D), scale=peak)
    ka, va, ga = draws(seed + 1, (B, K, T, D), (B, K, T, D), (B, K, G, S, D))
    return qa, ka, va, ga


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,S,T,D,peak", [
    (1, 1, 8, 128, 128, 64, 8.0),     # peaked, G = 8
    (1, 4, 1, 128, 256, 64, 8.0),     # peaked, G = 1, S != T
    (1, 1, 2, 128, 384, 32, 1.0),     # S != T
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_kernel_on_peaked_inputs(
        B, K, G, S, T, D, peak, dtype, causal):
    """T a multiple of 128: the Pallas kernel in interpret mode."""
    qa, ka, va, _ = _peaked(10, B, K, G, S, T, D, peak)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (qa, ka, va))
    gold = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                   force_pallas=True, interpret=True)
    out, _ = port_fa.flash_attention_plain(tq, tk, tv, causal)
    np.testing.assert_allclose(as_np(out), as_np(gold), **tol(dtype))


RAGGED = [(1, 1, 8, 75, 75, 32, 1.0, True),      # S, T multiples of no tile
          (1, 1, 8, 75, 75, 32, 8.0, True),      # ... and peaked
          (1, 3, 1, 50, 90, 16, 8.0, True),      # G = 1, S != T, peaked
          (2, 1, 4, 40, 120, 16, 8.0, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,S,T,D,peak,causal", RAGGED)
def test_flash_ragged_and_peaked_match_the_oracle(B, K, G, S, T, D, peak,
                                                  causal, dtype):
    """T % 128 != 0: the oracle, since the Pallas wrapper pads (R1)."""
    qa, ka, va, _ = _peaked(11, B, K, G, S, T, D, peak)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (qa, ka, va))
    gold = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal)
    out, lse = port_fa.flash_attention_plain(tq, tk, tv, causal)
    np.testing.assert_allclose(as_np(out), as_np(gold), **tol(dtype))
    assert np.isfinite(as_np(lse)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,S,T,D,peak,causal", RAGGED)
def test_flash_gradient_on_ragged_and_peaked_inputs_matches_jax_grad(
        B, K, G, S, T, D, peak, causal, dtype):
    """The forward and the backward's plain versions, through the autograd
    entry, against jax.grad of the oracle.  Tolerance: the dtype's, with
    atol scaled by the gradient's largest element, since scores scaled by
    8 make gradients of ~25 whose fp32 sums cancel to near 0 elsewhere
    (2e-5 of 25 is what two fp32 summation orders leave there)."""
    qa, ka, va, ga = _peaked(12, B, K, G, S, T, D, peak)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (both(a, dtype)
                                              for a in (qa, ka, va, ga))

    def f(q, k, v):
        out = ref_ref.flash_attention_ref(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    gold = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=causal)
    for g, want in zip(torch.autograd.grad(out, leaves, tg), gold):
        t = tol(dtype)
        scale = max(1.0, float(np.abs(as_np(want)).max()))
        np.testing.assert_allclose(as_np(g), as_np(want), rtol=t["rtol"],
                                   atol=t["atol"] * scale)


@pytest.mark.parametrize("shape,key_tile,want", [
    ((2, 1, 8, 2048, 2048), 64, 5),     # gemma-2b training, bf16: 64 tiles
    ((2, 1, 8, 2048, 2048), 32, 3),     # ... fp32: 128 tiles
    ((2, 32, 1, 4096, 4096), 64, 1),    # zamba2-1.2b, bf16: 4096 tiles
    ((1, 1, 1, 64, 1024), 64, 1),       # one row tile: nothing to split
    ((1, 1, 8, 4096, 64), 64, 8),       # one key tile: at most 8
    ((1, 1, 2, 100, 100), 64, 4),       # 4 row tiles of 64
])
def test_dkdv_split_fills_the_card_without_empty_blocks(shape, key_tile,
                                                        want):
    B, K, G, S, T = shape
    n = port_fa._dkdv_split(B, K, G, S, T, key_tile)
    assert n == want
    row_tiles = -(-S * G // 64)
    assert 1 <= n <= min(8, row_tiles)
    # every split of every key tile gets a share of the row tiles
    assert -(-row_tiles // n) * (n - 1) < row_tiles


def test_flash_bwd_plain_equals_autograd_through_the_plain_forward():
    qa, ka, va, ga = draws(3, (1, 1, 4, 33, 16), (1, 1, 33, 16),
                           (1, 1, 33, 16), (1, 1, 4, 33, 16))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qa, ka, va))
    out, lse = port_fa.flash_attention_plain(q, k, v, True)
    want = torch.autograd.grad(out, (q, k, v), torch.from_numpy(ga))
    got = port_fa.flash_attention_bwd_plain(q, k, v, out.detach(),
                                            torch.from_numpy(ga),
                                            lse.detach(), True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_flash_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 1, 2, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 2, 8, 16)),
                            torch.zeros((1, 2, 8, 16)))
    with pytest.raises(TypeError):
        ops.flash_attention(q, torch.zeros((1, 1, 8, 16)),
                            torch.zeros((1, 1, 8, 16), dtype=torch.float64))


# ------------------------------------------------------------------- model
def test_rope_tables_match_reference():
    """Same fp32 angles; torch's and XLA's cos/sin may round one ulp
    apart."""
    jc, js = ref_rope(16, 40, theta=10000.0, rotary_dim=16)
    tc, ts = rope_frequencies(16, 40, 10000.0, rotary_dim=16, device="cpu")
    np.testing.assert_allclose(as_np(tc), as_np(jc), rtol=0, atol=2e-7)
    np.testing.assert_allclose(as_np(ts), as_np(js), rtol=0, atol=2e-7)


@models
def test_attn_forward_matches_reference(gemma):
    cfg, jp, tp, _ = gemma
    (xa,) = draws(4, (2, 24, cfg.d_model))
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    tblk = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    hd = cfg.resolved_head_dim
    rd = int(hd * cfg.rotary_fraction)     # chatglm3-6b: half the head
    jc, js = ref_rope(hd, 24, theta=cfg.rope_theta, rotary_dim=rd)
    tc, ts = rope_frequencies(hd, 24, cfg.rope_theta, rotary_dim=rd,
                              device="cpu")
    gold = ref_attn.attn_forward(jblk, jnp.asarray(xa), jc, js, cfg)
    out = port_attn.attn_forward(tblk, torch.from_numpy(xa), tc, ts, cfg)
    np.testing.assert_allclose(as_np(out), as_np(gold), **MODEL_TOL)


@pytest.fixture(scope="module")
def gemma_ref(gemma):
    """The reference's logits, loss and gradients at the gemma fixture."""
    cfg, jp, _, toks = gemma
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32)}
    jlogits, _ = jax.jit(lambda p: ref_lm.forward(p, cfg, jb["tokens"]))(jp)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, cfg, jb), has_aux=True))(jp)
    return jlogits, jloss, jm, jgrads


@models
@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_every_gradient_match_reference(gemma, gemma_ref,
                                                         remat):
    cfg, _, tp, toks = gemma
    jlogits, jloss, jm, jgrads = gemma_ref
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    tlogits, aux = port_lm.forward(tp, cfg, tb["tokens"], remat=remat)
    np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), **MODEL_TOL)
    # the MoE layers' summed load-balancing loss; 0 without MoE
    assert float(aux) == pytest.approx(float(jm["aux"]), rel=1e-5, abs=0)

    leaves, treedef = _tree.flatten(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    tloss, tm = port_lm.loss_fn(_tree.unflatten(treedef, live), cfg, tb,
                                remat=remat)
    # phi3v's frontend_proj takes no part without frontend embeddings: a
    # zero gradient, as jax.grad gives it
    tgrads = torch.autograd.grad(tloss, live, materialize_grads=True)
    tloss = tloss.detach()
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(tm["nll"]) == pytest.approx(float(jm["nll"]), rel=1e-5)
    want = jax_leaf_paths(jgrads)
    got = {p: g for (p, _), g in zip(_tree.flatten_with_path(tp)[0], tgrads)}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(as_np(g), as_np(want[path]), **MODEL_TOL,
                                   err_msg=path)


def test_lm_refuses_other_patterns():
    """Every block pattern, MLP and frontend of the reference's configs
    builds: the three configs of the plain MLP and the frontends
    (musicgen-large, nemotron-4-340b, phi-3-vision-4.2b) give reduced
    parameters and caches with the reference's shapes on the CPU; a block
    pattern the reference does not know is refused, as the reference
    refuses it (``ValueError``)."""
    import dataclasses
    for arch in ("musicgen-large", "nemotron-4-340b", "phi-3-vision-4.2b"):
        cfg = get_config(arch).reduced()
        tp = port_lm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        assert ("frontend_proj" in tp) == (cfg.frontend == "vision")
        assert sorted(tp["blocks"]["mlp"]) == (
            ["w_down", "w_up"] if cfg.mlp_type == "mlp"
            else ["w_down", "w_gate", "w_up"])
        tc = port_lm.init_cache(cfg, 2, 8, device="cpu")
        jc = jax.eval_shape(lambda: ref_lm.init_cache(cfg, 2, 8))
        assert {k: tuple(v.shape) for k, v in tc.items()} == {
            k: tuple(v.shape) for k, v in jc.items()}
    other = dataclasses.replace(get_config("gemma-2b").reduced(),
                                block_pattern="conv")
    with pytest.raises(ValueError, match="conv"):
        ref_lm.init_params(other, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="conv"):
        port_lm.init_params(other, torch.Generator().manual_seed(0),
                            device="cpu")


# ------------------------------------------------------------------- AdamW
def _small_params(seed):
    """A tree with a scalar-free mix of shapes, bf16 as the model's."""
    a, b, c = draws(seed, (3, 40, 24), (300,), (24, 7), scale=0.5)
    return {"blocks": {"w": a, "b": b}, "head": c}


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_matches_reference(moments):
    ref_cfg = RefAdamWConfig(moments_dtype=moments, quant_block=64)
    port_cfg = AdamWConfig(moments_dtype=moments, quant_block=64)
    npp = _small_params(6)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), npp)
    js = ref_init_opt_state(jp, ref_cfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    ts = params_from_numpy(jax.device_get(js), device="cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for step in range(3):
        ng = _small_params(10 + step)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    ng)
        tg = params_from_numpy(jax.device_get(jg), device="cpu")
        jp, js, jm = ref_adamw_update(jg, jp, js, ref_cfg, jnp.float32(1e-2))
        tp2, ts2, tm = adamw_update(tg, tp, ts, port_cfg, 1e-2)
        assert tp2 is tp and ts2 is ts                      # in place
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert int(ts["step"]) == int(js["step"]) == step + 1
    want, got = jax_leaf_paths(js), leaf_paths(ts)
    assert sorted(want) == sorted(got)
    quantized = moments != "float32"
    for path, w in want.items():
        g = got[path]
        assert g.dtype == params_from_numpy(np.asarray(w), "cpu").dtype, path
        if "['q']" in path:     # int8 moment: one step apart at a .5 tie
            assert np.abs(g.numpy().astype(int)
                          - np.asarray(w).astype(int)).max() <= 1, path
        elif quantized and path.startswith(("['mu']", "['nu']")) \
                and "['s']" not in path:        # bf16: one ulp apart
            np.testing.assert_allclose(as_np(g), as_np(w), rtol=2 ** -7,
                                       atol=1e-30, err_msg=path)
        elif quantized and path.startswith("['master']"):
            _close_but_for_rounded_moments(as_np(g), as_np(w), 3 * 1e-2, path)
        else:
            np.testing.assert_allclose(as_np(g), as_np(w), rtol=1e-5,
                                       atol=1e-9, err_msg=path)
    for path, w in jax_leaf_paths(jp).items():
        np.testing.assert_allclose(as_np(leaf_paths(tp)[path]), as_np(w),
                                   rtol=2 ** -7, atol=0 if not quantized
                                   else 3 * 1e-2, err_msg=path)


def _close_but_for_rounded_moments(got, want, bound, path):
    """With bf16 or int8 moments, an element whose moment rounded one
    step apart takes a different update (each at most about lr): every
    element within ``bound`` (steps x lr), and 99 % of them within the fp32
    tolerance."""
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=path)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-9)
    assert close.mean() >= 0.99, (path, close.mean())


def test_opt_state_bytes_matches_reference():
    from repro.optim import opt_state_bytes as ref_bytes
    npp = _small_params(1)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = params_from_numpy(npp, device="cpu")
    for m in ("float32", "bfloat16", "int8"):
        for master in (True, False):
            assert opt_state_bytes(tp, AdamWConfig(
                moments_dtype=m, master_fp32=master)) == ref_bytes(
                jp, RefAdamWConfig(moments_dtype=m, master_fp32=master))


def test_cosine_schedule_matches_reference():
    from repro.optim import cosine_schedule as ref_sched
    from repro_torch.optim import cosine_schedule
    for s in (0, 5, 100, 2500, 9999, 20000):
        assert float(cosine_schedule(s, base_lr=3e-4)) == pytest.approx(
            float(ref_sched(s, base_lr=3e-4)), rel=1e-6)


# -------------------------------------------------------------- train step
def _batch(toks):
    t = torch.from_numpy(toks)
    return {"tokens": t, "labels": t}


def test_train_step_matches_reference(gemma):
    """One whole step of the slice: the same fp32 parameters, state and
    batch through both packages' train steps."""
    cfg, jp, tp, toks = gemma
    opt = AdamWConfig(lr=1e-3)
    js = ref_init_opt_state(jp, RefAdamWConfig(lr=1e-3))
    ts = params_from_numpy(jax.device_get(js), device="cpu")
    tp = params_from_numpy(jax.device_get(jp), device="cpu")   # a copy
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32)}
    jp2, _, jm = jax.jit(ref_build_train_step(
        cfg, RefAdamWConfig(lr=1e-3), lr=1e-3))(jp, js, jb)
    tp2, ts2, tm = build_train_step(cfg, opt, lr=1e-3)(tp, ts, _batch(toks))
    assert set(tm) == set(jm) == {"loss", "aux", "grad_norm", "step"}
    for k in ("loss", "grad_norm", "step", "aux"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7)
    want = jax_leaf_paths(jp2)
    for path, t in leaf_paths(tp2).items():
        np.testing.assert_allclose(as_np(t), as_np(want[path]), rtol=0,
                                   atol=2e-3, err_msg=path)


def test_microbatched_step_equals_full_batch(gemma):
    cfg, jp, _, toks = gemma
    toks = np.concatenate([toks, toks[:, ::-1]])            # batch 4
    out = []
    for mb in (1, 2):
        tp = params_from_numpy(jax.device_get(jp), device="cpu")
        ts = init_opt_state(tp, AdamWConfig(lr=1e-3))
        out.append(build_train_step(cfg, AdamWConfig(lr=1e-3),
                                    microbatches=mb, lr=1e-3)(
            tp, ts, _batch(np.ascontiguousarray(toks))))
    (p1, _, m1), (p2, _, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-4)
    for (path, a), b in zip(_tree.flatten_with_path(p1)[0], _tree.leaves(p2)):
        np.testing.assert_allclose(as_np(a), as_np(b), rtol=0, atol=2e-3,
                                   err_msg=path)


def test_auto_microbatches_matches_reference():
    """Pure arithmetic, copied: every reference config (MoE among them)
    and the port's own, over batches, sequence lengths, data- and
    tensor-parallel degrees and budgets.  Batches are powers of two: the
    reference never returns when the power of two its first loop reaches
    does not divide the batch (ROADMAP.md, queue 3, R5), and the port
    keeps that unchanged."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro_torch.configs import ARCHS as PORT_ARCHS
    seen = set()
    for name, cfg in REF_ARCHS.items():
        cfgs = [cfg] + ([PORT_ARCHS[name]] if name in PORT_ARCHS else [])
        for batch, seq in [(b, s) for b in (1, 2, 8, 64, 256)
                           for s in (128, 2048, 32768)]:
            for dp, tp in ((1, 1), (2, 1), (1, 4), (8, 2), (16, 16)):
                for budget in (2e9, 1e8):
                    want = ref_step.auto_microbatches(
                        cfg, batch, seq, dp, tp, act_budget_bytes=budget)
                    for c in cfgs:
                        assert auto_microbatches(
                            c, batch, seq, dp, tp,
                            act_budget_bytes=budget) == want
                    seen.add(want)
    assert len(seen) > 4          # the grid reaches many counts


def test_grads_step_accumulates_in_bf16(gemma):
    cfg, _, tp, toks = gemma
    toks = np.concatenate([toks, toks])
    g1, m1 = build_grads_step(cfg)(tp, _batch(toks))
    g2, m2 = build_grads_step(cfg, microbatches=2)(tp, _batch(toks))
    assert float(m1["nll"]) == pytest.approx(float(m2["nll"]), rel=1e-5)
    for a, b in zip(_tree.leaves(g1), _tree.leaves(g2)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(as_np(b), as_np(a), rtol=2e-2, atol=1e-3)


# -------------------------------------------------------------- checkpoints
def _state_numpy(seed):
    npp = _small_params(seed)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), npp)
    return {"params": jp, "opt": ref_init_opt_state(
        jp, RefAdamWConfig(moments_dtype="int8", quant_block=64))}


def _same_bits(port_tree, ref_tree):
    want, got = jax_leaf_paths(ref_tree), leaf_paths(port_tree)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert list(g.shape) == list(w.shape), path
        gb = (g.view(torch.int16) if g.dtype == torch.bfloat16 else g).numpy()
        assert gb.tobytes() == w.tobytes(), path


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    state = _state_numpy(7)
    state["opt"]["step"] = jnp.asarray(9, jnp.int32)
    RefCkpt(str(tmp_path)).save(3, state, blocking=True)
    step, restored = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 3
    _same_bits(restored, state)
    assert restored["params"]["head"].dtype == torch.bfloat16
    assert restored["opt"]["mu"]["head"]["q"].dtype == torch.int8


def test_port_checkpoint_restores_bit_for_bit_in_reference(tmp_path):
    state = params_from_numpy(jax.device_get(_state_numpy(8)), device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.list_steps() == [2, 3]
    meta = json.loads((tmp_path / "step_3" / "meta.json").read_text())
    assert meta["leaves"]["params/head"]["dtype"] == "bfloat16"
    step, restored = RefCkpt(str(tmp_path)).restore()
    assert step == 3
    _same_bits(state, restored)
    # leaves named by a device go there; the rest to ``device``
    step, placed = mgr.restore(device="cpu", shardings={
        "params": {"head": torch.device("cpu")},
        "opt": {"mu": torch.device("cpu")}})
    assert step == 3
    _same_bits(placed, restored)


# ---------------------------------------------------------------- pipeline
def _cpu_pipeline(cfg):
    return SyntheticTokenPipeline(cfg, device="cpu")    # the card by default


def test_pipeline_is_deterministic_and_follows_the_markov_rule():
    cfg = DataConfig(vocab_size=997, seq_len=64, global_batch=3, seed=11)
    a = _cpu_pipeline(cfg).batch_at(5)["tokens"].numpy()
    b = _cpu_pipeline(cfg).batch_at(5)["tokens"].numpy()
    c = _cpu_pipeline(cfg).batch_at(6)["tokens"].numpy()
    assert a.shape == (3, 64) and (a == b).all() and not (a == c).all()
    assert ((a[:, 1::2] == (a[:, 0::2] * 31 + 7) % 997)).all()
    assert a.min() >= 0 and a.max() < 997
    # the unigram permutation is the reference's (both draw it with numpy)
    ref_perm = importlib.import_module("repro.data.pipeline") \
        .SyntheticTokenPipeline(RefDataConfig(997, 64, 3, seed=11))._perm
    np.testing.assert_array_equal(_cpu_pipeline(cfg)._perm, ref_perm)
    # Zipf: the most frequent token of many draws is the permutation's first
    many = _cpu_pipeline(DataConfig(997, 256, 64, seed=11))
    even = many.batch_at(0)["tokens"].numpy()[:, 0::2]
    assert np.bincount(even.ravel()).argmax() == ref_perm[0]


# ---------------------------------------------------------------- runtime
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_runtime_leaf_spans_match_reference(gemma, moments):
    cfg, jp, tp, _ = gemma
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
    assert any(s[0] == "['step']" for s in spans[1][0])


def test_train_loop_on_cpu_plans_and_resumes(tmp_path):
    from repro_torch.train.loop import TrainConfig, train
    cfg = get_config("gemma-2b").reduced()
    common = dict(global_batch=2, seq_len=16, lr=1e-3, log_every=1000,
                  device="cpu")
    ops.reset_launch_counts()
    full = train(cfg, TrainConfig(steps=4, **common))
    assert all(np.isfinite(full.losses)) and len(full.grad_norms) == 4
    rt = full.runtime
    assert rt.phase_names() == ["data", "step", "ckpt"]
    assert rt.plan is not None
    assert {"opt_state"} <= {o for r in rt.plan.residents for o in r}
    assert rt.registry["params"].pinned          # never moved, as in the
    assert rt.stats()["n_moves"] == 1             # reference: one fetch
    assert set(ops.launch_counts().values()) == {0}      # CPU: no kernel
    first = train(cfg, TrainConfig(steps=2, checkpoint_dir=str(tmp_path),
                                   checkpoint_every=2, use_unimem=False,
                                   **common))
    resumed = train(cfg, TrainConfig(steps=4, checkpoint_dir=str(tmp_path),
                                     checkpoint_every=2, use_unimem=False,
                                     **common))
    # a restart from the wrong state or data would miss by far more
    assert first.losses == pytest.approx(full.losses[:2], rel=1e-6)
    assert resumed.losses == pytest.approx(full.losses[2:], rel=1e-6)


def test_launchers_and_train_config_default_to_the_card():
    from repro_torch.core import H100_HBM_HOST
    from repro_torch.launch.train import parse_args
    from repro_torch.train.loop import TrainConfig
    assert parse_args(["--arch", "gemma-2b"]).device == "cuda"
    assert TrainConfig().device == "cuda"
    assert TrainConfig().machine is H100_HBM_HOST
