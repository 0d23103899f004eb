"""The port's gemma-2b serving path against the reference, on the CPU at
the reduced size: the reference's parameters are carried across with
``repro_torch.convert`` and both packages decode the same prompts.

Tolerance of the logits: 1e-5 absolute with fp32 parameters.  Both sides
round the KV cache to bf16 the same way; what remains is fp32 summation
order (observed about 3e-7).
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def gemma():
    cfg = get_config("gemma-2b").reduced()
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    return cfg, jp, tp


def _prompts(cfg, batch, length, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, length))


def test_params_convert_bit_for_bit():
    cfg = get_config("gemma-2b").reduced()
    jp = jax.device_get(ref_lm.init_params(cfg, jax.random.PRNGKey(3)))
    tp = params_from_numpy(jp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    for (path, a) in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(a).view(np.int16))


def test_port_init_params_has_the_reference_keys_and_shapes():
    cfg = get_config("gemma-2b").reduced()
    jp = jax.eval_shape(lambda: ref_lm.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    tp = port_lm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ref_shapes = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
                  for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    from repro_torch import _tree
    port_shapes = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for p, t in _tree.flatten_with_path(tp)[0]}
    assert port_shapes == ref_shapes


def test_decode_step_logits_match_reference(gemma):
    cfg, jp, tp = gemma
    B, S, steps = 2, 16, 6
    toks = _prompts(cfg, B, steps)
    jc = ref_lm.init_cache(cfg, B, S)
    tc = port_lm.init_cache(cfg, B, S, device="cpu")
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, cfg, c, t, pos))
    for i in range(steps):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i], jnp.int32),
                      jnp.int32(i))
        tl = port_lm.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, i]),
                                 i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tc["k"].float().numpy(),
                                  np.asarray(jc["k"], np.float32))


def _serve_both(gemma, runtime_of=None, tenant=None, requests=1):
    cfg, jp, tp = gemma
    B, P, n_new, max_seq = 2, 5, 4, 16
    out = []
    for make, params, is_port in ((RefEngine, jp, False),
                                  (ServeEngine, tp, True)):
        rt = runtime_of(is_port) if runtime_of else None
        kw = dict(device="cpu") if is_port else {}
        eng = make(cfg, params, max_seq=max_seq, batch=B, runtime=rt,
                   tenant=tenant, **kw)
        toks = []
        for r in range(requests):
            prompts = _prompts(cfg, B, P, seed=10 + r)
            prompts = (torch.from_numpy(prompts) if is_port
                       else jnp.asarray(prompts, jnp.int32))
            toks.append(np.asarray(eng.generate(prompts, n_new)))
        out.append((toks, rt))
    return out


def test_greedy_tokens_match_reference(gemma):
    (ref_toks, _), (port_toks, _) = _serve_both(gemma)
    assert ref_toks[0].shape == (2, 9)
    np.testing.assert_array_equal(port_toks[0], ref_toks[0])


def test_serving_under_the_runtime_matches_reference(gemma):
    """ServeEngine(runtime=..., tenant=...): same tokens and the same
    placement program in both packages over three requests."""
    MB = 1024 ** 2

    def runtime_of(is_port):
        core = port_core if is_port else ref_core
        rt = core.UnimemRuntime(core.PAPER_DRAM_NVM, core.RuntimeConfig(
            backend="sim", fast_capacity_bytes=MB // 4))
        src = core.ManualSource()
        src.set("t0/prefill", elapsed=0.02,
                accesses={"t0/params": 4e4, "t0/kv_cache": 1e3},
                access_bins={"t0/kv_cache": [4, 2, 1, 1, 0, 0, 0, 0]})
        src.set("t0/decode", elapsed=0.01,
                accesses={"t0/params": 3e4, "t0/kv_cache": 2e3},
                access_bins={"t0/kv_cache": [1, 1, 1, 2, 4, 0, 0, 0]})
        rt.attach_source(src)
        return rt

    (ref_toks, ref_rt), (port_toks, port_rt) = _serve_both(
        gemma, runtime_of, tenant="t0", requests=3)
    for a, b in zip(ref_toks, port_toks):
        np.testing.assert_array_equal(b, a)
    assert port_rt.plan is not None
    plan = json.loads(port_rt.plan.to_json())
    assert port_rt.plan.to_json() == ref_rt.plan.to_json()
    assert port_rt.phase_names() == ["t0/prefill", "t0/decode"]
    assert any(m["obj"].startswith("t0/kv_cache") for m in plan["moves"])
    assert ({o.name: o.tier for o in port_rt.registry}
            == {o.name: o.tier for o in ref_rt.registry})


def test_model_goes_through_the_kernel_entry_points(gemma, monkeypatch):
    """Every block product and every attention goes through ``ops``: 7
    tiered_matmul and 1 decode_attention call per layer and step."""
    cfg, _, tp = gemma
    calls = {"decode_attention": 0, "tiered_matmul": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(ops, name, spy)
    eng = ServeEngine(cfg, tp, max_seq=16, batch=2, device="cpu")
    eng.generate(torch.from_numpy(_prompts(cfg, 2, 3)), 2)
    steps = 3 + 2
    assert calls == {"decode_attention": cfg.n_layers * steps,
                     "tiered_matmul": 7 * cfg.n_layers * steps}


def test_engine_entry_points_default_to_cuda():
    import inspect
    from repro_torch.serve.engine import ServeEngine as E
    for fn in (E.__init__, port_lm.init_params, port_lm.init_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
