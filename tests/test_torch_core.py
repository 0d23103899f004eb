"""The port's runtime (``repro_torch.core``) against the reference
(``repro.core``), run live in the same process on the same scripted loops:
plans, final tiers, move traces and stats must be identical, bit for bit.

The reference's pinned golden digests are not used: several do not
reproduce on every numpy/jax version (ROADMAP.md, queue 3, R3).
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.core import knapsack as ref_knapsack  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.core import knapsack as port_knapsack  # noqa: E402

MB = 1024 ** 2

#: object -> (size in MB, chunkable)
OBJECTS = {"weights": (24, False), "kv": (48, True), "acts": (16, False),
           "opt": (40, False)}
PHASES = ("fwd", "attn", "bwd", "update")


def _draw_script(seed: int, iters: int, names):
    """Per-iteration, per-phase (accesses, access_bins, elapsed), drawn
    with numpy; the access mix drifts at mid-run so replanning runs."""
    rng = np.random.default_rng(seed)
    touches = {"fwd": ["weights", "acts"], "attn": ["kv", "weights"],
               "bwd": ["weights", "acts", "kv"], "update": ["opt"]}
    script = []
    for it in range(iters):
        drift = 3.0 if it >= iters // 2 else 1.0
        per_phase = []
        for ph in PHASES:
            acc, bins = {}, {}
            for o in touches[ph]:
                scale = drift if (o == "opt" and it >= iters // 2) else 1.0
                acc[names[o]] = float(rng.integers(1, 50) * 1e4 * scale)
                if OBJECTS[o][1]:
                    bins[names[o]] = [float(x) for x in
                                      rng.dirichlet(np.ones(8) * 0.3)]
            per_phase.append((ph, acc, bins or None,
                              float(rng.uniform(0.01, 0.05))))
        script.append(per_phase)
    return script


def _run(core, mover: str, partition: bool, tenants: int, iters: int = 8):
    cfg = core.RuntimeConfig(
        backend="sim", mover=mover, enable_partitioning=partition,
        fast_capacity_bytes=64 * MB, seed=3,
        policy="bandwidth_partition" if tenants else "unimem")
    rt = core.UnimemRuntime(core.PAPER_DRAM_NVM, cfg)
    spaces = ([rt.tenant(f"t{i}", priority=1.0 + i, slo=1.0)
               for i in range(tenants)] if tenants else [rt])
    scripts = []
    for i, ns in enumerate(spaces):
        prefix = f"t{i}/" if tenants else ""
        names = {o: prefix + o for o in OBJECTS}
        for o, (mb, chunkable) in OBJECTS.items():
            ns.register(o, mb * MB // max(1, tenants), chunkable=chunkable)
        scripts.append((ns, _draw_script(10 + i, iters, names)))
    for it in range(iters):
        with rt.iteration():
            for ns, script in scripts:
                for ph, acc, bins, elapsed in script[it]:
                    with ns.phase(ph, accesses=acc, access_bins=bins,
                                  elapsed=elapsed):
                        pass
    return dict(
        plan=rt.plan.to_json() if rt.plan is not None else None,
        tiers={o.name: o.tier for o in rt.registry},
        # the slack mover keeps a move trace; both sim engines keep their
        # copies (object, destination, start and landing in virtual time)
        trace=json.dumps([dataclasses.asdict(r)
                          for r in getattr(rt.mover, "trace", [])]),
        copies=json.dumps([dataclasses.asdict(c) for c in rt.backend.copies]),
        moves=json.dumps(dataclasses.asdict(rt.mover.stats)),
        stats=json.dumps(rt.stats(), sort_keys=True, default=str))


@pytest.mark.parametrize("tenants", [0, 2])
@pytest.mark.parametrize("partition", [True, False])
@pytest.mark.parametrize("mover", ["slack", "fifo"])
def test_scripted_loop_matches_reference(mover, partition, tenants):
    ref = _run(ref_core, mover, partition, tenants)
    port = _run(port_core, mover, partition, tenants)
    assert ref["plan"] is not None and json.loads(ref["plan"])["moves"]
    assert json.loads(ref["copies"])
    for key in ("plan", "tiers", "trace", "copies", "moves", "stats"):
        assert port[key] == ref[key], key


def test_knapsack_solve_arrays_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(30):
        n = int(rng.integers(1, 60))
        values = rng.normal(1.0, 1.0, n)
        sizes = rng.integers(1, 1 << 20, n)
        cap = int(rng.integers(1, 1 << 22))
        np.testing.assert_array_equal(
            port_knapsack.solve_arrays(values, sizes, cap),
            ref_knapsack.solve_arrays(values, sizes, cap))


def test_knapsack_device_dp_is_not_silently_used(monkeypatch):
    """With the device DP on and no card, a solve above the threshold
    raises (no quiet fall back to numpy); one below it runs the numpy DP,
    as the reference's does."""
    monkeypatch.setattr(port_knapsack, "use_device", True)
    monkeypatch.setattr(port_knapsack, "dp_device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(3)
    values = rng.uniform(0.01, 1.0, 600)
    sizes = rng.integers(1, 5, 600) * MB
    cap = 256 * MB                       # 600 x 16,384 = 9.8M cells
    assert 600 * (cap // (cap // (1 << 14))) >= port_knapsack._DEVICE_MIN_WORK
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_knapsack.solve_arrays(values, sizes, cap)
    few = slice(0, 400)                  # 400 x 16,384 = 6.6M cells
    np.testing.assert_array_equal(
        port_knapsack.solve_arrays(values[few], sizes[few], cap),
        ref_knapsack.solve_arrays(values[few], sizes[few], cap))


def test_tree_flattens_in_jax_order_with_jax_key_strings():
    import jax
    tree = {"wq": 1, "bk": 2, "a": {"z": 3, "b": [4, (5, None)]}}
    pairs, treedef = _tree.flatten_with_path(tree)
    ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in pairs] == [jax.tree_util.keystr(p) for p, _ in ref]
    assert [leaf for _, leaf in pairs] == [leaf for _, leaf in ref]
    assert [p for p, _ in pairs][:2] == ["['a']['b'][0]", "['a']['b'][1][0]"]
    assert _tree.unflatten(treedef, [leaf for _, leaf in pairs]) == tree


def test_leaf_spans_match_reference_for_gemma_params_and_cache():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import lm as ref_lm
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import lm as port_lm

    cfg = get_config("gemma-2b").reduced()
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jc = ref_lm.init_cache(cfg, 2, 32)
    tc = port_lm.init_cache(cfg, 2, 32, device="cpu")
    spans = []
    for core, p, c in ((ref_core, jp, jc), (port_core, tp, tc)):
        rt = core.UnimemRuntime(core.PAPER_DRAM_NVM,
                                core.RuntimeConfig(backend="sim"))
        a = rt.register("params", p, manage_payload=False, pinned=True)
        b = rt.register("kv_cache", c, manage_payload=False, chunkable=True)
        spans.append((a.leaf_spans, a.size_bytes, b.leaf_spans,
                       b.size_bytes))
    assert spans[0] == spans[1]
    assert any("['blocks']['attn']['wq']" == s[0] for s in spans[1][0])


def test_meta_tensors_register_sizes_without_payload():
    rt = port_core.UnimemRuntime(port_core.PAPER_DRAM_NVM,
                                 port_core.RuntimeConfig(backend="sim"))
    spec = {"w": torch.empty((4, 8), dtype=torch.bfloat16, device="meta")}
    obj = rt.register("w", spec)
    assert obj.payload is None and obj.size_bytes == 64
    assert obj.leaf_spans == [("['w']", 0, 64)]


def test_torch_backends_flip_logical_objects_and_refuse_payload_moves():
    """Objects without a payload flip their tier; a real payload move
    without CUDA raises instead of pretending to have moved."""
    for name in ("torch", "torch_async"):
        backend = port_core.make_backend(name, port_core.H100_HBM_HOST)
        logical = port_core.DataObject("logical", 1024)
        assert backend.start_move(logical, "fast") is None
        assert logical.tier == "fast"
        if torch.cuda.is_available():
            continue
        real = port_core.DataObject("real", 16, payload=torch.zeros(4))
        with pytest.raises(RuntimeError, match="needs CUDA"):
            backend.start_move(real, "fast")
        assert real.tier == "slow"


def test_default_backend_and_chaos_inner_are_torch():
    assert port_core.RuntimeConfig().backend == "torch"
    chaos = port_core.make_backend("chaos", port_core.H100_HBM_HOST)
    assert isinstance(chaos.inner, port_core.AsyncTorchTierBackend)


def test_h100_profile_is_registered_and_not_a_tpu_copy():
    h = port_core.H100_HBM_HOST
    assert port_core.PROFILES[h.name] is h
    tpu = port_core.TPU_V5E
    assert h.fast.read_bw != tpu.fast.read_bw
    assert h.copy_bw != tpu.copy_bw
    assert h.slow.capacity_bytes > 0 and h.slow.bw > 0
