"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch versions, and the torch copy backends moving real tensors between
HBM and pinned host memory.  They skip without a card; on the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Whether a card is present is decided inside the ``cuda`` fixture, never at
import, so every worker collects the same tests.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,D,T,length,view", [
    (2, 2, 4, 128, 1024, 700, False), (2, 2, 4, 128, 700, 650, False),
    (2, 2, 4, 128, 512, 0, False), (4, 1, 8, 256, 1024, 1, True),
    (4, 1, 8, 256, 1024, 1024, True), (2, 1, 4, 16, 64, 37, True)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, B, K, G, D, T,
                                               length, view):
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    q = _randn((B, K, G, D), dtype, 0)
    if view:
        k = _randn((B, T, K, D), dtype, 1).permute(0, 2, 1, 3)
        v = _randn((B, T, K, D), dtype, 2).permute(0, 2, 1, 3)
    else:
        k, v = _randn((B, K, T, D), dtype, 1), _randn((B, K, T, D), dtype, 2)
    before = da.launches
    out = da.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    plain = da.decode_attention_plain(q, k, v, length)
    torch.testing.assert_close(out.float(), plain.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_decode_attention_kernel_reads_a_bf16_cache_from_fp32(cuda):
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    q = _randn((2, 1, 4, 16), torch.float32, 3)
    k = _randn((2, 1, 64, 16), torch.bfloat16, 4)
    v = _randn((2, 1, 64, 16), torch.bfloat16, 5)
    out = da.decode_attention(q, k, v, 40)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, da.decode_attention_plain(q, k, v, 40),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 512, 256), (300, 700, 500),
                                   (128, 128, 128), (4, 2048, 256),
                                   (4, 16384, 2048), (1, 3, 5), (5, 100, 13)])
def test_tiered_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x, w = _randn((M, K), dtype, 6, 0.1), _randn((K, N), dtype, 7, 0.1)
    before = mm.launches
    out = mm.tiered_matmul(x, w)
    torch.cuda.synchronize()
    assert mm.launches == before + 1
    torch.testing.assert_close(out.float(), mm.tiered_matmul_plain(x, w)
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])


def _objects(core, sizes):
    objs, golden = {}, {}
    g = torch.Generator().manual_seed(0)
    for name, n in sizes.items():
        golden[name] = torch.randint(0, 256, (n,), dtype=torch.uint8,
                                     generator=g)
        objs[name] = core.DataObject(name, n,
                                     payload={"a": golden[name].pin_memory()})
    return objs, golden


def test_async_backend_moves_bytes_and_flips_on_landing(cuda):
    core = importlib.import_module("repro_torch.core")
    be = core.make_backend("torch_async", core.H100_HBM_HOST, channels=2)
    objs, golden = _objects(core, {"x": 1 << 24, "y": 1 << 24})
    h = be.start_move(objs["x"], "fast")
    assert objs["x"].tier == "slow"              # not landed yet
    be.wait(h, timeout=30.0)
    assert objs["x"].tier == "fast" and objs["x"].payload["a"].is_cuda
    # eviction of x, then a fetch of y chained behind it (after=)
    ev = be.start_move(objs["x"], "slow")
    fe = be.start_move(objs["y"], "fast", after=ev)
    assert ev.landed                             # the fence landed it
    assert objs["x"].payload["a"].is_pinned()
    be.complete(fe)
    assert be.is_done(fe) and objs["y"].payload["a"].is_cuda
    back = be.start_move(objs["y"], "slow")
    torch.cuda.synchronize()
    be.settle()
    assert back.landed and objs["y"].tier == "slow"
    for name, obj in objs.items():
        assert torch.equal(obj.payload["a"].cpu(), golden[name])


def test_blocking_backend_flips_at_issue_and_fences_on_wait(cuda):
    core = importlib.import_module("repro_torch.core")
    be = core.make_backend("torch", core.H100_HBM_HOST)
    objs, golden = _objects(core, {"x": 1 << 20})
    h = be.start_move(objs["x"], "fast")
    assert objs["x"].tier == "fast" and objs["x"].payload["a"].is_cuda
    be.wait(h)
    h = be.start_move(objs["x"], "slow")
    be.wait(h, timeout=30.0)
    assert torch.equal(objs["x"].payload["a"], golden["x"])


def test_runtime_moves_real_tensors_ahead_of_use(cuda):
    core = importlib.import_module("repro_torch.core")
    MB = 1024 ** 2
    rt = core.UnimemRuntime(core.H100_HBM_HOST, core.RuntimeConfig(
        backend="torch_async", enable_partitioning=False,
        fast_capacity_bytes=40 * MB))
    hot = rt.register("hot", torch.ones(16 * MB // 4).pin_memory())
    cold = rt.register("cold", torch.ones(32 * MB // 4).pin_memory())
    for _ in range(4):
        with rt.iteration():
            with rt.phase("compute", elapsed=0.05, accesses={"hot": 4e5}):
                pass
            with rt.phase("update", elapsed=0.02, accesses={"cold": 5e2}):
                pass
    rt.mover.drain()
    assert hot.payload.is_cuda and hot.tier == "fast"
    assert cold.payload.is_pinned() and cold.tier == "slow"
    assert float(hot.payload.sum()) == 16 * MB // 4


def test_reduced_gemma_serves_the_same_tokens_on_card_and_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("gemma-2b").reduced()
    cpu, gpu = (lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=d, dtype=torch.float32)
                for d in ("cpu", "cuda"))
    prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(1))
    outs = [ServeEngine(cfg, p, max_seq=32, batch=2, device=d)
            .generate(prompts, 5).cpu()
            for d, p in (("cpu", cpu), ("cuda", gpu))]
    assert torch.equal(outs[0], outs[1])
