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
    (4, 1, 8, 256, 1024, 1024, True), (2, 1, 4, 16, 64, 37, True),
    # the largest G the kernel takes
    (2, 2, 16, 128, 1024, 1, True), (2, 2, 16, 128, 1024, 33, True),
    (2, 2, 16, 128, 1024, 161, True), (2, 2, 16, 128, 1024, 1024, True),
    # yi-6b's (G 8) and chatglm3-6b's (G 16) serving caches, D 128
    (4, 4, 8, 128, 1024, 1, True), (4, 4, 8, 128, 1024, 160, True),
    (4, 4, 8, 128, 1024, 1024, True), (4, 2, 16, 128, 1024, 1, True),
    (4, 2, 16, 128, 1024, 160, True), (4, 2, 16, 128, 1024, 1024, True),
    # dbrx-132b's G 6 (a block of 8 heads, 2 masked) and moonshot-v1-16b-
    # a3b's G 1 over 16 KV heads, D 128
    (4, 8, 6, 128, 1024, 1, True), (4, 8, 6, 128, 1024, 160, True),
    (4, 8, 6, 128, 1024, 1024, True), (4, 16, 1, 128, 1024, 160, True),
    # phi-3-vision-4.2b's D 96 (G 1, K 32) and nemotron-4-340b's G 12 (a
    # block of 8 heads and one of 4 with 4 masked) at D 192 (24 chunks of
    # 16 bytes a bf16 row: no power of 2)
    (4, 32, 1, 96, 1024, 1, True), (4, 32, 1, 96, 1024, 160, True),
    (4, 32, 1, 96, 1024, 1024, True), (4, 8, 12, 192, 1024, 1, True),
    (4, 8, 12, 192, 1024, 160, True), (4, 8, 12, 192, 1024, 1024, True)])
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


@pytest.mark.parametrize("length", [160, 1024])
def test_decode_attention_kernel_with_peaked_scores_matches_float64(cuda,
                                                                    length):
    """zamba2-1.2b's serving shape (K 32, G 1, D 64) in bf16 with q x 8, so
    the running max moves between tiles and between splits; against the
    attention computed in float64, at the bf16 tolerance."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    ref = importlib.import_module("repro_torch.kernels.ref")
    q = _randn((4, 32, 1, 64), torch.bfloat16, 16, 8.0)
    k = _randn((4, 1024, 32, 64), torch.bfloat16, 17).permute(0, 2, 1, 3)
    v = _randn((4, 1024, 32, 64), torch.bfloat16, 18).permute(0, 2, 1, 3)
    out = da.decode_attention(q, k, v, length)
    want = ref.decode_attention_f64(q, k, v, length)
    torch.testing.assert_close(out.double(), want, rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype,B,K,G,D,length", [
    (torch.float32, 4, 32, 1, 64, 160), (torch.float32, 2, 2, 16, 128, 161),
    (torch.float32, 2, 1, 4, 16, 37), (torch.float32, 2, 2, 4, 160, 161),
    (torch.bfloat16, 2, 2, 4, 96, 161), (torch.bfloat16, 2, 2, 4, 160, 33),
    (torch.bfloat16, 4, 1, 8, 96, 1024), (torch.bfloat16, 4, 32, 1, 96, 160),
    (torch.bfloat16, 4, 8, 12, 192, 161), (torch.float32, 2, 2, 12, 192, 33)])
def test_decode_attention_kernel_ignores_stale_shared_memory(cuda, dtype, B,
                                                             K, G, D, length):
    """Shapes whose lanes own 16-byte chunks past D, which the kernel never
    copies (fp32 at D <= 128, 160 or 192, bf16 at D 96, 160 or 192;
    phi-3-vision-4.2b's and nemotron-4-340b's G 12 among them): with every SM's
    shared memory filled with NaN just before the call, the output still
    matches the plain version."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    q = _randn((B, K, G, D), dtype, 19)
    k = _randn((B, 1024, K, D), dtype, 20).permute(0, 2, 1, 3)
    v = _randn((B, 1024, K, D), dtype, 21).permute(0, 2, 1, 3)
    da.fill_shared_memory_nan(q.device)
    out = da.decode_attention(q, k, v, length)
    torch.testing.assert_close(out.float(),
                               da.decode_attention_plain(q, k, v,
                                                         length).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


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
@pytest.mark.parametrize("M,K,N", [
    (256, 512, 256), (300, 700, 500), (128, 128, 128), (4, 2048, 256),
    (4, 16384, 2048), (1, 3, 5), (5, 100, 13),
    # one block of 8 rows of x, and two, at gemma-2b's w_down and zamba2-
    # 1.2b's in_proj (N = 8384: the last 256-column tile loads one box)
    (1, 16384, 2048), (8, 16384, 2048), (9, 16384, 2048),
    (1, 2048, 8384), (4, 2048, 8384), (8, 2048, 8384), (9, 2048, 8384),
    # K not a multiple of the ring's 64-row stage (one under one stage, one
    # whose 2560-row K splits outgrow the 2048-k window of x); N a
    # multiple of 8 but not of 64
    (4, 2000, 2048), (3, 100, 264), (3, 40, 264), (4, 20000, 2048)])
def test_tiered_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x, w = _randn((M, K), dtype, 6, 0.1), _randn((K, N), dtype, 7, 0.1)
    before = mm.launches
    out = mm.tiered_matmul(x, w)
    torch.cuda.synchronize()
    assert mm.launches == before + 1
    torch.testing.assert_close(out.float(), mm.tiered_matmul_plain(x, w)
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype,M,K,N", [
    (torch.bfloat16, 4, 16384, 2048), (torch.bfloat16, 4, 2048, 8384),
    (torch.bfloat16, 9, 2000, 264), (torch.float32, 4, 16384, 2048)])
def test_tiered_matmul_kernel_gives_the_same_bits_every_run(cuda, dtype, M,
                                                            K, N):
    """The K split is merged inside the kernel in a fixed order, not by
    atomics: the same inputs give the same bits."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x, w = _randn((M, K), dtype, 8, 0.1), _randn((K, N), dtype, 9, 0.1)
    first = mm.tiered_matmul(x, w)
    assert all(torch.equal(first, mm.tiered_matmul(x, w)) for _ in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(18432, 73728), (73728, 18432)])
def test_tiered_matmul_kernel_reads_the_far_end_of_nemotrons_mlp(cuda, dtype,
                                                                 K, N):
    """nemotron-4-340b's w_up and w_down at batch 4: 1.36e9 elements, 2.7
    GB in bf16 and 5.4 GB in fp32, so byte offsets pass 2^31.  The product
    against the plain version; the last row of w alone (an x of 1 in its
    last column, 0 elsewhere: one product a sum) comes out exactly; the
    last column of y meets the float64 product."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x, w = _randn((4, K), dtype, 12, 0.1), _randn((K, N), dtype, 13, 0.1)
    out = mm.tiered_matmul(x, w)
    torch.testing.assert_close(out.float(), mm.tiered_matmul_plain(x, w)
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])
    col = (x.double() @ w[:, -1].double()).to(dtype)
    torch.testing.assert_close(out[:, -1].float(), col.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    sel = torch.zeros_like(x)
    sel[:, -1] = 1
    assert torch.equal(mm.tiered_matmul(sel, w), w[-1:].expand(4, N))


@pytest.mark.parametrize("M,K,N", [(4, 2048, 8384), (3, 100, 264)])
def test_tiered_matmul_kernel_ignores_stale_shared_memory(cuda, M, K, N):
    """With every SM's shared memory filled with NaN just before the call,
    a ring stage read before its copy lands, or a slot no copy fills,
    would show as NaN."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    x = _randn((M, K), torch.bfloat16, 10, 0.1)
    w = _randn((K, N), torch.bfloat16, 11, 0.1)
    assert mm.route(x, w) == "mma"
    da.fill_shared_memory_nan(x.device)
    out = mm.tiered_matmul(x, w)
    torch.testing.assert_close(out.float(), mm.tiered_matmul_plain(x, w)
                               .float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


# one gemma-2b and one chatglm3-6b layer's 7 decode products, (K, N): wq,
# wk, wv, wo, w_gate, w_up, w_down
GEMMA_PRODUCTS = [(2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
                  (2048, 16384), (2048, 16384), (16384, 2048)]
GLM_PRODUCTS = [(4096, 4096), (4096, 256), (4096, 256), (4096, 4096),
                (4096, 13696), (4096, 13696), (13696, 4096)]
WGMMA_PRODUCTS = sorted(set(GEMMA_PRODUCTS + GLM_PRODUCTS))


@pytest.mark.parametrize("K,N", WGMMA_PRODUCTS)
@pytest.mark.parametrize("M", [64, 128, 129, 200])
def test_tiered_matmul_wgmma_route_matches_plain(cuda, M, K, N):
    """The warpgroup route at a decode batch of 128 and round it (its
    threshold, one row into a second 128-row tile, a ragged last tile) on
    gemma-2b's and chatglm3-6b's products: one launch a call, within
    TOL[bf16] of the plain version."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x = _randn((M, K), torch.bfloat16, 14, 0.1)
    w = _randn((K, N), torch.bfloat16, 15, 0.1)
    assert mm.route(x, w) == ("wgmma" if M >= mm.WGMMA_MIN_M else "mma")
    before = mm.launches
    out = mm.tiered_matmul(x, w)
    torch.cuda.synchronize()
    assert mm.launches == before + 1
    torch.testing.assert_close(out.float(), mm.tiered_matmul_plain(x, w)
                               .float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("M,K,N", [(128, 16384, 2048), (128, 4096, 13696),
                                   (200, 2000, 264)])
def test_tiered_matmul_wgmma_route_gives_the_same_bits_every_run(cuda, M, K,
                                                                 N):
    """The warpgroup route's K split is merged in a fixed order too."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x = _randn((M, K), torch.bfloat16, 16, 0.1)
    w = _randn((K, N), torch.bfloat16, 17, 0.1)
    assert mm.route(x, w) == "wgmma"
    first = mm.tiered_matmul(x, w)
    assert all(torch.equal(first, mm.tiered_matmul(x, w)) for _ in range(3))


@pytest.mark.parametrize("M,K,N", [(128, 2048, 8384), (129, 2000, 264),
                                   (65, 40, 136)])
def test_tiered_matmul_wgmma_route_ignores_stale_shared_memory(cuda, M, K,
                                                               N):
    """Behind a NaN fill of every SM's shared memory: a ring slot read
    before its copy lands, or a partial row no product wrote, shows."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    x = _randn((M, K), torch.bfloat16, 18, 0.1)
    w = _randn((K, N), torch.bfloat16, 19, 0.1)
    assert mm.route(x, w) == "wgmma"
    da.fill_shared_memory_nan(x.device)
    out = mm.tiered_matmul(x, w)
    torch.testing.assert_close(out.float(), mm.tiered_matmul_plain(x, w)
                               .float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


# the expert route: (R, E, K, N, experts): moonshot-v1-16b-a3b's and
# dbrx-132b's decode at batch 4 (each token's k distinct experts, drawn);
# every row on one expert (more than 8: tiles of 8 rows, of 4 on the FFMA
# kernel); R no multiple of 8 with experts no row picks; K and N
# multiples of no tile; N no multiple of 8; an expert's rows across two
# warp-wide chunks of 32
EXPERT_CASES = [
    (24, 64, 2048, 1408, "decode6"), (24, 64, 1408, 2048, "decode6"),
    (16, 16, 6144, 10752, "decode4"), (16, 16, 10752, 6144, "decode4"),
    (20, 16, 2048, 1408, [5] * 20), (9, 4, 1408, 2048, [3] * 9),
    (13, 8, 2048, 1408, [i % 7 for i in range(13)]),
    (13, 8, 100, 264, [6 - i % 5 for i in range(13)]),
    (5, 3, 1000, 13, [2, 0, 2, 2, 0]),
    (40, 2, 256, 264, [i % 2 for i in range(40)])]


def _experts(R, E, spec, seed):
    if isinstance(spec, list):
        return torch.tensor(spec, dtype=torch.int32, device="cuda")
    k = int(spec[len("decode"):])
    g = torch.Generator(device="cuda").manual_seed(seed)
    scores = torch.rand((R // k, E), generator=g, device="cuda")
    return scores.topk(k, dim=-1).indices.reshape(-1).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,E,K,N,spec", EXPERT_CASES)
def test_tiered_matmul_experts_kernel_matches_plain(cuda, dtype, R, E, K, N,
                                                    spec):
    """One launch, the same bits on a second call, and the plain version's
    numbers within the kernel tolerance."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x = _randn((R, K), dtype, 12, 0.1)
    w = _randn((E, K, N), dtype, 13, 0.1)
    expert = _experts(R, E, spec, 14)
    before = mm.expert_launches
    out = mm.tiered_matmul_experts(x, w, expert)
    again = mm.tiered_matmul_experts(x, w, expert)
    torch.cuda.synchronize()
    assert mm.expert_launches == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(
        out.float(), mm.tiered_matmul_experts_plain(x, w, expert).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_tiered_matmul_experts_reads_no_unpicked_expert(cuda):
    """Experts no row picks may hold anything: NaN there changes nothing."""
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x = _randn((13, 2048), torch.bfloat16, 15, 0.1)
    w = _randn((8, 2048, 1408), torch.bfloat16, 16, 0.1)
    expert = torch.tensor([i % 6 for i in range(13)], dtype=torch.int32,
                          device="cuda")
    want = mm.tiered_matmul_experts(x, w, expert)
    w[6:] = float("nan")
    got = mm.tiered_matmul_experts(x, w, expert)
    assert torch.equal(got, want)


def test_tiered_matmul_experts_wrapper_refuses_what_the_kernel_does_not_take(
        cuda):
    mm = importlib.import_module("repro_torch.kernels.tiered_matmul")
    x = _randn((4, 64), torch.bfloat16, 17)
    w = _randn((3, 64, 64), torch.bfloat16, 18)
    ex = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        mm.tiered_matmul_experts(x, w, ex.long())
    with pytest.raises(ValueError):
        mm.tiered_matmul_experts(x, w, ex.cpu())
    with pytest.raises(ValueError):
        mm.tiered_matmul_experts(x, w.transpose(1, 2), ex)
    with pytest.raises(ValueError):
        mm.tiered_matmul_experts(x, _randn((1025, 64, 8), torch.bfloat16, 19),
                                 ex)


@pytest.mark.parametrize("arch,heads", [("moonshot-v1-16b-a3b", None),
                                        ("dbrx-132b", None), ("dbrx-132b", 6)])
def test_reduced_moe_serves_the_same_tokens_on_card_and_cpu(cuda, arch,
                                                            heads):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=1)
    cpu, gpu = (lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=d, dtype=torch.float32)
                for d in ("cpu", "cuda"))
    prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(1))
    outs = []
    for d, p in (("cpu", cpu), ("cuda", gpu)):
        ops.reset_launch_counts()
        outs.append(ServeEngine(cfg, p, max_seq=32, batch=2, device=d)
                    .generate(prompts, 5).cpu())
    assert ops.launch_counts()["tiered_matmul_experts"] == 3 * 2 * 11
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("arch,heads,head_dim", [
    ("musicgen-large", None, None), ("phi-3-vision-4.2b", None, 96),
    ("nemotron-4-340b", 12, 192)])
def test_reduced_dense_and_frontend_configs_match_the_cpu(cuda, arch, heads,
                                                          head_dim):
    """The plain MLP (musicgen-large, nemotron-4-340b) and the frontends,
    reduced, fp32 weights, at the real head width and G where given: the
    same greedy tokens on the card and the CPU, every product a
    tiered_matmul launch (4 attention products and 2 or 3 of the MLP a
    layer), and ``forward`` with frontend embeddings within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=1)
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    cpu, gpu = (lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=d, dtype=torch.float32)
                for d in ("cpu", "cuda"))
    prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(1))
    outs = []
    for d, p in (("cpu", cpu), ("cuda", gpu)):
        ops.reset_launch_counts()
        outs.append(ServeEngine(cfg, p, max_seq=32, batch=2, device=d)
                    .generate(prompts, 5).cpu())
    mlp = 2 if cfg.mlp_type == "mlp" else 3
    assert ops.launch_counts()["tiered_matmul"] == (4 + mlp) * 2 * 11
    assert torch.equal(outs[0], outs[1])
    n_front = cfg.frontend_tokens
    fe = torch.randn((2, n_front, cfg.d_model),
                     generator=torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (2, 300),
                         generator=torch.Generator().manual_seed(3))
    want, _ = lm.forward(cpu, cfg, toks, fe if n_front else None)
    got, _ = lm.forward(gpu, cfg, toks.cuda(),
                        fe.cuda() if n_front else None)
    assert got.shape == (2, n_front + 300, cfg.vocab_size)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


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


# the flash-attention backward in fp32 sums dk and dv over G * S stacked
# rows in another order than the plain version (see chip_smoke.BWD_TOL)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


FLASH_CASES = [
    (1, 1, 1, 128, 128, 128, True), (2, 2, 2, 256, 256, 128, False),
    (1, 2, 4, 128, 384, 128, True), (1, 2, 4, 128, 300, 128, False),
    (2, 1, 4, 24, 24, 16, True), (1, 1, 3, 70, 45, 64, True),
    (2, 1, 8, 256, 256, 256, True),
    (1, 1, 8, 300, 300, 256, True),     # S, T multiples of no tile
    (1, 1, 8, 128, 384, 256, True),     # S != T at D = 256
    (1, 32, 1, 512, 512, 64, True),     # zamba2's G, K, D
    # yi-6b's G 8 and chatglm3-6b's G 16 at D 128, S and T multiples of no
    # tile, causal and not
    (1, 4, 8, 300, 300, 128, True), (1, 2, 16, 300, 300, 128, True),
    (1, 2, 16, 256, 384, 128, False),
    # dbrx-132b's G 6 at D 128
    (1, 2, 6, 300, 300, 128, True), (1, 2, 6, 256, 384, 128, False),
    (2, 8, 6, 256, 256, 128, True),
    # phi-3-vision-4.2b's D 96 (the D 128 instantiation, a quarter of each
    # tile's columns past D) over 2048 + 144 patch positions (the last key
    # tile ragged); nemotron-4-340b's G 12 at D 192 (the D 256 one, its
    # last 64-wide box wholly past D), causal and not
    (1, 4, 1, 2192, 2192, 96, True), (1, 4, 1, 300, 300, 96, False),
    (1, 2, 12, 300, 300, 192, True), (1, 2, 12, 256, 384, 192, False)]
# q x 8: peaked scores, the running max moves between key tiles; bf16
# only (chip_smoke.PEAKED_DTYPES says why)
FLASH_PEAKED = [(1, 1, 8, 300, 300, 256, True), (1, 32, 1, 512, 512, 64, True),
                (1, 2, 16, 300, 300, 128, True),
                (1, 2, 6, 300, 300, 128, True),
                (1, 4, 1, 2192, 2192, 96, True),
                (1, 2, 12, 300, 300, 192, True)]


@pytest.mark.parametrize(
    "dtype,B,K,G,S,T,D,causal,peak",
    [(dt, *c, 1) for dt in (torch.float32, torch.bfloat16)
     for c in FLASH_CASES] + [(torch.bfloat16, *c, 8) for c in FLASH_PEAKED])
def test_flash_attention_kernels_match_plain(cuda, dtype, B, K, G, S, T, D,
                                             causal, peak):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q = _randn((B, K, G, S, D), dtype, 8, float(peak))
    do = _randn((B, K, G, S, D), dtype, 9)
    k, v = _randn((B, K, T, D), dtype, 10), _randn((B, K, T, D), dtype, 11)
    before = (fa.launches, fa.bwd_launches)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, out, do, lse, causal)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain, plain_lse = fa.flash_attention_plain(*leaves, causal)
    torch.testing.assert_close(out.float(), plain.detach().float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, plain_lse.detach(), rtol=2e-5, atol=2e-5)
    for g, w in zip(grads, torch.autograd.grad(plain, leaves, do)):
        torch.testing.assert_close(g.float(), w.float(), rtol=BWD_TOL[dtype],
                                   atol=BWD_TOL[dtype])


def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q = _randn((1, 1, 2, 16, 12), torch.float32, 0)        # D % 8 != 0
    k = _randn((1, 1, 16, 12), torch.float32, 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention_fwd(q, k, k)
    q = _randn((1, 2, 2, 16, 16), torch.float32, 0)
    k = _randn((1, 16, 2, 16), torch.float32, 1).permute(0, 2, 1, 3)
    assert not k.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q, k, k)
    out = fa.flash_attention(q, k, k)          # the autograd entry copies
    torch.testing.assert_close(
        out, fa.flash_attention_plain(q, k, k)[0], rtol=2e-5, atol=2e-5)


def test_reduced_train_step_on_card_matches_the_cpu(cuda):
    """One training step of reduced gemma-2b with fp32 parameters: the
    kernels on the card against the plain versions on the CPU."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train.step import build_train_step
    cfg = get_config("gemma-2b").reduced()
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device=dev, dtype=torch.float32)
        state = init_opt_state(params, AdamWConfig(lr=1e-3))
        batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
        ops.reset_launch_counts()
        step = build_train_step(cfg, AdamWConfig(lr=1e-3), lr=1e-3)
        out[dev] = (step(params, state, batch), ops.launch_counts())
    (p_cpu, _, m_cpu), n_cpu = out["cpu"]
    (p_gpu, _, m_gpu), n_gpu = out["cuda"]
    assert set(n_cpu.values()) == {0}
    assert n_gpu["flash_attention"] == 2 * cfg.n_layers      # remat
    assert n_gpu["flash_attention_bwd"] == cfg.n_layers
    assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                 rel=1e-5)
    # Adam's first update is +-lr per element (see test_torch_train.py)
    for a, b in zip(_tree.leaves(p_gpu), _tree.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-3)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    from repro_torch import _tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = get_config("gemma-2b").reduced()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    state = {"params": params, "opt": init_opt_state(
        params, AdamWConfig(moments_dtype="int8"))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, blocking=True)
    step, back = mgr.restore()
    assert step == 7
    for a, b in zip(_tree.leaves(state), _tree.leaves(back)):
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b)


# ------------------------------------------------------------ SSD scan
# fp32 throughout; the reference's SSD tolerance (tests/test_kernels.py).
# With decays near 1 the kernel's d(log a) is held against the plain
# version run in float64 (see chip_smoke.SSD_DECAY_RANGE), at the same
# tolerance
SSD_TOL = 1e-4


def _ssd_inputs(B, H, S, N, P, seed, bcast, near1=False):
    """Decays a = sigmoid(randn), or with ``near1`` exp(-U(1e-3, 0.02)) as
    real Mamba-2 heads: only then do the carried state, the dS carry and
    the sub-tiles far below the diagonal reach the outputs with weight
    (e^{cum_L} ~ 0.07 over 256 positions, against e^-200 with sigmoid)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    if near1:
        a = torch.exp(-(1e-3 + 0.019 * torch.rand((B, S, H), generator=g,
                                                  device="cuda")))
    else:
        a = torch.sigmoid(r(B, S, H))
    if bcast:   # the model's layout: (B, S, H, .) with k, q broadcast over H
        k, q = (r(B, S, N)[:, :, None].expand(B, S, H, N) * 0.3
                for _ in range(2))
    else:
        k, q = r(B, S, H, N) * 0.3, r(B, S, H, N) * 0.3
    v = r(B, S, H, P) * 0.3
    return [t.transpose(1, 2) for t in (a, k, v, q)]


SSD_CASES = [
    (2, 3, 512, 64, 64, 256, False, False), (2, 3, 300, 32, 64, 128, False,
                                             True),
    (2, 3, 256, 16, 16, 256, False, False), (2, 8, 24, 16, 16, 24, True,
                                             False),
    (1, 4, 1000, 64, 64, 256, True, True), (1, 2, 130, 8, 96, 64, True,
                                            True),
    # the wide route (N or P above 64): the one-head reduced xlstm's state
    # (N 128, P 129) over 600 positions, the last chunk ragged; N above 64
    # with k and q broadcast; P above 64 and no multiple of 4
    (2, 1, 600, 128, 129, 256, False, True),
    (1, 2, 130, 96, 40, 64, True, False),
    (1, 2, 200, 40, 101, 64, False, True)]


def _check_ssd_kernels(B, H, S, N, P, chunk, bcast, init, near1):
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    a, k, v, q = _ssd_inputs(B, H, S, N, P, 12, bcast, near1)
    s0 = _randn((B, H, N, P), torch.float32, 13, 0.3) if init else None
    before = (ss.launches, ss.bwd_launches)
    y, fin, states = ss.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    torch.cuda.synchronize()
    assert ss.launches == before[0] + 1
    yp, finp, stp = ss._plain_forward(a, k, v, q, chunk, s0)
    for got, want in ((y, yp), (fin, finp), (states, stp)):
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)
    # the normalizer's column of an mLSTM (the ragged P tile) on its own
    torch.testing.assert_close(y[..., -1], yp[..., -1], rtol=SSD_TOL,
                               atol=SSD_TOL)
    dy = _randn((B, H, S, P), torch.float32, 14)
    dfin = _randn((B, H, N, P), torch.float32, 15)
    grads = ss.ssd_scan_bwd(a, k, v, q, dy, states, fin, dfin, chunk, init)
    torch.cuda.synchronize()
    assert ss.bwd_launches == before[1] + 1
    want = ss.ssd_scan_bwd_plain(a, k, v, q, dy, stp, finp, dfin, chunk, init)
    if near1:
        wide = [t.double() for t in (a, k, v, q)]
        _, fin64, st64 = ss._plain_forward(
            *wide, chunk, None if s0 is None else s0.double())
        da64 = ss.ssd_scan_bwd_plain(*wide, dy.double(), st64, fin64,
                                     dfin.double(), chunk, init)[0]
        want = (da64,) + tuple(want[1:])
    for name, g, w in zip(("da", "dk", "dv", "dq", "dinit"), grads, want):
        if w is None:
            assert g is None
            continue
        if name == "da":        # compare d log a: da carries a 1/a factor
            g, w = (g * a).to(w.dtype), w * a
        torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL,
                                   msg=name)


@pytest.mark.parametrize("B,H,S,N,P,chunk,bcast,init", SSD_CASES)
def test_ssd_scan_kernels_match_plain(cuda, B, H, S, N, P, chunk, bcast,
                                      init):
    _check_ssd_kernels(B, H, S, N, P, chunk, bcast, init, False)


@pytest.mark.parametrize("B,H,S,N,P,chunk,bcast,init", SSD_CASES)
def test_ssd_scan_kernels_match_plain_with_decays_near_one(
        cuda, B, H, S, N, P, chunk, bcast, init):
    _check_ssd_kernels(B, H, S, N, P, chunk, bcast, init, True)


@pytest.mark.parametrize("near1", [False, True])
def test_ssd_scan_bwd_dloga_at_the_training_shape_beats_the_plain_version(
        cuda, near1):
    """zamba2-1.2b's training shape (B 2, H 64, S 4096, N = P = 64, chunks
    of 256, k and q broadcast over H): the kernel's d(log a) lies no
    further from the float64 plain version than the fp32 plain version
    (the reference's arithmetic) does, and within SSD_TOL of it."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    B, H, S, N, P, chunk = 2, 64, 4096, 64, 64, 256
    a, k, v, q = _ssd_inputs(B, H, S, N, P, 21, True, near1)
    dy = _randn((B, H, S, P), torch.float32, 22)
    y, fin, states = ss.ssd_scan_fwd(a, k, v, q, chunk, save_states=True)
    da = ss.ssd_scan_bwd(a, k, v, q, dy, states, fin, None, chunk, False)[0]

    def plain_dloga(dtype):
        leaves = [t.detach().to(dtype).clone().requires_grad_()
                  for t in (a, k, v, q)]
        out, _, _ = ss._plain_forward(*leaves, chunk)
        return torch.autograd.grad(out, leaves[0], dy.to(dtype))[0] \
            * leaves[0].detach()

    gold = plain_dloga(torch.float64)
    kernel_err = ((da * a).double() - gold).abs().max().item()
    plain_err = (plain_dloga(torch.float32).double() - gold).abs().max().item()
    assert kernel_err <= plain_err, (kernel_err, plain_err)
    torch.testing.assert_close((da * a).double(), gold, rtol=SSD_TOL,
                               atol=SSD_TOL)


@pytest.mark.parametrize("near1", [False, True])
def test_ssd_scan_kernels_at_xlstms_training_shape_meet_float64(cuda, near1):
    """xlstm-350m's mLSTM training shape (B 2, H 4, S 2048, N 512, P 513,
    chunks of 256, k and q per head): the forward within SSD_TOL of the
    plain version; every output of the backward within SSD_TOL of the
    plain version run in float64, under xLSTM's decays (a sigmoid) and
    near 1: there the fp32 plain version, summing 512- and 513-deep
    products, itself lies up to 3e-4 from float64 in dq and dv (H100)."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    B, H, S, N, P, chunk = _ssd_shape("xlstm")
    a, k, v, q = _ssd_inputs(B, H, S, N, P, 31, False, near1)
    dy = _randn((B, H, S, P), torch.float32, 32)
    y, fin, states = ss.ssd_scan_fwd(a, k, v, q, chunk, save_states=True)
    yp, finp, stp = ss._plain_forward(a, k, v, q, chunk)
    for name, got, want in (("y", y, yp), ("final", fin, finp),
                            ("states", states, stp)):
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL,
                                   msg=name)
    grads = ss.ssd_scan_bwd(a, k, v, q, dy, states, fin, None, chunk, False)
    wide = [t.double() for t in (a, k, v, q)]
    _, fin64, st64 = ss._plain_forward(*wide, chunk)
    want = ss.ssd_scan_bwd_plain(*wide, dy.double(), st64, fin64, None,
                                 chunk, False)
    torch.testing.assert_close((grads[0] * a).double(),
                               want[0] * a.double(), rtol=SSD_TOL,
                               atol=SSD_TOL)
    for name, g, w in zip(("dk", "dv", "dq"), grads[1:4], want[1:4]):
        torch.testing.assert_close(g.double(), w, rtol=SSD_TOL, atol=SSD_TOL,
                                   msg=name)


def _ssd_shape(shape):
    """(B, H, S, N, P, chunk): zamba2-1.2b's training shape ("train"), the
    ragged (1, 4, 1000) one, the reduced config's chunks of 64, or the wide
    route's: xlstm-350m's training shape ("xlstm": N 512, P 513) and the
    one-head reduced xlstm's state over a ragged 600 ("wide_ragged")."""
    if shape == "xlstm":
        return (2, 4, 2048, 512, 513, 256)
    if shape == "wide_ragged":
        return (2, 1, 600, 128, 129, 256)
    if shape == "reduced":
        from repro_torch.configs import get_config
        zr = get_config("zamba2-1.2b").reduced()
        return (2, zr.ssm_expand * zr.d_model // zr.ssm_head_dim, 64,
                zr.ssm_state, zr.ssm_head_dim, 64)
    return ((2, 64, 4096, 64, 64, 256) if shape == "train"
            else (1, 4, 1000, 64, 64, 256))


@pytest.mark.parametrize("shape", ["train", "ragged", "reduced", "xlstm",
                                   "wide_ragged"])
def test_ssd_scan_fwd_gives_the_same_bits_on_every_call(cuda, shape):
    """Two calls of the forward on the same inputs give the same y, final
    state and chunk states, bit for bit: no atomics and a fixed order of
    every sum, in each of its three launches.  k and q broadcast over H,
    decays near 1, an initial state."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    B, H, S, N, P, chunk = _ssd_shape(shape)
    a, k, v, q = _ssd_inputs(B, H, S, N, P, 27, True, near1=True)
    s0 = _randn((B, H, N, P), torch.float32, 28, 0.3)
    first = ss.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    second = ss.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    for name, x, y2 in zip(("y", "final", "states"), first, second):
        assert torch.equal(x, y2), name


@pytest.mark.parametrize("B,H,S,N,P,chunk,bcast", [
    (2, 3, 300, 32, 64, 128, False), (1, 4, 1000, 64, 64, 256, True),
    (1, 2, 130, 6, 12, 64, True), (2, 1, 600, 128, 129, 256, False),
    (1, 2, 130, 96, 40, 64, True)])
def test_ssd_scan_fwd_ignores_stale_shared_memory(cuda, B, H, S, N, P, chunk,
                                                  bcast):
    """Every SM's shared memory filled with NaN just before the forward: a
    read of a tile or slot that no copy wrote would reach y or the states.
    A ragged last chunk, and N, P no multiple of 4 (the 4-byte copies);
    decays near 1, an initial state."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    a, k, v, q = _ssd_inputs(B, H, S, N, P, 29, bcast, near1=True)
    s0 = _randn((B, H, N, P), torch.float32, 30, 0.3)
    da.fill_shared_memory_nan(a.device)
    got = ss.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    want = ss._plain_forward(a, k, v, q, chunk, s0)
    for name, g, w in zip(("y", "final", "states"), got, want):
        torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL, msg=name)


@pytest.mark.parametrize("shape", ["train", "ragged", "reduced", "xlstm",
                                   "wide_ragged"])
def test_ssd_scan_bwd_gives_the_same_bits_on_every_call(cuda, shape):
    """Two calls of the backward on the same inputs give the same bits: no
    atomics and a fixed order of every sum, in each of its three launches.
    k and q broadcast over H, decays near 1, an initial state and a
    final-state gradient."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    B, H, S, N, P, chunk = _ssd_shape(shape)
    a, k, v, q = _ssd_inputs(B, H, S, N, P, 23, True, near1=True)
    s0 = _randn((B, H, N, P), torch.float32, 24, 0.3)
    dy = _randn((B, H, S, P), torch.float32, 25)
    dfin = _randn((B, H, N, P), torch.float32, 26)
    y, fin, states = ss.ssd_scan_fwd(a, k, v, q, chunk, s0, save_states=True)
    first = ss.ssd_scan_bwd(a, k, v, q, dy, states, fin, dfin, chunk, True)
    second = ss.ssd_scan_bwd(a, k, v, q, dy, states, fin, dfin, chunk, True)
    for name, x, y2 in zip(("da", "dk", "dv", "dq", "dinit"), first, second):
        assert torch.equal(x, y2), name


def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    a, k, v, q = _ssd_inputs(1, 2, 40, 16, 16, 0, False)
    with pytest.raises(ValueError, match="float32"):
        ss.ssd_scan(a, k.bfloat16(), v, q)
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan(a, k, v, q, chunk=512)
    k_t = k.transpose(2, 3).contiguous().transpose(2, 3)  # N of stride S
    with pytest.raises(ValueError, match="unit stride"):
        ss.ssd_scan(a, k_t, v, q)
    # any N and P: a state wider than 64 takes the wide route
    before = (ss.launches, ss.bwd_launches)
    a3, k3, v3, q3 = _ssd_inputs(1, 2, 40, 80, 80, 0, False)
    y, fin, states = ss.ssd_scan_fwd(a3, k3, v3, q3, 256, save_states=True)
    ss.ssd_scan_bwd(a3, k3, v3, q3, y, states, fin, None, 256, False)
    assert (ss.launches, ss.bwd_launches) == (before[0] + 1, before[1] + 1)


def test_reduced_zamba2_forward_and_decode_on_card_match_the_cpu(cuda):
    """The forward over 300 positions (a chunk of 256 and a ragged one, so
    the scan carries its state) and six decode steps, card against CPU,
    fp32 weights.  Decode runs with the model's bf16 conv window, logits
    held to 1e-3 (``chip_smoke.ZAMBA_DECODE_TOL``: a window value may round
    a bf16 ulp apart on the two devices and later layers follow it; 2.2e-4
    measured on an H100, 0.70 with a decode kernel that drops the newest
    key), and with the window in fp32 on both sides, where logits, SSM
    state and window are held to 1e-4 (1.2e-5, 6.2e-5 and 3.8e-5
    measured)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    cfg = get_config("zamba2").reduced()
    cpu, gpu = (lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=d, dtype=torch.float32)
                for d in ("cpu", "cuda"))
    toks = torch.randint(0, cfg.vocab_size, (2, 300),
                         generator=torch.Generator().manual_seed(3))
    ops.reset_launch_counts()
    want, _ = lm.forward(cpu, cfg, toks)
    got, _ = lm.forward(gpu, cfg, toks.cuda())
    assert ops.launch_counts()["ssd_scan"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for window, tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-4)):
        caches = {d: lm.init_cache(cfg, 2, 16, device=d)
                  for d in ("cpu", "cuda")}
        for c in caches.values():
            c["mamba"]["conv"] = c["mamba"]["conv"].to(window)
        for i in range(6):
            a = lm.decode_step(cpu, cfg, caches["cpu"], toks[:, i], i)
            b = lm.decode_step(gpu, cfg, caches["cuda"], toks[:, i].cuda(), i)
            torch.testing.assert_close(b.cpu(), a, rtol=tol, atol=tol)
        if window == torch.float32:
            for name in ("conv", "ssm"):
                torch.testing.assert_close(
                    caches["cuda"]["mamba"][name].cpu(),
                    caches["cpu"]["mamba"][name], rtol=tol, atol=tol)


def _knapsack_inputs(kind, n, qcap, seed, width=None):
    """chip_smoke.py's knapsack inputs: "planner" values U(0, 1) over
    16-256 quanta, "ties" integer values and sizes from {1, 2, 3}, "edges"
    small sizes with items past the capacity (up to 2^32 + 3) and of 0,
    "wide" sizes over 1,000 to qcap, "widths" sizes at and around a rank's
    width (W - 1, W, W + 1, 2 W, 2 W + 5, 0, 1 in turn)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "ties":
        values = rng.integers(1, 4, n).astype(np.float64)
        sizes = rng.integers(1, 4, n)
    elif kind == "widths":
        values = rng.uniform(1e-3, 1.0, n)
        cycle = (width - 1, width, width + 1, 2 * width, 2 * width + 5, 0, 1)
        sizes = np.array([cycle[i % 7] for i in range(n)])
    else:
        values = rng.uniform(1e-3, 1.0, n)
        sizes = (rng.integers(16, 257, n) if kind == "planner"
                 else rng.integers(1000, qcap + 1, n) if kind == "wide"
                 else rng.integers(0, max(qcap // 4, 1), n))
    if kind == "edges":
        for i, s in enumerate((qcap + 1, 0, qcap + 2, 10 ** 6, 0,
                               2 ** 31 + 7, 2 ** 32 + 3)):
            sizes[(i * 37 + 3) % n] = s
    return (torch.from_numpy(values).cuda(),
            torch.from_numpy(sizes.astype(np.int64)).cuda())


@pytest.mark.parametrize("kind,n,qcap", [
    ("planner", 489, 16384), ("planner", 300, 16380), ("edges", 300, 1000),
    ("edges", 40, 0), ("edges", 1, 7), ("ties", 2000, 1500),
    ("ties", 1000, 16384)])
@pytest.mark.parametrize("route", [1, 2])
def test_knapsack_dp_kernel_is_the_plain_versions_bytes(cuda, kind, n, qcap,
                                                        route):
    """Both routes, the same bytes as the plain version (the reference's
    DPs' bytes, tests/test_torch_knapsack.py) and as a second call."""
    kdp = importlib.import_module("repro_torch.kernels.knapsack_dp")
    v, s = _knapsack_inputs(kind, n, qcap, n + qcap)
    before = kdp.launches
    keep = kdp.knapsack_dp(v, s, qcap, route=route)
    again = kdp.knapsack_dp(v, s, qcap, route=route)
    torch.cuda.synchronize()
    assert kdp.launches == before + 2
    assert torch.equal(keep, kdp.knapsack_dp_plain(v, s, qcap))
    assert torch.equal(keep, again)


def test_knapsack_dp_route_2_takes_grids_past_shared_memory(cuda):
    """Past route 1's cells (231,936: 16 ranks of 14,496 columns)."""
    kdp = importlib.import_module("repro_torch.kernels.knapsack_dp")
    v, s = _knapsack_inputs("planner", 100, 250_000, 5)
    assert kdp.pick_route(250_000) == 2
    keep = kdp.knapsack_dp(v, s, 250_000)
    assert torch.equal(keep, kdp.knapsack_dp_plain(v, s, 250_000))
    with pytest.raises(RuntimeError, match="route 1"):
        kdp.knapsack_dp(v, s, 250_000, route=1)


@pytest.mark.parametrize("kind,n,qcap", [("ties", 2000, 1500),
                                         ("edges", 300, 1000)])
def test_knapsack_dp_kernel_ignores_stale_shared_memory(cuda, kind, n, qcap):
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    kdp = importlib.import_module("repro_torch.kernels.knapsack_dp")
    v, s = _knapsack_inputs(kind, n, qcap, 7)
    da.fill_shared_memory_nan(v.device)
    keep = kdp.knapsack_dp(v, s, qcap, route=1)
    assert torch.equal(keep, kdp.knapsack_dp_plain(v, s, qcap))


# route 1's cluster at sizes 1 to 16: today's cases (one rank only where
# one rank holds the grid), sizes across ranks, last ranks short or full
_CLUSTER_CASES = [(kind, n, qcap, ranks)
                  for kind, n, qcap in (("planner", 489, 16384),
                                        ("planner", 300, 16380),
                                        ("edges", 300, 1000), ("edges", 40, 0),
                                        ("edges", 1, 7), ("ties", 2000, 1500),
                                        ("ties", 1000, 16384),
                                        ("wide", 300, 16384),
                                        ("widths", 300, 16384),
                                        ("planner", 300, 16383),
                                        ("planner", 300, 16415),
                                        ("wide", 200, 100_000))
                  for ranks in (1, 2, 8, 16)
                  # the ranks' two buffers fit a block (14,496 columns)
                  if ((qcap + ranks) // ranks + 31) // 32 * 32 <= 14_496]


@pytest.mark.parametrize("kind,n,qcap,ranks", _CLUSTER_CASES)
def test_knapsack_dp_cluster_route_is_the_plain_versions_bytes(
        cuda, kind, n, qcap, ranks):
    """The cluster route at ``ranks`` blocks: the plain version's bytes,
    the same bytes from a second call, one launch a call, and the layout
    the kernel computes is ``cluster_plan``'s."""
    kdp = importlib.import_module("repro_torch.kernels.knapsack_dp")
    plan = kdp.cluster_plan(qcap, ranks)
    assert kdp.kernel_layout(qcap, ranks) == plan
    v, s = _knapsack_inputs(kind, n, qcap, n + ranks, width=plan.width)
    before = kdp.launches
    keep = kdp.knapsack_dp(v, s, qcap, route=1, ranks=ranks)
    assert kdp.launches == before + 1
    again = kdp.knapsack_dp(v, s, qcap, route=1, ranks=ranks)
    assert kdp.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(keep, kdp.knapsack_dp_plain(v, s, qcap))
    assert torch.equal(keep, again)


@pytest.mark.parametrize("kind,n,qcap,ranks", [
    ("planner", 2000, 16384, 16), ("wide", 300, 16384, 16),
    ("ties", 2000, 1500, 1), ("edges", 300, 1000, 1)])
def test_knapsack_dp_cluster_route_ignores_stale_shared_memory(
        cuda, kind, n, qcap, ranks):
    """Behind a NaN fill of every SM's shared memory, at 16 ranks and at
    one."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    kdp = importlib.import_module("repro_torch.kernels.knapsack_dp")
    v, s = _knapsack_inputs(kind, n, qcap, 9)
    da.fill_shared_memory_nan(v.device)
    keep = kdp.knapsack_dp(v, s, qcap, route=1, ranks=ranks)
    assert torch.equal(keep, kdp.knapsack_dp_plain(v, s, qcap))


def test_knapsack_dp_chain_floor_launches_and_counts_no_launch(cuda):
    kdp = importlib.import_module("repro_torch.kernels.knapsack_dp")
    before = kdp.launches
    kdp.chain_floor(100, 16384)
    kdp.chain_floor(0, 16384, 2)
    kdp.chain_floor(100, 16384, cluster_barrier=True)
    torch.cuda.synchronize()
    assert kdp.launches == before


def test_planner_with_the_device_dp_on_card_builds_the_numpy_plan(cuda):
    """The 2,000-chunk fixture: the global search's knapsack is 2,000 items
    over 16,384 cells (32.8M), above the threshold."""
    from repro_torch.core import knapsack
    from repro_torch.kernels import ops
    from repro_torch.sim import planner_fixture
    plans = []
    for on in (False, True):
        knapsack.use_device, knapsack.dp_device = on, "cuda"
        ops.reset_launch_counts()
        try:
            fx = planner_fixture.build_chunk_fixture(2000)
            plans.append(planner_fixture.plan_program(
                *fx[:3], 256 * 1024 ** 2).to_json())
        finally:
            knapsack.use_device = False
        assert ops.launch_counts()["knapsack_dp"] == (2 if on else 0)
    assert plans[0] == plans[1]


# ------------------------------------------- the dry run's train and prefill
@pytest.mark.parametrize("B,K,G,S,D", [
    (1, 1, 8, 32768, 256),      # gemma-2b at batch 1
    (1, 32, 1, 32768, 64),      # zamba2-1.2b at batch 1
    (2, 32, 1, 32832, 64)])     # musicgen-large at batch 2, 64 frames
def test_flash_forward_at_the_prefill_length_on_sampled_tiles(cuda, B, K,
                                                               G, S, D):
    """The dry run's prefill_32k attention at the batches the cells run, in
    bf16 with peaked scores (q x 8): the forward kernel against the plain
    version's arithmetic on three 128-row query tiles, the first, one in
    the middle and the last (ragged where S is no multiple of 128), which
    reads every key."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q = _randn((B, K, G, S, D), torch.bfloat16, 40, 8.0)
    k = _randn((B, K, S, D), torch.bfloat16, 41)
    v = _randn((B, K, S, D), torch.bfloat16, 42)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    for r0 in (0, S // 2 // 128 * 128, (S - 1) // 128 * 128):
        r1 = min(r0 + 128, S)
        p_out, p_lse = fa.flash_attention_plain_rows(q, k, v, r0, r1)
        torch.testing.assert_close(out[..., r0:r1, :], p_out,
                                   rtol=TOL[torch.bfloat16],
                                   atol=TOL[torch.bfloat16])
        torch.testing.assert_close(lse[..., r0:r1], p_lse,
                                   rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])


def test_ssd_scan_fwd_over_the_prefill_length(cuda):
    """zamba2-1.2b's prefill_32k at batch 1: the SSD forward over 32,768
    positions (64 heads, N = P = 64, k and q broadcast, decays near 1)
    against its plain version, with and without the chunk states."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    a, k, v, q = _ssd_inputs(1, 64, 32768, 64, 64, 21, True, True)
    y, fin, states = ss.ssd_scan_fwd(a, k, v, q, 256, save_states=True)
    y2, fin2 = ss.ssd_scan_fwd(a, k, v, q, 256)[:2]
    yp, finp, stp = ss._plain_forward(a, k, v, q, 256)
    for got, want in ((y, yp), (fin, finp), (states, stp), (y2, yp),
                      (fin2, finp)):
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


def test_gemma_train_cell_peak_is_within_its_prediction(cuda):
    """The dry run's gemma-2b train_4k cell (offload mode, full width and
    depth), cut to 2 of its fitted microbatches a step: it runs as
    predicted, its measured peak within the prediction and the prediction
    at most 1.25 x it; finite loss."""
    dryrun = importlib.import_module("repro_torch.launch.dryrun")
    r = dryrun.run_cell("gemma-2b", "train_4k", microbatches_run=2,
                        steps=1, probes=False)
    mem = r["memory"]
    assert r["ran"] and r["mode"] == "offload-grads"
    assert r["reduced"] == {"microbatches_run": [r["microbatches"], 2]}
    assert mem["measured_peak_bytes"] <= mem["peak_bytes"] \
        <= 1.25 * mem["measured_peak_bytes"]
    assert r["loss_finite"]


def test_adamw_int8_moments_quantize_to_the_cpus_bits(cuda):
    """The int8 moments' block scales and codes (``optim/adamw.py``
    ``_quant``) are the CPU's bits on the card, over 2^21 elements (8,192
    blocks of 256) of moment-like magnitudes.  The scale written as
    ``amax / 127.0`` fails this: CUDA divides by a host scalar as a product
    with its reciprocal, an ulp off the quotient for some blocks."""
    from repro_torch.optim.adamw import _quant
    g = torch.Generator().manual_seed(21)
    x = torch.randn(1 << 21, generator=g) * torch.exp(
        torch.randn(1 << 21, generator=g) * 4.0)
    q_cpu, s_cpu = _quant(x, 256)
    q_gpu, s_gpu = _quant(x.to(cuda), 256)
    assert torch.equal(_bits(s_gpu.cpu()), _bits(s_cpu))
    assert torch.equal(q_gpu.cpu(), q_cpu)


def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])


# ------------------------------------------------- the distributed layer
@pytest.fixture(scope="module")
def nccl_mesh():
    """A (1, 1) mesh over a world of one NCCL rank, torn down after the
    module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [True, False])
def test_embed_lookup_hinted_route_on_nccl_gives_the_plain_bits(
        nccl_mesh, tied, dtype):
    """Table and tokens as DTensors on the route's specs: the forward is
    the plain gather's bits, and so is the table's gradient for an
    integer-valued output gradient (every sum exact)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import common
    mesh = nccl_mesh
    table = _randn((1000, 64), dtype, 11)
    g = torch.Generator(device="cuda").manual_seed(12)
    tok = torch.randint(0, 1000, (2, 64), generator=g, device="cuda")
    dy = torch.randint(-8, 9, (2, 64, 64), generator=g,
                       device="cuda").to(dtype)
    tspec = (shd.fit(mesh, (1000, 64), "model", None) if tied
             else shd.fit(mesh, (1000, 64), None, "model"))
    td = distribute_tensor(table, mesh,
                           shd.placements(mesh, tspec)).requires_grad_()
    kd = distribute_tensor(tok, mesh, shd.placements(
        mesh, shd.fit(mesh, (2, 64), shd.dp_axes(mesh), None)))
    common.set_mesh_hint(mesh)
    try:
        x = common.embed_lookup(td, kd, tied=tied)
        x.backward(distribute_tensor(dy, mesh, x.placements))
    finally:
        common.set_mesh_hint(None)
    plain = table.clone().requires_grad_()
    px = plain[tok]
    px.backward(dy)
    assert torch.equal(_bits(x.to_local().detach()), _bits(px.detach()))
    assert torch.equal(_bits(td.grad.to_local()), _bits(plain.grad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 12295])
def test_compressed_psum_on_nccl_gives_the_cpu_quantizers_bits(nccl_mesh, n,
                                                               dtype):
    from repro_torch.distributed.grad_compression import (
        compressed_psum, dequantize_int8, quantize_int8)
    x = _randn((n,), dtype, 13, scale=3.0)
    err = _randn((n,), torch.float32, 14, scale=1e-3)
    red, new_err = compressed_psum(x, nccl_mesh.get_group("data"),
                                   error=err)
    q, s = quantize_int8((x + err).cpu())
    sent = dequantize_int8(q, s, (n,))
    assert torch.equal(_bits(red.cpu()), _bits(sent))
    assert torch.equal(_bits(new_err.cpu()), _bits((x + err).cpu() - sent))


def test_elastic_restore_on_nccl_gives_the_saved_bits(nccl_mesh, tmp_path):
    """Reduced gemma-2b's parameters saved, restored onto ``param_specs``'
    shardings (DTensors on the card) and a leaf named by a device."""
    from repro_torch import _tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    params = lm.init_params(get_config("gemma-2b").reduced(),
                            torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "step": torch.tensor(4)}, blocking=True)
    sh = shd.shardings(nccl_mesh, shd.param_specs(nccl_mesh, params))
    _, placed = mgr.restore(shardings={"params": sh,
                                       "step": torch.device("cpu")})
    for got, want in zip(_tree.leaves(placed["params"]),
                         _tree.leaves(params)):
        assert got.to_local().is_cuda
        assert torch.equal(_bits(got.to_local()), _bits(want))
    assert placed["step"].device.type == "cpu" and int(placed["step"]) == 4
