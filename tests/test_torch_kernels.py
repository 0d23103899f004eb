"""The port's kernel entry points on CPU tensors (their plain PyTorch
versions) against the reference package's kernels, at the shapes and
tolerances of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2.

The reference runs as its own tests run it: the Pallas kernel in interpret
mode, or its ``ref.py`` oracle.  Inputs are drawn with numpy and handed to
both frameworks.  The CUDA kernels themselves are held against these plain
versions on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

port_da = importlib.import_module("repro_torch.kernels.decode_attention")
port_mm = importlib.import_module("repro_torch.kernels.tiered_matmul")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(a: np.ndarray, name: str):
    """One numpy draw as a jax array and a torch tensor of one dtype (both
    frameworks round fp32 to bf16 to nearest even)."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def draws(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,length", [(1024, 700), (512, 512), (2048, 1),
                                      (700, 650)])
def test_decode_attention_matches_reference(T, length, dtype):
    B, K, G, D = 2, 2, 4, 128
    qa, ka, va = draws(0, (B, K, G, D), (B, K, T, D), (B, K, T, D))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (qa, ka, va))
    gold = ref_ref.decode_attention_ref(jq, jk, jv, length)
    out = ops.decode_attention(tq, tk, tv, length)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(as_np(out), as_np(gold), **tol(dtype))
    np.testing.assert_allclose(as_np(ref.decode_attention_ref(
        tq, tk, tv, length)), as_np(gold), **tol(dtype))


def test_decode_attention_at_length_zero_follows_the_kernel():
    """At length 0 the TPU kernel returns zeros and the reference oracle
    mean(v); the port's entry point follows the kernel, its oracle the
    oracle."""
    B, K, G, D, T = 1, 1, 2, 128, 512
    qa, ka, va = draws(1, (B, K, G, D), (B, K, T, D), (B, K, T, D))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "float32") for a in (qa, ka, va))
    pallas = ref_ops.decode_attention(jq, jk, jv, 0, force_pallas=True,
                                      interpret=True)
    np.testing.assert_array_equal(as_np(pallas), 0.0)
    np.testing.assert_array_equal(as_np(ops.decode_attention(tq, tk, tv, 0)),
                                  0.0)
    mean_v = np.broadcast_to(va.mean(axis=2, keepdims=True), qa.shape)
    np.testing.assert_allclose(as_np(ref_ref.decode_attention_ref(
        jq, jk, jv, 0)), mean_v, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(as_np(ref.decode_attention_ref(
        tq, tk, tv, 0)), mean_v, rtol=1e-5, atol=1e-5)


def test_decode_attention_matches_the_pallas_kernel_in_interpret_mode():
    B, K, G, D, T, length = 1, 1, 4, 128, 1024, 600
    qa, ka, va = draws(2, (B, K, G, D), (B, K, T, D), (B, K, T, D))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "float32") for a in (qa, ka, va))
    pallas = ref_ops.decode_attention(jq, jk, jv, length, force_pallas=True,
                                      interpret=True)
    np.testing.assert_allclose(as_np(ops.decode_attention(tq, tk, tv,
                                                          length)),
                               as_np(pallas), **tol("float32"))


def test_decode_attention_reads_the_serving_cache_view():
    """The model passes one layer of the (B, S_max, K, D) cache as a
    strided (B, K, S_max, D) view: same answer as a contiguous copy, and
    an fp32 query over a bf16 cache is taken."""
    B, S, K, G, D = 3, 96, 2, 4, 16
    qa, ca, va = draws(3, (B, K, G, D), (B, S, K, D), (B, S, K, D))
    q = torch.from_numpy(qa)
    k = torch.from_numpy(ca).to(torch.bfloat16)
    v = torch.from_numpy(va).to(torch.bfloat16)
    view = ops.decode_attention(q, k.permute(0, 2, 1, 3),
                                v.permute(0, 2, 1, 3), 50)
    dense = ops.decode_attention(q, k.permute(0, 2, 1, 3).contiguous(),
                                 v.permute(0, 2, 1, 3).contiguous(), 50)
    assert view.dtype == torch.float32
    torch.testing.assert_close(view, dense, rtol=0, atol=0)
    jgold = ref_ref.decode_attention_ref(
        jnp.asarray(qa), jnp.asarray(np.transpose(ca, (0, 2, 1, 3)),
                                     jnp.bfloat16),
        jnp.asarray(np.transpose(va, (0, 2, 1, 3)), jnp.bfloat16), 50)
    np.testing.assert_allclose(as_np(view), as_np(jgold), **tol("float32"))


@pytest.mark.parametrize("length", [0, 1, 650])
def test_decode_attention_f64_yardstick_matches_the_kernel(length):
    """The float64 attention the card checks hold the kernel against:
    within fp32 rounding of the Pallas kernel (interpret mode), zeros at
    length 0 as the kernel gives, float64 out."""
    B, K, G, D, T = 2, 2, 4, 96, 700
    qa, ka, va = draws(6, (B, K, G, D), (B, K, T, D), (B, K, T, D))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "float32") for a in (qa, ka, va))
    pallas = ref_ops.decode_attention(jq, jk, jv, length, force_pallas=True,
                                      interpret=True)
    out = ref.decode_attention_f64(tq, tk, tv, length)
    assert out.dtype == torch.float64 and out.shape == tq.shape
    np.testing.assert_allclose(out.numpy(), as_np(pallas),
                               **tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,Kd,N", [(256, 512, 256), (300, 700, 500),
                                    (128, 128, 128), (4, 96, 40), (1, 3, 5)])
def test_tiered_matmul_matches_reference(M, Kd, N, dtype):
    xa, wa = draws(4, (M, Kd), (Kd, N), scale=0.1)
    (jx, tx), (jw, tw) = both(xa, dtype), both(wa, dtype)
    out = ops.tiered_matmul(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (M, N)
    gold = ref_ref.tiered_matmul_ref(jx, jw)
    np.testing.assert_allclose(as_np(out), as_np(gold), **tol(dtype))


def test_tiered_matmul_matches_the_pallas_kernel_in_interpret_mode():
    xa, wa = draws(5, (300, 700), (700, 500), scale=0.1)
    (jx, tx), (jw, tw) = both(xa, "float32"), both(wa, "float32")
    pallas = ref_ops.tiered_matmul(jx, jw, force_pallas=True, interpret=True)
    np.testing.assert_allclose(as_np(ops.tiered_matmul(tx, tw)),
                               as_np(pallas), **tol("float32"))


@pytest.mark.parametrize("batch_heads,length", [
    (4, 0), (4, 1), (4, 160), (4, 1024), (8, 700), (1, 5000), (2, 33)])
def test_decode_split_covers_the_valid_rows_exactly(batch_heads, length):
    for heads, D, elsize in ((1, 64, 2), (2, 256, 2), (8, 128, 4)):
        n_split, rows = port_da._split_rows(batch_heads, heads, D, elsize,
                                            length)
        # the splits of one (b, k) form one cluster of at most 8 blocks
        assert 1 <= n_split <= port_da._MAX_SPLIT and rows >= 1
        assert n_split * rows >= length
        assert length == 0 or (n_split - 1) * rows < length  # no empty split


# the serving paths' products at M = 4: gemma-2b's wq/wo, wk/wv, w_gate/
# w_up and w_down, zamba2-1.2b's in_proj and out_proj
MATMUL_PATH_SHAPES = [(4, 2048, 2048), (4, 256, 2048), (4, 16384, 2048),
                      (4, 2048, 16384), (4, 8384, 2048), (4, 2048, 4096)]


@pytest.mark.parametrize("M,N,K", MATMUL_PATH_SHAPES)
def test_matmul_plan_covers_k_exactly_in_one_wave(M, N, K):
    """The "mma" route's plan on a 132-SM H100: the K splits are whole
    64-row stages that cover K with none empty, one cluster of at most 8
    blocks a 128-column tile, and the grid fits one wave of the blocks the
    SMs hold (no partial wave), with a block for 95 % of the SMs or as
    many blocks as 8 splits allow."""
    n_split, k_chunk = port_mm.plan(M, N, K, "mma", 132)
    assert 1 <= n_split <= 8
    assert k_chunk % 64 == 0 and n_split * k_chunk >= K
    assert (n_split - 1) * k_chunk < K                    # no empty split
    tiles = -(-N // 128) * -(-M // 8)
    assert tiles * n_split <= 132 * port_mm.blocks_per_sm()
    assert tiles * n_split >= min(0.95 * 132, tiles * 8)


@pytest.mark.parametrize("M,N,K", [(300, 500, 700), (1, 5, 3), (5, 13, 100),
                                   (4, 2048, 16384)])
def test_matmul_ffma_plan_covers_k_exactly(M, N, K):
    n_split, k_chunk = port_mm.plan(M, N, K, "ffma", 132)
    assert 1 <= n_split <= 8 and k_chunk % 8 == 0
    assert n_split * k_chunk >= K and (n_split - 1) * k_chunk < K


def test_matmul_route_takes_tma_shapes_to_the_tensor_cores():
    """bf16 with N a multiple of 8 and w 16-byte aligned goes to the "mma"
    kernel (every serving shape); fp32, N not a multiple of 8, or a w
    whose address TMA cannot take, to the "ffma" kernel.  Two "mma"
    blocks fit an SM's shared memory."""
    bf = torch.bfloat16
    x = torch.zeros(4, 64, dtype=bf)
    assert port_mm.route(x, torch.zeros(64, 8384, dtype=bf)) == "mma"
    assert port_mm.route(x, torch.zeros(64, 264, dtype=bf)) == "mma"
    assert port_mm.route(x.float(), torch.zeros(64, 2048)) == "ffma"
    assert port_mm.route(x, torch.zeros(64, 500, dtype=bf)) == "ffma"
    assert port_mm.route(x, torch.zeros(64, 13, dtype=bf)) == "ffma"
    w = torch.zeros(64 * 2048 + 8, dtype=bf)
    assert port_mm.route(x, w[8:].view(64, 2048)) == "mma"
    assert port_mm.route(x, w[1:1 + 64 * 2048].view(64, 2048)) == "ffma"
    assert port_mm.blocks_per_sm() == 2


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.tiered_matmul(x, torch.zeros(7, 3))
    with pytest.raises(TypeError):
        ops.tiered_matmul(x, torch.zeros(8, 3, dtype=torch.bfloat16))
    q = torch.zeros(1, 1, 2, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 8, 16)
    with pytest.raises(TypeError):          # bf16 q over an fp32 cache
        ops.decode_attention(q, kv, kv, 4)
    with pytest.raises(ValueError):
        ops.decode_attention(q.float(), kv, kv, 9)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version:
    off the CPU the wrapper launches its kernel or raises."""
    before = ops.launch_counts()
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.tiered_matmul(x, torch.empty(8, 3, device="meta"))
    q = torch.empty(1, 1, 2, 16, device="meta")
    kv = torch.empty(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(q, kv, kv, 4)
    assert ops.launch_counts() == before
