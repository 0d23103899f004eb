"""The port's fp8 (e4m3) KV cache against the reference, on the CPU.

* The conversion (``models/common.kv_cast``) against JAX's
  ``astype(float8_e4m3fn)``: the same bits in range, from fp32 and from
  bf16.  Out of range the two differ on purpose (ROADMAP P12): the port
  saturates to +-448, the reference gives NaN past +-464 and at +-inf.
* The plain e4m3 decode (what the wrapper runs on a CPU tensor) against the
  reference's Pallas kernel in interpret mode, which takes e4m3 K and V,
  at the reference tests' tolerances: fp32 2e-5, bf16 2e-2.
* ``decode_step`` of reduced gemma-2b, chatglm3-6b at its real G 16 and
  zamba2-1.2b with an e4m3 cache, several tokens, against the reference's.
  Each step starts both packages from the reference's cache bytes.  With
  fp32 weights the port's write of the new row must give the reference's
  bytes, except where the two packages' fp32 keys or values (~1e-6 apart:
  another summation order) straddle an e4m3 rounding boundary: such an
  entry rounds one e4m3 step apart (1/8 of the value), which moves the
  logits by ~1e-2, so the entries are counted (at most 4), each must be
  one step apart with the port's value within 2^-14 of a rounding
  midpoint.  With bf16 weights the two packages' bf16 keys differ in
  ~14% of entries (as with a bf16 cache, by up to ~0.02 near zero: bf16
  sums in another order), so their rows are not compared.  Every step's
  logits are held at MODEL_TOL (1e-5; 3e-2 and 2^-8 of the value, the
  logits' own bf16 rounding, with bf16 weights) with the reference's new
  row in the cache, the port reading the reference's bytes; an fp32 step
  with no straddle is held there with the port's own row too.
* The wrapper refuses an e4m3 cache the kernel cannot read.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models.common import E4M3, kv_cast  # noqa: E402
from _torch_models import reduced_case  # noqa: E402

port_da = importlib.import_module("repro_torch.kernels.decode_attention")

F8 = jnp.float8_e4m3fn
#: the logits against the reference's: fp32 weights 1e-5 (as
#: tests/test_torch_train.py); bf16 weights 3e-2: chatglm3-6b at G 16 lies
#: 0.022 from the reference reading the same cache bytes (bf16 sums over 16
#: heads in another order; 0.0195 with a bf16 cache), gemma-2b and zamba2
#: under 2e-2
MODEL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: relative tolerance of the logits besides MODEL_TOL: with bf16 weights
#: each side rounds its logits (up to ~3) to bf16, 2^-8 of the value
LOGIT_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
#: e4m3 values in range whose conversions the test pins: the largest
#: finite, the smallest normal and subnormal, and ties between neighbours
EDGES = [0.0, -0.0, 448.0, -448.0, 447.9, 2.0 ** -6, 2.0 ** -9, 2.0 ** -10,
         3 * 2.0 ** -11, 1.0625, 1.1875, 0.0009765625, 240.0, 232.0]


def _bits_jax(x: np.ndarray, dtype) -> np.ndarray:
    return np.asarray(jnp.asarray(x, dtype).astype(F8)).view(np.uint8)


def _bits_port(x: torch.Tensor) -> np.ndarray:
    return kv_cast(x, E4M3).view(torch.uint8).numpy()


@pytest.mark.parametrize("source", ["float32", "bfloat16"])
def test_kv_cast_gives_the_reference_bits_in_range(source):
    x = (np.random.default_rng(0).standard_normal(100_000) * 3.0).astype(
        np.float32)
    x = np.concatenate([x, np.asarray(EDGES, np.float32)])
    t = torch.from_numpy(x)
    if source == "bfloat16":
        t = t.bfloat16()
        # both frameworks round fp32 to bf16 to nearest even
        np.testing.assert_array_equal(
            t.float().numpy(),
            np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(_bits_port(t),
                                  _bits_jax(x, getattr(jnp, source)))


def test_kv_cast_saturates_where_the_reference_gives_nan():
    """P12: past +-448 the port stores +-448 (NaN stays NaN); the reference
    rounds up to 464 to 448 (464 is a tie, to even) and gives NaN past it
    and at +-inf."""
    x = np.asarray([448.5, 463.9, 464.0, 464.5, 480.0, 1e4, np.inf, -470.0,
                    -np.inf, np.nan], np.float32)
    port = kv_cast(torch.from_numpy(x), E4M3).float().numpy()
    np.testing.assert_array_equal(
        port, [448, 448, 448, 448, 448, 448, 448, -448, -448, np.nan])
    ref = np.asarray(jnp.asarray(x).astype(F8), np.float32)
    np.testing.assert_array_equal(
        ref, [448, 448, 448, np.nan, np.nan, np.nan, np.nan, np.nan, np.nan,
              np.nan])
    # both decode the NaN encoding to NaN
    nan_bits = np.asarray([0x7F, 0xFF], np.uint8)
    assert torch.from_numpy(nan_bits).view(E4M3).float().isnan().all()
    assert np.isnan(nan_bits.view(ml_dtypes.float8_e4m3fn)
                    .astype(np.float32)).all()


def _e4m3_cache(rng, shape):
    """An e4m3 cache drawn from N(0, 1), as numpy bits."""
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [0, 1, 97, 256])
def test_plain_e4m3_decode_matches_the_pallas_kernel(length, dtype):
    """The reference's Pallas kernel (interpret mode) takes e4m3 K and V
    and casts them to fp32; the port's plain version dequantizes with
    ``.float()``.  Length 0 gives zeros in both (P1), 97 is ragged against
    the kernel's 64-row tiles, 256 is the whole cache."""
    B, K, G, D, T = 2, 2, 4, 64, 256
    rng = np.random.default_rng(length)
    qa = rng.standard_normal((B, K, G, D)).astype(np.float32)
    kb, vb = _e4m3_cache(rng, (B, K, T, D)), _e4m3_cache(rng, (B, K, T, D))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jk, jv = (jnp.asarray(b.view(ml_dtypes.float8_e4m3fn)) for b in (kb, vb))
    tk, tv = (torch.from_numpy(b).view(E4M3) for b in (kb, vb))
    pallas = ref_ops.decode_attention(jnp.asarray(qa, jd), jk, jv, length,
                                      bk=64, force_pallas=True,
                                      interpret=True)
    out = ops.decode_attention(torch.from_numpy(qa).to(td), tk, tv, length)
    assert out.dtype == td and out.shape == (B, K, G, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=KERNEL_TOL[dtype],
                               atol=KERNEL_TOL[dtype])


def test_plain_e4m3_decode_reads_the_nan_encoding_as_nan():
    """A NaN in a valid row makes its (b, k)'s outputs NaN, in the
    reference's kernel and in the port; a NaN past ``length`` is never
    read."""
    B, K, G, D, T, length = 2, 1, 2, 32, 128, 100
    rng = np.random.default_rng(5)
    qa = rng.standard_normal((B, K, G, D)).astype(np.float32)
    kb, vb = _e4m3_cache(rng, (B, K, T, D)), _e4m3_cache(rng, (B, K, T, D))
    kb[0, 0, 40, 3] = 0x7F                     # inside the valid rows
    kb[1, 0, length + 5, 0] = 0xFF             # past them
    jk, jv = (jnp.asarray(b.view(ml_dtypes.float8_e4m3fn)) for b in (kb, vb))
    pallas = np.asarray(ref_ops.decode_attention(
        jnp.asarray(qa), jk, jv, length, bk=64, force_pallas=True,
        interpret=True))
    out = ops.decode_attention(torch.from_numpy(qa),
                               torch.from_numpy(kb).view(E4M3),
                               torch.from_numpy(vb).view(E4M3),
                               length).numpy()
    assert np.isnan(out[0]).all() and np.isnan(pallas[0]).all()
    assert np.isfinite(out[1]).all()
    np.testing.assert_allclose(out[1], pallas[1], rtol=2e-5, atol=2e-5)


def test_wrapper_refuses_an_e4m3_cache_it_cannot_read():
    """The kernel reads K and V rows in 16-byte pieces, 16 e4m3 values
    each: D, the strides and the address must be multiples of 16
    elements.  (The checks run before a launch, so the CPU can call
    them.)"""
    q = torch.zeros((1, 1, 4, 24))
    k = torch.zeros((1, 1, 64, 24), dtype=E4M3)
    with pytest.raises(ValueError, match="multiples of 16 elements"):
        port_da._check_cuda(q, k, k)
    q = torch.zeros((1, 1, 4, 32))
    k = torch.zeros((1, 1, 64, 32), dtype=E4M3)
    port_da._check_cuda(q, k, k)               # D 32: two pieces a row
    with pytest.raises(ValueError, match="multiples of 16 elements"):
        port_da._check_cuda(q, k[..., 8:], k[..., 8:])   # misaligned rows
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        ops.decode_attention(q.to(E4M3), k, k, 1)       # q stays wider


@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_e4m3_route_takes_at_most_four_heads_a_block(G):
    """Over an e4m3 cache one block takes all G <= 16 heads of its KV head
    (8 or 16 head slots; the name is the old rule's, at most 4), so each K
    and V row of a (b, k) pair is read by one block of each split; the
    bf16 route keeps its 1-8.  The splits
    cover the valid rows with none empty, one split a 64 rows up to 8:
    the main path's 32,768 rows take 8 splits of 4,096."""
    heads = port_da._heads_per_block(G, 1)
    assert heads >= G and heads == (8 if G <= 8 else 16)
    assert -(-G // heads) == 1
    assert port_da._heads_per_block(G, 2) == min(8, 1 << (G - 1).bit_length())
    for length, want in ((1, (1, 1)), (160, (3, 54)), (32768, (8, 4096))):
        n, rows = port_da._split_rows(128, heads, 256, 1, length)
        assert (n, rows) == want
        assert 1 <= n <= 8 and n * rows >= length > (n - 1) * rows


def test_every_e4m3_code_round_trips_through_fp16():
    """The route's premise: fp16 holds every e4m3 value exactly (4
    significant bits, magnitudes 2^-9 to 448), so e4m3 -> fp32 -> fp16 ->
    fp32 is e4m3 -> fp32 for all 256 codes, NaN to NaN, +-0 kept."""
    codes = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(E4M3)
    wide = codes.float()
    back = wide.half().float()
    nan = wide.isnan()
    assert torch.equal(nan, back.isnan())
    assert nan.sum() == 2 and torch.equal(
        nan.nonzero().flatten(), torch.tensor([0x7F, 0xFF]))
    assert torch.equal(back[~nan], wide[~nan])
    assert torch.equal(torch.signbit(back), torch.signbit(wide))
    assert wide[~nan].abs().max() == 448.0
    assert wide[~nan].abs()[wide[~nan] != 0].min() == 2.0 ** -9


# ------------------------------------------------------------ decode_step
DECODE_CASES = ["gemma-2b", "chatglm3-6b-g16", "zamba2"]


def _config(case: str):
    if case == "zamba2":
        return get_config("zamba2").reduced()
    return reduced_case(case)


def _to_port(jc) -> dict:
    """The reference's cache as the port's tensors (e4m3 by its bits)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.float8_e4m3fn:
            return torch.from_numpy(a.view(np.uint8).copy()).view(E4M3)
        return params_from_numpy(a, "cpu")
    return jax.tree_util.tree_map(one, jax.device_get(jc))


def _clone(tree):
    leaves, treedef = _tree.flatten(tree)
    return _tree.unflatten(treedef, [t.clone() for t in leaves])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _e4m3_grid() -> np.ndarray:
    """Every finite e4m3 value, ascending (-0 and +0 as one)."""
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    grid = grid.astype(np.float32)
    return np.unique(grid[np.isfinite(grid)])


GRID = _e4m3_grid()


def _midpoint_distance(x: np.ndarray) -> np.ndarray:
    """Relative distance of each value to the nearest midpoint between two
    neighbouring e4m3 values (in range)."""
    mids = (GRID[1:] + GRID[:-1]) / 2
    i = np.clip(np.searchsorted(mids, x), 1, len(mids) - 1)
    d = np.minimum(np.abs(x - mids[i - 1]), np.abs(x - mids[i]))
    return d / np.maximum(np.abs(x), 2.0 ** -9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_e4m3_decode_step_matches_reference(case, dtype, monkeypatch):
    cfg = _config(case)
    jd = getattr(jnp, dtype)
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jd)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    B, S, steps = 2, 16, 6
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, steps))
    jc = ref_lm.init_cache(cfg, B, S, kv_dtype=F8)
    tc = port_lm.init_cache(cfg, B, S, device="cpu", kv_dtype=E4M3)
    assert tc["k"].dtype == E4M3 and tc["k"].shape == jc["k"].shape
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, cfg, c, t, pos))
    real_cast = port_attention.kv_cast
    apart_entries = 0
    for i in range(steps):
        tok = torch.from_numpy(toks[:, i])
        start = _to_port(jc)
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i], jnp.int32),
                      jnp.int32(i))
        want, gold = _to_port(jc), np.asarray(jl, np.float32)
        # the port's own step from the reference's cache, its keys and
        # values captured before the cast
        written = []
        monkeypatch.setattr(port_attention, "kv_cast", lambda x, dt: (
            written.append(x.float().numpy()), real_cast(x, dt))[1])
        tc = _clone(start)
        own = port_lm.decode_step(tp, cfg, tc, tok, i)
        step_apart = 0
        for name in ("k", "v"):
            got, ref = _bits(tc[name]), _bits(want[name])
            if dtype == "bfloat16":
                continue
            apart = np.argwhere(got != ref)
            assert (apart[:, 2] == i).all(), "only the new row is written"
            step_apart += len(apart)
            for app, b, _, kh, d in apart:
                a, r = (np.float32(t[name][app, b, i, kh, d].float())
                        for t in (tc, want))
                # neighbouring e4m3 values: one rounding step apart
                assert abs(int(np.searchsorted(GRID, a))
                           - int(np.searchsorted(GRID, r))) == 1, (a, r)
                # the port's value at a rounding midpoint
                pre = written[2 * app + (name == "v")][b, kh, d]
                assert _midpoint_distance(np.float32(pre)) < 2.0 ** -14
        apart_entries += step_apart
        if dtype == "float32" and not step_apart:
            np.testing.assert_allclose(own.float().numpy(), gold, rtol=0,
                                       atol=MODEL_TOL[dtype])
        # the port's step reading exactly the reference's bytes: the new
        # row as the reference rounded it
        rows = iter(want[n][app][:, i] for app in range(want["k"].shape[0])
                    for n in ("k", "v"))
        monkeypatch.setattr(port_attention, "kv_cast",
                            lambda x, dt: next(rows))
        tc = _clone(start)
        logits = port_lm.decode_step(tp, cfg, tc, tok, i)
        np.testing.assert_allclose(logits.float().numpy(), gold,
                                   rtol=LOGIT_RTOL[dtype],
                                   atol=MODEL_TOL[dtype])
        for name in ("k", "v"):
            np.testing.assert_array_equal(_bits(tc[name]), _bits(want[name]))
        monkeypatch.setattr(port_attention, "kv_cast", real_cast)
    if dtype == "float32":
        # straddles are rare: a handful of 2 x steps x B x K x D entries
        assert apart_entries <= 4, apart_entries
