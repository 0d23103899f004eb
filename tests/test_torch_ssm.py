"""The port's SSD scan and zamba2 (Mamba-2 + shared attention) against the
reference, on the CPU at small sizes: the scan and its gradient, the
port's ``chunked_linear_scan``, the Mamba-2 block's forward and decode,
the hybrid ``lm.forward`` / ``loss_fn`` / ``decode_step`` with every
gradient and cache, a training step, the runtime's leaf spans, and the
launchers.

Inputs are drawn with numpy and handed to both packages; the reference's
parameters and optimizer state are carried across with
``repro_torch.convert``.  The reference runs as its own tests run it: the
Pallas kernel in interpret mode, its ``ref.py`` oracle, or the pure-JAX
model code.  On CPU tensors the port's wrappers run their plain versions;
the CUDA kernels are held against those on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances, each with its reason:
- the scan, its gradient and ``chunked_linear_scan``: the reference's SSD
  tolerance, 1e-4 (``tests/test_kernels.py``); both sides compute in fp32
  and differ in summation order only (observed below 2e-5).  The gradient
  of the decays is compared as d(log a) = da * a: da carries a 1/a factor,
  and at a decay near 1e-37 both packages' da is rounding noise of an O(1)
  sum divided by 1e-37.
- the Mamba-2 block, model logits, loss and gradients with fp32
  parameters: 1e-5 absolute and relative -- fp32 summation order (observed
  about 1e-6).
- a training step's parameters: 2 * lr absolute -- Adam's first update is
  +-lr per element (see ``test_torch_train.py``).
"""

import importlib
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
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mamba2 as ref_mamba  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt_state  # noqa: E402
from repro.optim import opt_state_bytes as ref_opt_state_bytes  # noqa: E402
from repro.train.step import build_train_step as ref_build_train_step  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import mamba2 as port_mamba  # noqa: E402
from repro_torch.optim import (AdamWConfig, init_opt_state,  # noqa: E402
                               opt_state_bytes)
from repro_torch.train.step import build_train_step  # noqa: E402

port_ss = importlib.import_module("repro_torch.kernels.ssd_scan")

SSD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def scan_inputs(seed, B, H, S, N, P, near_one=False):
    """a in (0, 1) (a sigmoid, as the reference test) or, with
    ``near_one``, exp(-U(1e-3, 0.02)) as real Mamba-2 heads, where the
    state carried across chunks and the far terms of a chunk keep weight
    (with a sigmoid they reach y scaled by e^-50 or less); k, v, q * 0.3."""
    rng = np.random.default_rng(seed)
    if near_one:
        a = np.exp(-rng.uniform(1e-3, 0.02, (B, H, S))).astype(np.float32)
    else:
        a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, S))))).astype(
            np.float32)
    k, v, q = ((rng.standard_normal(s) * 0.3).astype(np.float32)
               for s in ((B, H, S, N), (B, H, S, P), (B, H, S, N)))
    return a, k, v, q


def jax_leaf_paths(tree):
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------ (a) the scan
REF_SHAPES = [(512, 64, 64, 256), (300, 32, 64, 128), (256, 16, 16, 256)]


@pytest.mark.parametrize("S,N,P,chunk", REF_SHAPES)
def test_ssd_plain_matches_pallas_kernel_and_oracle(S, N, P, chunk,
                                                    near_one=False):
    arrays = scan_inputs(0, 2, 3, S, N, P, near_one)
    jx = [jnp.asarray(x) for x in arrays]
    tx = [torch.from_numpy(x) for x in arrays]
    gold = ref_ops.ssd_scan(*jx, chunk=chunk, force_pallas=True,
                            interpret=True)
    oracle = ref_ref.ssd_scan_ref(*jx)
    y, final = port_ss.ssd_scan_plain(*tx, chunk=chunk)
    assert y.dtype == torch.float32 and final.shape == (2, 3, N, P)
    np.testing.assert_allclose(as_np(y), as_np(gold), **SSD_TOL)
    np.testing.assert_allclose(as_np(y), as_np(oracle), **SSD_TOL)
    np.testing.assert_allclose(as_np(ref.ssd_scan_ref(*tx)), as_np(oracle),
                               **SSD_TOL)
    # the entry point (no padding: the ragged chunk is masked) agrees; the
    # CPU's matrix products may round a last bit apart from call to call
    y2, final2 = ops.ssd_scan(*tx, chunk=chunk)
    torch.testing.assert_close(y2, y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(final2, final, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,N,P,chunk", REF_SHAPES)
def test_ssd_plain_matches_pallas_kernel_with_decays_near_one(S, N, P,
                                                              chunk):
    test_ssd_plain_matches_pallas_kernel_and_oracle(S, N, P, chunk, True)


# ------------------------------------------------------- (b) the gradient
def _ref_scan_loss(chunk, dy, dfin):
    """sum(y * dy) + sum(final * dfin) through the reference's
    ``chunked_linear_scan``, inputs in the (B, H, S, .) layout."""
    def f(a, k, v, q, s0):
        tr = lambda x: jnp.moveaxis(x, 1, 2)         # noqa: E731
        y, fin = ref_mamba.chunked_linear_scan(tr(a), tr(k), tr(v), tr(q),
                                               chunk=chunk, initial_state=s0)
        return jnp.sum(y * tr(jnp.asarray(dy))) + jnp.sum(fin * dfin)
    return f


def _compare_grads(got, want, a):
    for name, g, w in zip(("da", "dk", "dv", "dq", "d_initial"), got, want):
        g, w = as_np(g), as_np(w)
        if name == "da":                     # d log a = da * a
            g, w = g * a, w * a
        np.testing.assert_allclose(g, w, **SSD_TOL, err_msg=name)


@pytest.mark.parametrize("S,chunk,tiny", [
    (64, 16, None),            # whole chunks
    (37, 16, None),            # ragged last chunk
    (37, 16, 2e-37),           # a decay near the clamp, at a chunk start
    (37, 16, 1e-38),           # below the clamp: log a is clamped, da = 0
    (20, 256, None)])          # one chunk shorter than `chunk`
def test_ssd_gradient_matches_jax_grad(S, chunk, tiny, near_one=False):
    B, H, N, P = 2, 3, 8, 6
    a, k, v, q = scan_inputs(1, B, H, S, N, P, near_one)
    if tiny is not None:
        a[..., 16] = tiny
    rng = np.random.default_rng(9)
    s0, dfin = ((rng.standard_normal((B, H, N, P)) * 0.3).astype(np.float32)
                for _ in range(2))
    dy = rng.standard_normal((B, H, S, P)).astype(np.float32)
    gold = jax.grad(_ref_scan_loss(chunk, dy, dfin), argnums=range(5))(
        *(jnp.asarray(x) for x in (a, k, v, q, s0)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (a, k, v, q, s0)]
    y, fin = ops.ssd_scan(*leaves[:4], chunk=chunk, initial_state=leaves[4])
    loss = (y * torch.from_numpy(dy)).sum() + (fin * torch.from_numpy(dfin)).sum()
    got = torch.autograd.grad(loss, leaves)
    _compare_grads(got, gold, a)
    if tiny == 1e-38:
        assert float(got[0][..., 16].abs().max()) == 0.0
    assert ops.launch_counts()["ssd_scan_bwd"] == 0       # CPU: no kernel


@pytest.mark.parametrize("S,chunk", [(64, 16), (37, 16), (300, 64)])
def test_ssd_gradient_matches_jax_grad_with_decays_near_one(S, chunk):
    test_ssd_gradient_matches_jax_grad(S, chunk, None, True)


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``: swapped in for
    the reference module's ``jnp`` for one call, it runs the reference's
    own ``chunked_linear_scan`` (which casts its inputs to float32) in
    float64.  The reference's files stay as they are."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _ref_dloga(monkeypatch, arrays, chunk, dy, dfin, wide: bool):
    """d(log a) = da * a of the reference's ``chunked_linear_scan`` for the
    loss sum(y * dy) + sum(final * dfin), in its own fp32 arithmetic or,
    with ``wide``, in float64 (inside ``jax.enable_x64`` only)."""
    a, k, v, q, s0 = arrays
    if not wide:
        grad = jax.grad(_ref_scan_loss(chunk, dy, dfin))(
            *(jnp.asarray(x) for x in (a, k, v, q, s0)))
        return np.asarray(grad, np.float64) * a
    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(ref_mamba, "jnp", _Wide())
        wide_in = [x.astype(np.float64) for x in (a, k, v, q, s0, dy, dfin)]
        grad = jax.grad(_ref_scan_loss(chunk, *wide_in[5:]))(
            *(jnp.asarray(x) for x in wide_in[:5]))
        assert grad.dtype == jnp.float64
        return np.asarray(grad) * wide_in[0]


def _near_one_case(seed=11):
    """S 1024 (four chunks of 256), H 4, N = P = 64, decays near 1, an
    initial state and a final-state gradient; ``scan_inputs(seed)``, the
    rest from ``default_rng(seed + 1)``."""
    B, H, S, N, P = 1, 4, 1024, 64, 64
    a, k, v, q = scan_inputs(seed, B, H, S, N, P, near_one=True)
    rng = np.random.default_rng(seed + 1)
    s0 = (rng.standard_normal((B, H, N, P)) * 0.3).astype(np.float32)
    dfin = rng.standard_normal((B, H, N, P)).astype(np.float32)
    dy = rng.standard_normal((B, H, S, P)).astype(np.float32)
    return (a, k, v, q, s0), dy, dfin


def test_ssd_plain_dloga_near_one_matches_the_reference_float64_gradient(
        monkeypatch):
    """With decays near 1, d(log a) sums terms up to a few hundred that
    cancel to a few hundredths.  The port's plain version differentiated by
    autograd -- the reference's arithmetic in fp32, the yardstick of the
    SSD backward kernel on the card (``chip_smoke.py``) -- meets
    allclose(1e-4) against the reference's gradient computed in float64
    (0.36 of the bound here, on the CPU)."""
    arrays, dy, dfin = _near_one_case()
    gold = _ref_dloga(monkeypatch, arrays, 256, dy, dfin, wide=True)
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    y, fin, _ = port_ss._plain_forward(*leaves[:4], 256, leaves[4])
    loss = ((y * torch.from_numpy(dy)).sum()
            + (fin * torch.from_numpy(dfin)).sum())
    da = torch.autograd.grad(loss, leaves[0])[0]
    got = da.double().numpy() * arrays[0]
    assert np.abs(gold).max() > 10.0            # large terms, cancelling
    np.testing.assert_allclose(got, gold, **SSD_TOL)


def test_reference_fp32_dloga_near_one_lies_within_1e4_of_its_float64(
        monkeypatch):
    """The reference's own fp32 d(log a) against the same computation in
    float64, on the inputs above: measurably apart (9.8e-5 at most, where
    |d(log a)| reaches 245: fp32 rounding of terms in the hundreds), and
    inside allclose(1e-4), at 0.48 of the bound -- so 1e-4 against float64
    is a bar the reference's arithmetic meets, with no room to spare."""
    arrays, dy, dfin = _near_one_case()
    gold = _ref_dloga(monkeypatch, arrays, 256, dy, dfin, wide=True)
    ref32 = _ref_dloga(monkeypatch, arrays, 256, dy, dfin, wide=False)
    assert np.abs(ref32 - gold).max() > 1e-6
    np.testing.assert_allclose(ref32, gold, **SSD_TOL)


@pytest.mark.parametrize("seed", range(11, 19))
def test_ssd_backward_dloga_near_one_meets_the_reference_float64_gradient(
        monkeypatch, seed):
    """The port's CPU training path -- ``ssd_scan`` differentiated through
    ``SSDScan``, which runs ``ssd_scan_bwd_plain`` -- gives d(log a) within
    allclose(1e-4) of the reference's gradient computed in float64, at
    every seed: no less precise than the reference's own fp32 arithmetic,
    which meets it (``test_reference_fp32_dloga_...`` above).  Formed from
    q . dq - k . dk in fp32 it missed at seed 15 (1.19 of the bound) and
    used over 0.8 of it at five other seeds."""
    arrays, dy, dfin = _near_one_case(seed)
    gold = _ref_dloga(monkeypatch, arrays, 256, dy, dfin, wide=True)
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    y, fin = ops.ssd_scan(*leaves[:4], chunk=256, initial_state=leaves[4])
    loss = ((y * torch.from_numpy(dy)).sum()
            + (fin * torch.from_numpy(dfin)).sum())
    da = torch.autograd.grad(loss, leaves[0])[0]
    got = da.double().numpy() * arrays[0]
    assert np.abs(gold).max() > 10.0            # large terms, cancelling
    np.testing.assert_allclose(got, gold, **SSD_TOL)
    assert ops.launch_counts()["ssd_scan_bwd"] == 0       # CPU: no kernel


def test_ssd_bwd_plain_equals_autograd_through_the_plain_forward():
    a, k, v, q = scan_inputs(2, 1, 2, 45, 8, 8)
    t = [torch.from_numpy(x).requires_grad_() for x in (a, k, v, q)]
    s0 = torch.randn(1, 2, 8, 8, generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    dy = torch.randn(1, 2, 45, 8, generator=torch.Generator().manual_seed(1))
    y, fin, states = port_ss._plain_forward(*t, 16, s0)
    want = torch.autograd.grad((y * dy).sum() + fin.sum(), t + [s0])
    got = port_ss.ssd_scan_bwd_plain(*[x.detach() for x in t], dy,
                                     states.detach(), fin.detach(),
                                     torch.ones_like(fin), 16, True)
    _compare_grads(got, want, a)


@pytest.mark.parametrize("S,chunk", [(300, 128), (100, 256), (256, 64)])
@pytest.mark.parametrize("with_final", [False, True])
def test_ssd_exit_grads_from_chunk_sums_equal_the_serial_carry(S, chunk,
                                                               with_final):
    """``_exit_grads`` forms every chunk's exit-state gradient from the
    chunk sums U_c and the scan over chunks, as the kernel does: in float64
    it equals, to 1e-12, the gradient carried position by position, G <-
    a_t (G + q_t dy_t^T), read at each chunk's last position (before its
    own output) and after the first position (d_initial).  A ragged last
    chunk, one chunk, and chunks of 64; with and without d(final state)."""
    B, H, N, P = 2, 3, 8, 6
    a, k, v, q = (torch.from_numpy(x).double()
                  for x in scan_inputs(5, B, H, S, N, P, near_one=True))
    rng = np.random.default_rng(6)
    dy = torch.from_numpy(rng.standard_normal((B, H, S, P)))
    dfin = torch.from_numpy(rng.standard_normal((B, H, N, P)))
    exits, d_init = port_ss._exit_grads(
        torch.log(a), q, dy, dfin if with_final else None, chunk)
    G = dfin.clone() if with_final else torch.zeros(B, H, N, P,
                                                    dtype=torch.float64)
    want = {}
    for t in reversed(range(S)):
        if t % chunk == chunk - 1 or t == S - 1:
            want[t // chunk] = G.clone()
        G = a[:, :, t, None, None] * (
            G + torch.einsum("bhn,bhp->bhnp", q[:, :, t], dy[:, :, t]))
    assert exits.shape == (B, H, -(-S // chunk), N, P)
    for c, w in want.items():
        torch.testing.assert_close(exits[:, :, c], w, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(d_init, G, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("S,chunk", [(300, 128), (100, 256), (256, 64)])
@pytest.mark.parametrize("with_initial", [False, True])
def test_ssd_entry_states_from_chunk_sums_equal_the_serial_scan(S, chunk,
                                                                with_initial):
    """``_entry_states`` forms every chunk's entry state from the chunk
    sums dS_c and the scan over chunks, as the forward kernel does: in
    float64 it equals, to 1e-12, the state carried position by position,
    S <- a_t S + k_t v_t^T, read before each chunk's first position and
    after the last.  On fp32 inputs its final state matches the reference
    Pallas kernel's (interpret mode) at the SSD tolerance: the kernel gives
    no state, so N probe positions after the sequence (a = 1, k = v = 0, q
    the unit vectors) read its rows out of y, and an initial state enters
    through N positions before it (a = 1, k the unit vectors, v its rows).
    A ragged last chunk, one chunk, and chunks of 64."""
    B, H, N, P = 2, 3, 8, 6
    arrays = scan_inputs(7, B, H, S, N, P, near_one=True)
    rng = np.random.default_rng(8)
    init = (rng.standard_normal((B, H, N, P)) * 0.3).astype(np.float32)
    a, k, v, q = (torch.from_numpy(x).double() for x in arrays)
    s0 = torch.from_numpy(init).double() if with_initial else None
    entries, final = port_ss._entry_states(torch.log(a), k, v, chunk, s0)
    state = s0.clone() if with_initial else torch.zeros(B, H, N, P,
                                                        dtype=torch.float64)
    assert entries.shape == (B, H, -(-S // chunk), N, P)
    for t in range(S):
        if t % chunk == 0:
            torch.testing.assert_close(entries[:, :, t // chunk], state,
                                       rtol=1e-12, atol=1e-12)
        state = a[:, :, t, None, None] * state + torch.einsum(
            "bhn,bhp->bhnp", k[:, :, t], v[:, :, t])
    torch.testing.assert_close(final, state, rtol=1e-12, atol=1e-12)

    a32, k32, v32, q32 = arrays
    eye = np.broadcast_to(np.eye(N, dtype=np.float32), (B, H, N, N))
    ones = np.ones((B, H, N), np.float32)
    zk = np.zeros((B, H, N, N), np.float32)
    zv = np.zeros((B, H, N, P), np.float32)
    pre = ([ones], [eye], [init], [zk]) if with_initial else ([], [], [], [])
    ext = [np.concatenate(pre[i] + [x] + [post], axis=2)
           for i, (x, post) in enumerate(((a32, ones), (k32, zk), (v32, zv),
                                          (q32, eye)))]
    gold = ref_ops.ssd_scan(*(jnp.asarray(x) for x in ext), chunk=chunk,
                            force_pallas=True, interpret=True)
    entries32, final32 = port_ss._entry_states(
        torch.log(torch.from_numpy(a32).double()), torch.from_numpy(k32),
        torch.from_numpy(v32), chunk,
        torch.from_numpy(init) if with_initial else None)
    np.testing.assert_allclose(as_np(final32), as_np(gold)[:, :, -N:],
                               **SSD_TOL)


def _f64_scan_loss(a, k, v, q, dy):
    """The step-by-step recurrence in float64 (no chunks, no exponentials
    of differences)."""
    state = torch.zeros(a.shape[:2] + (k.shape[-1], v.shape[-1]),
                        dtype=torch.float64)
    loss = 0.0
    for t in range(a.shape[2]):
        state = state * a[:, :, t, None, None] + torch.einsum(
            "bhn,bhp->bhnp", k[:, :, t], v[:, :, t])
        loss = loss + (torch.einsum("bhnp,bhn->bhp", state, q[:, :, t])
                       * dy[:, :, t]).sum()
    return loss


def test_ssd_gradient_stays_finite_where_the_reference_overflows_r4():
    """A strong decay inside a chunk (a = 1e-30 among decays of ~0.2):
    the reference forms exp(cum_i - cum_j) for every (i, j) and masks
    after, so exp overflows above the diagonal and its gradient is NaN
    (ROADMAP R4).  The port forms it only where i >= j; its gradient is
    finite and equals the float64 recurrence's."""
    B, H, S, N, P, chunk = 1, 2, 64, 4, 4, 64
    a, k, v, q = scan_inputs(3, B, H, S, N, P)
    a[:] = 0.2
    a[..., 20] = 1e-30
    dy = np.random.default_rng(4).standard_normal((B, H, S, P)).astype(
        np.float32)
    zeros = np.zeros((B, H, N, P), np.float32)
    gold = jax.grad(_ref_scan_loss(chunk, dy, zeros), argnums=range(4))(
        *(jnp.asarray(x) for x in (a, k, v, q, zeros)))
    assert np.isnan(np.asarray(gold[0])).any()
    leaves = [torch.from_numpy(x).requires_grad_() for x in (a, k, v, q)]
    y, _ = ops.ssd_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    f64 = [torch.from_numpy(x).double().requires_grad_() for x in (a, k, v, q)]
    want = torch.autograd.grad(
        _f64_scan_loss(*f64, torch.from_numpy(dy).double()), f64)
    _compare_grads(got, want, a)


# --------------------------------------------- (c) chunked_linear_scan
@pytest.mark.parametrize("S,chunk", [(100, 32), (64, 256)])
@pytest.mark.parametrize("with_initial", [False, True])
def test_chunked_linear_scan_matches_reference(S, chunk, with_initial,
                                               near_one=False):
    B, H, N, P = 2, 4, 16, 8
    a, k, v, q = scan_inputs(5, B, H, S, N, P, near_one)
    bshp = [np.ascontiguousarray(np.moveaxis(x, 1, 2)) for x in (a, k, v, q)]
    s0 = (np.random.default_rng(6).standard_normal((B, H, N, P)) * 0.3
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


@pytest.mark.parametrize("with_initial", [False, True])
def test_chunked_linear_scan_matches_reference_with_decays_near_one(
        with_initial):
    test_chunked_linear_scan_matches_reference(100, 32, with_initial, True)


# ------------------------------------------------------ fixtures: zamba2
@pytest.fixture(scope="module")
def zamba():
    """Reduced zamba2 with the reference's fp32 parameters on both sides
    (a_log, dt_bias and d_skip are fp32 in any case), and one batch."""
    cfg = get_config("zamba2").reduced()
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    # non-trivial SSM parameters, the same on both sides
    rng = np.random.default_rng(11)
    mb = dict(jp["mamba_blocks"])
    for name, lo, hi in (("a_log", -1.0, 1.0), ("dt_bias", -3.0, 0.0),
                         ("d_skip", 0.5, 1.5)):
        mb[name] = jnp.asarray(rng.uniform(lo, hi, mb[name].shape),
                               jnp.float32)
    jp = dict(jp, mamba_blocks=mb)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40))
    return cfg, jp, tp, toks


def test_port_init_params_has_the_reference_keys_shapes_and_dtypes():
    cfg = get_config("zamba2").reduced()
    jp = jax.eval_shape(lambda: ref_lm.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    tp = port_lm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ref_shapes = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
                  for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    port_shapes = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for p, t in _tree.flatten_with_path(tp)[0]}
    assert port_shapes == ref_shapes
    assert tp["shared_attn"]["attn"]["wq"].dim() == 2       # unstacked
    assert tp["mamba_blocks"]["a_log"].dtype == torch.float32


# --------------------------------------------------- (d) the Mamba-2 block
def _block(tree, i=0):
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def test_mamba2_forward_matches_reference(zamba):
    cfg, jp, tp, _ = zamba
    x = np.random.default_rng(7).standard_normal((2, 40, cfg.d_model)
                                                 ).astype(np.float32)
    for chunk in (256, 16):                # one chunk, and ragged chunks
        gold = ref_mamba.mamba2_forward(_block(jp["mamba_blocks"]),
                                        jnp.asarray(x), cfg, chunk=chunk)
        out = port_mamba.mamba2_forward(_block(tp["mamba_blocks"]),
                                        torch.from_numpy(x), cfg,
                                        chunk=chunk)
        np.testing.assert_allclose(as_np(out), as_np(gold), **MODEL_TOL)


def test_mamba2_decode_matches_reference(zamba):
    """Several tokens through one block; the port updates its cache in
    place (P5), the reference returns a new one."""
    cfg, jp, tp, _ = zamba
    jblk, tblk = _block(jp["mamba_blocks"], 1), _block(tp["mamba_blocks"], 1)
    jc = ref_mamba.init_mamba2_cache(cfg, 2)
    tc = port_mamba.init_mamba2_cache(cfg, 2, device="cpu")
    xs = np.random.default_rng(8).standard_normal((6, 2, cfg.d_model)
                                                  ).astype(np.float32)
    for x in xs:
        gold, jc = ref_mamba.mamba2_decode(jblk, jnp.asarray(x)[:, None], jc,
                                           cfg)
        out = port_mamba.mamba2_decode(tblk, torch.from_numpy(x), tc, cfg)
        np.testing.assert_allclose(as_np(out), as_np(gold)[:, 0], **MODEL_TOL)
    np.testing.assert_allclose(as_np(tc["ssm"]), as_np(jc["ssm"]), **MODEL_TOL)
    np.testing.assert_array_equal(as_np(tc["conv"]), as_np(jc["conv"]))
    assert tc["conv"].dtype == torch.bfloat16


# ------------------------------------------- (e) hybrid forward and grads
@pytest.fixture(scope="module")
def zamba_ref(zamba):
    cfg, jp, _, toks = zamba
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32)}
    jlogits, _ = jax.jit(lambda p: ref_lm.forward(p, cfg, jb["tokens"]))(jp)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, cfg, jb), has_aux=True))(jp)
    return jlogits, jloss, jm, jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_forward_loss_and_every_gradient_match_reference(
        zamba, zamba_ref, remat):
    cfg, _, tp, toks = zamba
    jlogits, jloss, jm, jgrads = zamba_ref
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
    tloss = tloss.detach()
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(tm["nll"].detach()) == pytest.approx(float(jm["nll"]),
                                                     rel=1e-5)
    want = jax_leaf_paths(jgrads)
    got = {p: g for (p, _), g in zip(_tree.flatten_with_path(tp)[0], tgrads)}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(as_np(g), as_np(want[path]), **MODEL_TOL,
                                   err_msg=path)
    assert set(ops.launch_counts().values()) == {0}     # CPU: no kernel


def test_hybrid_forward_runs_the_shared_block_before_each_group(zamba,
                                                                monkeypatch):
    """38 layers every 6: 7 applications; the reduced 4 every 2: 2."""
    cfg, _, tp, toks = zamba
    calls = {"ssd_scan": 0, "flash_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    port_lm.forward(tp, cfg, torch.from_numpy(toks))
    assert calls == {"ssd_scan": cfg.n_layers, "flash_attention": 2}
    assert port_lm._n_apps(get_config("zamba2")) == 7


# ------------------------------------------------------- (f) decode_step
def test_hybrid_decode_step_and_caches_match_reference(zamba):
    cfg, jp, tp, toks = zamba
    B, S, steps = 2, 16, 6
    jc = ref_lm.init_cache(cfg, B, S)
    tc = port_lm.init_cache(cfg, B, S, device="cpu")
    assert {p: tuple(t.shape) for p, t in _tree.flatten_with_path(tc)[0]} \
        == {p: tuple(a.shape) for p, a in jax_leaf_paths(jc).items()}
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, cfg, c, t, pos))
    for i in range(steps):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i], jnp.int32),
                      jnp.int32(i))
        tl = port_lm.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, i]), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)
    want = jax_leaf_paths(jc)
    for path, t in _tree.flatten_with_path(tc)[0]:
        assert t.dtype == params_from_numpy(np.asarray(want[path]),
                                            "cpu").dtype, path
        # bf16 caches hold an fp32 value rounded once: where the two
        # packages' fp32 values (1e-6 apart) straddle a rounding boundary
        # the stored values are one bf16 ulp apart; the SSM state reads the
        # bf16 conv window, so such an ulp moves it by up to ~1e-5
        tol = (dict(rtol=2 ** -7, atol=1e-30) if t.dtype == torch.bfloat16
               else SSD_TOL if path == "['mamba']['ssm']" else MODEL_TOL)
        np.testing.assert_allclose(as_np(t), as_np(want[path]), **tol,
                                   err_msg=path)


# ---------------------------------------------------- (g) runtime spans
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_runtime_leaf_spans_match_reference(zamba, moments):
    cfg, jp, tp, _ = zamba
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
    assert any("['shared_attn']" in s[0] for s in spans[1][2])


def test_opt_state_bytes_of_the_mixed_dtype_params_match_reference():
    cfg = get_config("zamba2").reduced()
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(1))      # bf16 + fp32
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    assert {t.dtype for t in _tree.leaves(tp)} == {torch.bfloat16,
                                                    torch.float32}
    for m in ("float32", "bfloat16", "int8"):
        for master in (True, False):
            assert opt_state_bytes(tp, AdamWConfig(
                moments_dtype=m, master_fp32=master)) == ref_opt_state_bytes(
                jp, RefAdamWConfig(moments_dtype=m, master_fp32=master))


def test_runtime_registers_the_hybrid_cache_as_kv_cache(zamba):
    from repro.serve.engine import ServeEngine as RefEngine
    from repro_torch.serve.engine import ServeEngine
    cfg, jp, tp, toks = zamba
    objs = []
    for core, make, params, kw in (
            (ref_core, RefEngine, jp, {}),
            (port_core, ServeEngine, tp, dict(device="cpu"))):
        rt = core.UnimemRuntime(core.PAPER_DRAM_NVM,
                                core.RuntimeConfig(backend="sim"))
        eng = make(cfg, params, max_seq=16, batch=2, runtime=rt,
                   tenant="t0", **kw)
        prompts = toks[:, :3]
        out = eng.generate(torch.from_numpy(prompts) if kw
                           else jnp.asarray(prompts, jnp.int32), 2)
        objs.append((np.asarray(out), rt.registry["t0/kv_cache"].leaf_spans))
    np.testing.assert_array_equal(objs[1][0], objs[0][0])
    assert objs[1][1] == objs[0][1]


# ----------------------------------------------------- (h) a train step
def test_hybrid_train_step_matches_reference(zamba):
    cfg, jp, _, toks = zamba
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


# ----------------------------------------------------- (i) the launchers
def test_train_launcher_runs_zamba2_on_cpu(capsys):
    from repro_torch.launch.train import main
    ops.reset_launch_counts()
    main(["--arch", "zamba2", "--reduced", "--device", "cpu", "--steps", "3",
          "--batch", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    final, first = re.search(r"final loss: (\S+) \(first: (\S+)\)",
                             out).groups()
    assert np.isfinite(float(final)) and np.isfinite(float(first))
    assert set(ops.launch_counts().values()) == {0}


def test_serve_launcher_runs_zamba2_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "zamba2",
                                      "--reduced", "--device", "cpu",
                                      "--new", "4", "--prompt-len", "5"])
    serve.main()
    out = capsys.readouterr().out
    assert "generated (4, 9)" in out


# ------------------------------------------------------ (j) the wrapper
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take():
    a, k, v, q = (torch.from_numpy(x) for x in scan_inputs(0, 1, 2, 10, 4, 4))
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(a, k.bfloat16(), v, q)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan(a, k[:, :, :5], v, q)
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssd_scan(a, k, v, q, initial_state=torch.zeros(1, 2, 4, 5))
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(a, k, v, q, chunk=0)


def test_ssd_wrapper_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain versions:
    off the CPU the wrappers launch their kernels or raise."""
    def boom(*a, **kw):
        raise AssertionError("plain version taken off the CPU")
    monkeypatch.setattr(port_ss, "_plain_forward", boom)
    monkeypatch.setattr(port_ss, "ssd_scan_bwd_plain", boom)
    before = ops.launch_counts()
    a = torch.empty(1, 2, 10, device="meta")
    k = torch.empty(1, 2, 10, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_scan(a, k, k, k)
    with pytest.raises(ValueError, match="unsupported device"):
        port_ss.ssd_scan_bwd(a, k, k, k, k, None, None, None, 4, False)
    assert ops.launch_counts() == before
