"""The Mamba-2 SSD chunked scan with its gradient: the wrappers around
``csrc/ssd_scan.cu`` (forward) and ``csrc/ssd_scan_bwd.cu`` (backward),
their plain PyTorch versions, and the ``torch.autograd.Function`` that
ties the two together.

  S_t = a_t S_{t-1} + k_t v_t^T ,   y_t = S_t^T q_t

a: (B, H, S) decays in (0, 1]; k, q: (B, H, S, N); v: (B, H, S, P); the
state S is (N, P) per (batch, head), fp32.  Computed in chunks of Q
positions (the reference package's ``_ssd_kernel`` and
``models/mamba2.py`` ``chunked_linear_scan``): with cum = cumsum(log a)
inside the chunk,

  y_i   = sum_{j<=i} (q_i . k_j) e^{cum_i - cum_j} v_j + e^{cum_i} q_i S
  S_new = e^{cum_L} S + sum_j e^{cum_L - cum_j} k_j v_j^T

(L the chunk's last position).  Only the state runs from chunk to chunk,
so the forward kernel (``csrc/ssd_scan.cu``) forms it first, in float64:
each chunk's sum dS_c = sum_j e^{cum_L - cum_j} k_j v_j^T, then the scan
S_{c+1} = e^{cum_L} S_c + dS_c (:func:`_entry_states` is its order on the
CPU); the rest of every chunk is local, and the chunks run in parallel.
The TPU kernel is forward only: JAX differentiates the pure-JAX scan.
Here the gradient is a kernel too; it starts from the chunk-entry states
the forward saves (not recomputed) and carries dS:

  dq_i = sum_{j<=i} e^{cum_i-cum_j} (dy_i . v_j) k_j + e^{cum_i} S dy_i
  dk_j = sum_{i>=j} e^{cum_i-cum_j} (dy_i . v_j) q_i + w_j dS v_j
  dv_j = sum_{i>=j} e^{cum_i-cum_j} (q_i . k_j) dy_i + w_j dS^T k_j
  dS_prev = e^{cum_L} dS + sum_i e^{cum_i} q_i dy_i^T
  dcum_i = q_i . dq_i - k_i . dk_i  (+ <dS, S_new> at i = L)
  dlog a = reverse cumsum of dcum in the chunk;  da = dlog a / a

with w_j = e^{cum_L - cum_j}.  The products of dq, dk and dv are the
reference's arithmetic in both versions.  d(log a) is not: with decays
near 1 the terms of dcum reach a few hundred and cancel to a few
hundredths, so both the kernel (``csrc/ssd_scan_bwd.cu``) and the plain
version sum the same terms rearranged so that nothing large cancels, in
float64:

  dlog a_t = sum_{i>=t} (R_i - C_i + X_i) + e^{cum_L} <dS, S>
             + sum_{j<t} Y_j
  R_i = sum_j Z_ij,  C_j = sum_i Z_ij,  Z_ij = M_ij (q_i . k_j)(dy_i . v_j)
  X_i = e^{cum_i} q_i . (S dy_i),  Y_j = w_j k_j . (dS v_j)

with S the chunk's entry state and dS its exit state's gradient.  Only
dS runs from chunk to chunk, so both versions form it first, in float64:
each chunk's sum U_c = sum_i e^{cum_i} q_i dy_i^T, then the scan dS_prev =
e^{cum_L} dS + U; the rest of every chunk is local (the kernel runs the
chunks in parallel).  dk and dv take dS rounded to the inputs' precision.
Neither version needs the final state.  The reference's own fp32
arithmetic, autograd through :func:`_plain_forward`, stays the yardstick
the kernel's d(log a) is held against on the card (``chip_smoke.py``).
Decays enter only as e^{cum_i - cum_j} for i >= j and as e^{cum_i}, never
above 1, so strong decays cannot overflow.
A ragged last chunk is masked, nothing is padded; the final state equals
the reference's, whose wrapper pads with a = 1.

Both kernels take float32 tensors of any element strides on (B, H, S)
(stride 0 included: the model's k and q are one (B, S, N) tensor
broadcast over H) and unit stride on the last axis, and any N and P.  A
state of at most 64 x 64 (zamba2's) is one chunk kernel's work; a wider
one (xLSTM's mLSTM: N 512, P 513) takes each kernel's wide route, whose
products stream over N and P in 64-wide slices (the sources' notes).
There the backward forms the products that reach d(log a) -- both scores,
S dy and dS v, the last from dS in float64 -- in float64 (fp32 ones left
d(log a) 5e-4 from float64 at that shape), so its dk is a rounding closer
to float64 than the plain version's.  The C side picks the route and
sizes its fp64 work buffer (``ssd_scan_fwd_work``, ``ssd_scan_bwd_work``).  On a CUDA tensor each
wrapper launches its kernel or raises; only a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import record
from . import build

#: launches of the forward kernel since the last reset
launches = 0
#: launches of the backward kernel since the last reset
bwd_launches = 0

_MAX_CHUNK = 256             # the kernels scan a chunk, a position a thread
_MIN_A = 1e-37               # log(max(a, 1e-37)), as the reference


# ------------------------------------------------------------ plain versions
def _wide(t: torch.Tensor) -> torch.Tensor:
    """fp32, or float64 as given (a float64 reference on the card)."""
    return t if t.dtype == torch.float64 else t.float()


def _log_decay(a: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(_wide(a), min=_MIN_A))


def _chunk_terms(la: torch.Tensor):
    """cum (B, H, n), the causal decay matrix M (B, H, n, n) with
    exp(cum_i - cum_j) below the diagonal and 0 above (exp is taken only
    where i >= j), e^{cum} and w = e^{cum_L - cum}."""
    cum = torch.cumsum(la, dim=-1)
    n = la.shape[-1]
    causal = torch.ones((n, n), dtype=torch.bool, device=la.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    return cum, torch.exp(seg), torch.exp(cum), torch.exp(cum[..., -1:] - cum)


def _plain_forward(a, k, v, q, chunk: int, initial_state=None):
    """(y (B, H, S, P) fp32, final state (B, H, N, P), chunk-entry states
    (B, H, nc, N, P)); float64 throughout when given float64."""
    B, H, S = a.shape
    N, P = k.shape[-1], v.shape[-1]
    la = _log_decay(a)
    state = (torch.zeros((B, H, N, P), dtype=la.dtype, device=a.device)
             if initial_state is None else _wide(initial_state))
    ys, states = [], []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        kc, vc, qc = (_wide(t[:, :, sl]) for t in (k, v, q))
        cum, M, e, w = _chunk_terms(la[:, :, sl])
        scores = torch.einsum("bhin,bhjn->bhij", qc, kc) * M
        y = (torch.einsum("bhij,bhjp->bhip", scores, vc)
             + torch.einsum("bhin,bhnp->bhip", qc * e[..., None], state))
        states.append(state)
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + torch.einsum("bhjn,bhjp->bhnp", kc * w[..., None], vc))
        ys.append(y)
    return torch.cat(ys, dim=2), state, torch.stack(states, dim=2)


def ssd_scan_plain(a, k, v, q, chunk: int = 256, initial_state=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: (y (B, H, S, P),
    final state (B, H, N, P)), both fp32."""
    y, final, _ = _plain_forward(a, k, v, q, chunk, initial_state)
    return y, final


def ssd_scan_bwd_plain(a, k, v, q, dy, states, final, d_final, chunk: int,
                       has_initial: bool):
    """The backward kernel's function in plain PyTorch: (da, dk, dv, dq,
    d_initial_state or None) from the forward's inputs, its chunk-entry
    ``states``, and the output gradients ``dy`` and ``d_final`` (None for
    zero); ``final`` is not read, as the kernel does not read it.  dk and
    dq are per head (B, H, S, N).
    In the kernel's order: each chunk's exit gradient dS first, in float64
    from the chunk sums (:func:`_exit_grads`), then every chunk on its own.
    dq and the products of dk and dv are the reference's arithmetic in the
    inputs' precision, dk and dv with dS rounded to it; d(log a) is the
    kernel's rearrangement, in float64 (the module's note)."""
    B, H, S = a.shape
    N, P = k.shape[-1], v.shape[-1]
    la = _log_decay(a)
    la64 = _log_decay(a.double())
    af = _wide(a)
    exits, d_init = _exit_grads(la64, q, dy, d_final, chunk)
    da = torch.empty((B, H, S), dtype=la.dtype, device=a.device)
    dk = torch.empty((B, H, S, N), dtype=la.dtype, device=a.device)
    dq = torch.empty_like(dk)
    dv = torch.empty((B, H, S, P), dtype=la.dtype, device=a.device)
    for c in range(states.shape[2]):
        sl = slice(c * chunk, min((c + 1) * chunk, S))
        kc, vc, qc, dyc = (_wide(t[:, :, sl]) for t in (k, v, q, dy))
        _, M, e, w = _chunk_terms(la[:, :, sl])
        s_prev, dS64 = states[:, :, c], exits[:, :, c]
        dS = dS64.to(la.dtype)
        D = torch.einsum("bhip,bhjp->bhij", dyc, vc) * M
        Sc = torch.einsum("bhin,bhjn->bhij", qc, kc) * M
        dq[:, :, sl] = (torch.einsum("bhij,bhjn->bhin", D, kc)
                        + e[..., None]
                        * torch.einsum("bhip,bhnp->bhin", dyc, s_prev))
        dk[:, :, sl] = (torch.einsum("bhij,bhin->bhjn", D, qc)
                        + w[..., None]
                        * torch.einsum("bhjp,bhnp->bhjn", vc, dS))
        dv[:, :, sl] = (torch.einsum("bhij,bhip->bhjp", Sc, dyc)
                        + w[..., None]
                        * torch.einsum("bhjn,bhnp->bhjp", kc, dS))
        dla = _dlog_decay(_chunk_terms(la64[:, :, sl]),
                          *(t.double() for t in (kc, vc, qc, dyc, s_prev)),
                          dS64)
        a_c = af[:, :, sl]
        da[:, :, sl] = torch.where(a_c > _MIN_A, dla.to(la.dtype) / a_c,
                                   torch.zeros_like(a_c))
    return da, dk, dv, dq, (d_init.to(la.dtype) if has_initial else None)


def _exit_grads(la64, q, dy, d_final, chunk: int):
    """Every chunk's exit-state gradient and the initial state's, in
    float64, in the kernel's order (``csrc/ssd_scan_bwd.cu``): the chunk
    sums U_c = sum_i e^{cum_i} q_i dy_i^T, each on its own, then the scan
    dS_c = e^{cum_L,c+1} dS_{c+1} + U_{c+1} from dS = ``d_final`` (zero for
    None) after the last chunk.  ``la64``: log a (B, H, S) in float64.
    Returns (dS (B, H, nc, N, P), d_initial (B, H, N, P)), d_initial =
    e^{cum_L,0} dS_0 + U_0."""
    S = la64.shape[-1]
    sums, decays = [], []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        cum = torch.cumsum(la64[:, :, sl], dim=-1)
        sums.append(torch.einsum("bhin,bhip->bhnp",
                                 q[:, :, sl].double()
                                 * torch.exp(cum)[..., None],
                                 dy[:, :, sl].double()))
        decays.append(torch.exp(cum[..., -1])[..., None, None])
    dS = torch.zeros_like(sums[0]) if d_final is None else d_final.double()
    exits = [None] * len(sums)
    for c in reversed(range(len(sums))):
        exits[c] = dS
        dS = decays[c] * dS + sums[c]
    return torch.stack(exits, dim=2), dS


def _entry_states(la64, k, v, chunk: int, init=None):
    """Every chunk's entry state and the final state, in float64, in the
    forward kernel's order (``csrc/ssd_scan.cu``): the chunk sums dS_c =
    sum_j e^{cum_L - cum_j} k_j v_j^T, each on its own, then the scan
    S_{c+1} = e^{cum_L,c} S_c + dS_c from ``init`` (zero for None).
    ``la64``: log a (B, H, S) in float64.  Returns (S (B, H, nc, N, P),
    final (B, H, N, P))."""
    S = la64.shape[-1]
    sums, decays = [], []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        cum = torch.cumsum(la64[:, :, sl], dim=-1)
        w = torch.exp(cum[..., -1:] - cum)
        sums.append(torch.einsum("bhjn,bhjp->bhnp",
                                 k[:, :, sl].double() * w[..., None],
                                 v[:, :, sl].double()))
        decays.append(torch.exp(cum[..., -1])[..., None, None])
    state = torch.zeros_like(sums[0]) if init is None else init.double()
    entries = []
    for c in range(len(sums)):
        entries.append(state)
        state = decays[c] * state + sums[c]
    return torch.stack(entries, dim=2), state


def _dlog_decay(terms, k, v, q, dy, s_prev, dS):
    """d(log a) over one chunk, all float64, as ``csrc/ssd_scan_bwd.cu``
    forms it: sum_{i>=t} (R_i - C_i + X_i) + e^{cum_L} <dS, S>
    + sum_{j<t} Y_j, with S the chunk's entry state, dS its exit state's
    gradient and ``terms`` the chunk's :func:`_chunk_terms` (the module's
    note)."""
    cum, M, e, w = terms
    Z = (torch.einsum("bhin,bhjn->bhij", q, k)
         * torch.einsum("bhip,bhjp->bhij", dy, v) * M)
    X = e * torch.einsum("bhin,bhnp,bhip->bhi", q, s_prev, dy)
    Y = w * torch.einsum("bhjn,bhnp,bhjp->bhj", k, dS, v)
    f = Z.sum(-1) - Z.sum(-2) + X
    after = torch.flip(torch.cumsum(torch.flip(f, [-1]), -1), [-1])
    before = torch.cumsum(Y, -1) - Y
    state = torch.exp(cum[..., -1]) * (dS * s_prev).sum((-2, -1))
    return after + state[..., None] + before


# ----------------------------------------------------------------- wrappers
def _check(a, k, v, q, chunk: int, initial_state) -> None:
    if a.dim() != 3 or k.dim() != 4 or v.dim() != 4 or q.dim() != 4:
        raise ValueError("ssd_scan: a (B,H,S), k and q (B,H,S,N), "
                         "v (B,H,S,P)")
    B, H, S = a.shape
    if (k.shape[:3] != (B, H, S) or q.shape != k.shape
            or v.shape[:3] != (B, H, S)):
        raise ValueError(f"ssd_scan: shapes a {tuple(a.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, q "
                         f"{tuple(q.shape)} disagree")
    tensors = [a, k, v, q]
    if initial_state is not None:
        if initial_state.shape != (B, H, k.shape[-1], v.shape[-1]):
            raise ValueError("ssd_scan: initial_state must be (B, H, N, P), "
                             f"got {tuple(initial_state.shape)}")
        tensors.append(initial_state)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("ssd_scan: the kernels take float32 tensors (got "
                         f"{[str(t.dtype) for t in tensors]})")
    if any(t.device != a.device for t in tensors):
        raise ValueError("ssd_scan: tensors on different devices")
    if chunk < 1 or S < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} and S {S} must be >= 1")


def _check_cuda(name: str, tensors, chunk: int) -> None:
    if not tensors[0].is_cuda:
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    if chunk > _MAX_CHUNK:
        raise ValueError(f"{name}: the kernel takes chunk <= {_MAX_CHUNK} "
                         f"(got {chunk})")
    if any(t.dim() == 4 and t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{name}: the last axis (N or P) must have unit "
                         "stride")


def _strides(t: torch.Tensor):
    """Element strides of the (B, H, S) axes."""
    return [t.stride(0), t.stride(1), t.stride(2)]


@record.kernel(lambda a, k, v, q, chunk=256, initial_state=None,
               save_states=False, *, out: ((a, k, v, q, initial_state), out))
def ssd_scan_fwd(a, k, v, q, chunk: int = 256, initial_state=None,
                 save_states: bool = False):
    """(y (B, H, S, P), final state (B, H, N, P), chunk-entry states
    (B, H, nc, N, P) or None), all fp32.  y is laid out as v is (so a
    (B, S, H, P) view in gives a (B, S, H, P) tensor underneath).  The
    kernel writes the states in any case: without ``save_states`` into a
    scratch tensor."""
    global launches
    _check(a, k, v, q, chunk, initial_state)
    if a.device.type == "cpu":
        y, final, states = _plain_forward(a, k, v, q, chunk, initial_state)
        return y, final, states if save_states else None
    _check_cuda("ssd_scan", [a, k, v, q], chunk)
    B, H, S = a.shape
    N, P = k.shape[-1], v.shape[-1]
    nc = -(-S // chunk)
    y = torch.empty_like(v)
    final = torch.empty((B, H, N, P), dtype=torch.float32, device=a.device)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                         device=a.device)
    # each chunk's sum dS_c and e^{cum_L} (and the wide route's scores)
    work = torch.empty(_work("ssd_scan", "ssd_scan_fwd_work", B, H, S, N, P,
                             chunk), dtype=torch.float64, device=a.device)
    init = initial_state.contiguous() if initial_state is not None else None
    err = _bind_fwd()(
        a.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
        init.data_ptr() if init is not None else None, y.data_ptr(),
        final.data_ptr(), states.data_ptr(), work.data_ptr(),
        *_strides(a), *_strides(k), *_strides(v), *_strides(q), *_strides(y),
        B, H, S, N, P, chunk, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, final, states if save_states else None


@record.kernel(lambda a, k, v, q, dy, states, final, d_final, chunk,
               has_initial, *, out: ((a, k, v, q, dy, states, final, d_final),
                                     out))
def ssd_scan_bwd(a, k, v, q, dy, states, final, d_final, chunk: int,
                 has_initial: bool):
    """Gradients (da, dk, dv, dq, d_initial_state or None) of
    :func:`ssd_scan_fwd`; dk and dq per head, (B, H, S, N)."""
    global bwd_launches
    _check(a, k, v, q, chunk, None)
    if a.device.type == "cpu":
        return ssd_scan_bwd_plain(a, k, v, q, dy, states, final, d_final,
                                  chunk, has_initial)
    _check_cuda("ssd_scan_bwd", [a, k, v, q, dy], chunk)
    B, H, S = a.shape
    N, P = k.shape[-1], v.shape[-1]
    if dy.shape != v.shape or dy.dtype != torch.float32:
        raise ValueError("ssd_scan_bwd: dy must be float32 shaped as v")
    nc = -(-S // chunk)
    if (states.shape != (B, H, nc, N, P) or final.shape != (B, H, N, P)
            or not states.is_contiguous() or not final.is_contiguous()):
        raise ValueError("ssd_scan_bwd: states (B,H,nc,N,P) and final "
                         "(B,H,N,P) from the forward, contiguous")
    dfin = d_final.float().contiguous() if d_final is not None else None
    da = torch.empty((B, H, S), dtype=torch.float32, device=a.device)
    dk = torch.empty((B, H, S, N), dtype=torch.float32, device=a.device)
    dq = torch.empty_like(dk)
    dv = torch.empty((B, H, S, P), dtype=torch.float32, device=a.device)
    dinit = (torch.empty((B, H, N, P), dtype=torch.float32, device=a.device)
             if has_initial else None)
    # each chunk's sum U_c, then its exit gradient dS_c, and e^{cum_L} (and
    # the wide route's scores and partial sums)
    work = torch.empty(_work("ssd_scan_bwd", "ssd_scan_bwd_work", B, H, S, N,
                             P, chunk), dtype=torch.float64, device=a.device)
    err = _bind_bwd()(
        a.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
        dy.data_ptr(), states.data_ptr(),
        dfin.data_ptr() if dfin is not None else None,
        da.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq.data_ptr(),
        dinit.data_ptr() if dinit is not None else None, work.data_ptr(),
        *_strides(a), *_strides(k), *_strides(v), *_strides(q),
        *_strides(dy), B, H, S, N, P, chunk,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    return da, dk, dv, dq, dinit


class SSDScan(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient.  Saves the
    inputs as given (k and q stay stride-0 views), the chunk-entry states
    and the final state."""

    @staticmethod
    def forward(ctx, a, k, v, q, initial_state, chunk: int):
        grad = any(ctx.needs_input_grad[:5])
        y, final, states = ssd_scan_fwd(a, k, v, q, chunk, initial_state,
                                        save_states=grad)
        if grad:
            ctx.save_for_backward(a, k, v, q, states, final)
        ctx.chunk = chunk
        ctx.has_initial = initial_state is not None
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        a, k, v, q, states, final = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        da, dk, dv, dq, dinit = ssd_scan_bwd(a, k, v, q, dy, states, final,
                                             d_final, ctx.chunk,
                                             ctx.has_initial)
        return da, dk, dv, dq, dinit, None


def ssd_scan(a: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             q: torch.Tensor, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (B, H, S); k, q: (B, H, S, N); v: (B, H, S, P), float32, any
    strides on (B, H, S).  Returns (y (B, H, S, P), final state (B, H, N,
    P)), differentiable in every input and in ``initial_state``.  Any S:
    a ragged last chunk is masked, nothing is padded."""
    return SSDScan.apply(a, k, v, q, initial_state, chunk)


def _work(lib: str, fn: str, *dims) -> int:
    """Doubles of the work buffer the launch needs at these (B, H, S, N,
    P, chunk), from the library's own count."""
    f = getattr(build.load(lib), fn)
    if f.argtypes is None:
        f.argtypes = [ctypes.c_int] * 6
        f.restype = ctypes.c_longlong
    return f(*dims)


def _bind_fwd():
    fn = build.load("ssd_scan").ssd_scan_fwd_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 9 + [L] * 15 + [I] * 6 + [P]
        fn.restype = ctypes.c_int
    return fn


def _bind_bwd():
    fn = build.load("ssd_scan_bwd").ssd_scan_bwd_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 13 + [L] * 15 + [I] * 6 + [P]
        fn.restype = ctypes.c_int
    return fn
