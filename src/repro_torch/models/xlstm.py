"""xLSTM blocks: mLSTM (matrix memory, parallel over time) and sLSTM
(scalar memory, sequential) [arXiv:2405.04517]; the counterpart of the
reference package's ``models/xlstm.py``.

The mLSTM's recurrence  C_t = f_t C_{t-1} + i_t v_t k_t^T,  with the
normalizer  n_t = f_t n_{t-1} + i_t k_t  carried as a ones column appended
to v (state width P + 1), runs through :func:`.mamba2.chunked_linear_scan`,
so through the ``ssd_scan`` kernel and its gradient on the card: N = P =
d_in / H, a 512 x 513 state a head at xlstm-350m, the kernels' wide route.
The augmented v is built with its rows padded to a multiple of 4 floats
(so the kernels copy it 16 bytes at a time) and the scan sees the
unpadded view.  The one-token decode steps the (B, H, P, P + 1) fp32 state
in place (:func:`.mamba2.linear_scan_step`).

The sLSTM keeps per-head scalar memories with block-diagonal recurrent
weights and is sequential; the reference runs it as a ``lax.scan`` and it
has no TPU kernel.  Here it is plain PyTorch: a Python loop over time in
:func:`slstm_forward`, one step in place in :func:`slstm_decode`.  Over a
sequence the loop is a ``torch.autograd.Function`` (:class:`_SLSTMScan`)
whose backward is the cell's gradient written out, a step at a time in
reverse: under autograd the 2,048-step loop recorded ~10^5 nodes a layer
and a training step of xlstm-350m took ~18 s on an H100.

Decode products (``in_proj``, ``o_gate``, ``out_proj``, ``w_gates``) go
through the ``tiered_matmul`` kernel, one launch each, as every decode
product of the port; training products are ``torch.matmul``, as in
``mamba2_forward`` (the reference leaves them to XLA).  Parameters are
stacked over a leading layer axis, with the reference's keys and shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import dense_init, rms_norm
from .mamba2 import chunked_linear_scan, linear_scan_step


# ------------------------------------------------------------------ mLSTM
def _mlstm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def init_mlstm_params(generator: torch.Generator, cfg: ArchConfig,
                      n_layers: int, dtype=torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    d, L = cfg.d_model, n_layers
    d_in, H, _ = _mlstm_dims(cfg)
    return {
        # q, k, v over the up-projected stream + i, f gates per head
        "in_proj": dense_init(generator, (L, d, 3 * d_in + 2 * H), dtype),
        "o_gate": dense_init(generator, (L, d, d_in), dtype),
        "norm": torch.zeros((L, d_in), dtype=dtype, device=generator.device),
        "out_proj": dense_init(generator, (L, d_in, d), dtype),
    }


def _mlstm_qkv(params, x: torch.Tensor, cfg: ArchConfig, matmul):
    """q, k, v (..., H, P) in x's dtype and the gates' pre-activations ig,
    fg (..., H) in fp32, for x (..., d)."""
    d_in, H, P = _mlstm_dims(cfg)
    lead = x.shape[:-1]
    proj = matmul(x, params["in_proj"])
    q = proj[..., :d_in].reshape(*lead, H, P)
    k = proj[..., d_in:2 * d_in].reshape(*lead, H, P) / math.sqrt(P)
    v = proj[..., 2 * d_in:3 * d_in].reshape(*lead, H, P)
    ig = proj[..., 3 * d_in:3 * d_in + H].float()
    fg = proj[..., 3 * d_in + H:].float()
    return q, k, v, ig, fg


def _gates(ig: torch.Tensor, fg: torch.Tensor):
    """The per-step decay f = sigmoid(fg) and the stabilized input gate
    i = exp(ig - softplus(ig)), as the reference forms them."""
    return torch.sigmoid(fg), torch.exp(ig - F.softplus(ig))


def _augment(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """[i v, i] (..., P + 1) fp32: the value scaled by the input gate, and
    the normalizer's column.  Its rows are padded to a multiple of 4
    floats; the view returned leaves the padding out."""
    cols = [v.float() * i[..., None], i[..., None]]
    pad = -(v.shape[-1] + 1) % 4
    if pad:
        cols.append(i.new_zeros((*i.shape, pad)))
    return torch.cat(cols, dim=-1)[..., :v.shape[-1] + 1]


def _readout(y: torch.Tensor, P: int) -> torch.Tensor:
    """num / max(|den|, 1): the scan's first P columns over its last."""
    num, den = y[..., :P], y[..., P:]
    return num / torch.maximum(den.abs(), torch.ones_like(den))


def mlstm_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ArchConfig, *, chunk: int = 256) -> torch.Tensor:
    """Full-sequence mLSTM block.  x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    d_in, _, P = _mlstm_dims(cfg)
    q, k, v, ig, fg = _mlstm_qkv(params, x, cfg, torch.matmul)
    f, i = _gates(ig, fg)
    y, _ = chunked_linear_scan(f, k, _augment(v, i), q, chunk=chunk)
    h = _readout(y, P).reshape(B, S, d_in).to(x.dtype)
    h = rms_norm(h, params["norm"]) * torch.sigmoid(
        torch.matmul(x, params["o_gate"]))
    return torch.matmul(h, params["out_proj"])


def init_mlstm_cache(cfg: ArchConfig, batch: int, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """{"state": (batch, H, P, P + 1) fp32}, zeroed."""
    _, H, P = _mlstm_dims(cfg)
    return {"state": torch.zeros((batch, H, P, P + 1), dtype=torch.float32,
                                 device=device)}


def mlstm_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> torch.Tensor:
    """One-token step.  x: (B, d) -> (B, d); ``cache["state"]`` (one
    layer's view) is updated in place."""
    B = x.shape[0]
    d_in, _, P = _mlstm_dims(cfg)
    q, k, v, ig, fg = _mlstm_qkv(params, x, cfg, ops.tiered_matmul)
    f, i = _gates(ig, fg)
    y = linear_scan_step(cache["state"], f, k, _augment(v, i), q)
    h = _readout(y, P).reshape(B, d_in).to(x.dtype)
    h = rms_norm(h, params["norm"]) * torch.sigmoid(
        ops.tiered_matmul(x, params["o_gate"]))
    return ops.tiered_matmul(h, params["out_proj"])


# ------------------------------------------------------------------ sLSTM
def init_slstm_params(generator: torch.Generator, cfg: ArchConfig,
                      n_layers: int, dtype=torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    d, L, H = cfg.d_model, n_layers, cfg.n_heads
    P = d // H
    return {
        "w_gates": dense_init(generator, (L, d, 4 * d), dtype),     # z i f o
        "r_gates": dense_init(generator, (L, H, P, 4 * P), dtype),  # block-diag
        "norm": torch.zeros((L, d), dtype=dtype, device=generator.device),
        "out_proj": dense_init(generator, (L, d, d), dtype),
    }


def _heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per head, h (B, H, P) @ w (H, P, Q) -> (B, H, Q)."""
    return torch.bmm(h.transpose(0, 1), w).transpose(0, 1)


def _slstm_cell(r_gates: torch.Tensor, carry, gates_t: torch.Tensor):
    """One sLSTM step.  r_gates: (H, P, 4P) fp32; carry: (h, c, n, m), each
    (B, H, P) fp32; gates_t: (B, H, 4P) fp32 pre-activations from the
    input.  Exponential gating with the stabilizer m, as the reference:
    m' = max(f_t + m, i_t), c' = e^{f_t + m - m'} c + e^{i_t - m'} z,
    n' likewise with 1 for z, h' = o c' / max(|n'|, 1)."""
    h, c, n, m = carry
    P = h.shape[-1]
    g = torch.baddbmm(gates_t.transpose(0, 1), h.transpose(0, 1),
                      r_gates).transpose(0, 1)
    i_t = g[..., P:2 * P]
    fm = g[..., 2 * P:3 * P] + m
    m_new = torch.maximum(fm, i_t)
    i_e = torch.exp(i_t - m_new)
    f_e = torch.exp(fm - m_new)
    c_new = torch.addcmul(i_e * torch.tanh(g[..., :P]), f_e, c)
    n_new = torch.addcmul(i_e, f_e, n)
    h_new = torch.sigmoid(g[..., 3 * P:]) * c_new / torch.maximum(
        n_new.abs(), torch.ones_like(n_new))
    return h_new, c_new, n_new, m_new


def _tie_weight(a: torch.Tensor, b) -> torch.Tensor:
    """d max(a, b) / da: 1 where a > b, 1/2 at a tie, 0 below, as both
    packages differentiate ``maximum``."""
    return (a > b).float() + 0.5 * (a == b).float()


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM over a sequence from zero carries: gates (B, S, H, 4P)
    and r_gates (H, P, 4P), fp32, -> h (B, S, H, P).  The forward runs
    :func:`_slstm_cell` a step at a time with no autograd graph and saves
    every step's carry.  The backward first forms, for all steps at once,
    every term of the cell's gradient that depends only on the forward
    (from the saved carries), then carries the four gradients gh, gc, gn,
    gm from the last step to the first, ~17 launches a step:

      q = c'/d, d = max(|n'|, 1):  gc' += gh o / d,
      gn' -= gh o / d * q sign(n') [|n'| > 1, 1/2 at 1]
      a_f = (gc' c + gn' n) f_e,  a_i = (gc' z + gn') i_e,  gm' -= a_f + a_i
      g(gates_t) = [gc' i_e (1 - z^2), a_i + gm' (1 - w), a_f + gm' w,
                    gh q o (1 - o)],  w = d max(fm, i_t) / d fm
      gh = g(gates_t) r^T,  gc = gc' f_e,  gn = gn' f_e,  gm = g(fm)
      g r = sum_t h_{t-1}^T g(gates_t)
    """

    @staticmethod
    def forward(ctx, gates, r_gates):
        B, S, H, _ = gates.shape
        zeros = gates.new_zeros((B, H, r_gates.shape[1]))
        carry = (zeros, zeros, zeros, zeros)
        steps = []
        for gates_t in gates.unbind(1):
            carry = _slstm_cell(r_gates, carry, gates_t)
            steps.append(carry)
        h, c, n, m = (torch.stack(x, dim=1) for x in zip(*steps))
        ctx.save_for_backward(gates, r_gates, h, c, n, m)
        return h

    @staticmethod
    def backward(ctx, g_out):
        gates, r_gates, hs, cs, ns, ms = ctx.saved_tensors
        P = hs.shape[-1]
        first = torch.zeros_like(hs[:, :1])
        h_prev, c_prev, n_prev, m_prev = (
            torch.cat([first, x[:, :-1]], dim=1) for x in (hs, cs, ns, ms))
        # every step's terms at once, from the carries before it
        g = gates + torch.einsum("bshp,hpq->bshq", h_prev, r_gates)
        z = torch.tanh(g[..., :P])
        i_t = g[..., P:2 * P]
        fm = g[..., 2 * P:3 * P] + m_prev
        o = torch.sigmoid(g[..., 3 * P:])
        i_e = torch.exp(i_t - ms)
        f_e = torch.exp(fm - ms)
        d = torch.maximum(ns.abs(), torch.ones_like(ns))
        q = cs / d
        od = o / d
        qs = q * torch.sign(ns) * _tie_weight(ns.abs(), 1.0)
        w = _tie_weight(fm, i_t)
        terms = [t.unbind(1) for t in (
            g_out, od, qs, c_prev * f_e, n_prev * f_e, i_e, z * i_e, w,
            1 - w, i_e * (1 - z * z), q * o * (1 - o), f_e)]
        del g, z, i_t, fm, o, i_e, d, q, od, qs, w
        g_gates = torch.empty_like(gates)
        r_t = r_gates.transpose(1, 2)
        gh = gc = gn = gm = first[:, 0]
        for t in reversed(range(gates.shape[1])):
            (go, od_t, qs_t, cf_t, nf_t, ie_t, zie_t, w_t, w1_t, zi2_t, qo_t,
             fe_t) = (x[t] for x in terms)
            gh = gh + go
            gq = gh * od_t
            gc = gc + gq
            gn = torch.addcmul(gn, gq, qs_t, value=-1.0)
            a_f = torch.addcmul(gc * cf_t, gn, nf_t)
            a_i = torch.addcmul(gn * ie_t, gc, zie_t)
            gm = gm - a_f - a_i
            g_t = g_gates[:, t]
            torch.mul(gc, zi2_t, out=g_t[..., :P])
            torch.addcmul(a_i, gm, w1_t, out=g_t[..., P:2 * P])
            torch.addcmul(a_f, gm, w_t, out=g_t[..., 2 * P:3 * P])
            torch.mul(gh, qo_t, out=g_t[..., 3 * P:])
            gc, gn, gm = gc * fe_t, gn * fe_t, g_t[..., 2 * P:3 * P]
            gh = _heads(g_t, r_t)
        g_r = torch.einsum("bshp,bshq->hpq", h_prev, g_gates)
        return g_gates, g_r


def _gate_inputs(x: torch.Tensor, w_gates: torch.Tensor, H: int, matmul):
    """x (..., d) -> the gates' input pre-activations (..., H, 4P) fp32."""
    return matmul(x, w_gates).float().reshape(*x.shape[:-1], H, -1)


def slstm_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence sLSTM block, a step at a time.  x: (B, S, d) ->
    (B, S, d)."""
    B, S, d = x.shape
    gates = _gate_inputs(x, params["w_gates"], cfg.n_heads, torch.matmul)
    h = _SLSTMScan.apply(gates, params["r_gates"].float())
    h = h.reshape(B, S, d).to(x.dtype)
    return torch.matmul(rms_norm(h, params["norm"]), params["out_proj"])


def init_slstm_cache(cfg: ArchConfig, batch: int, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """{"h", "c", "n", "m"}: (batch, H, P) fp32 each, zeroed."""
    H = cfg.n_heads
    return {name: torch.zeros((batch, H, cfg.d_model // H),
                              dtype=torch.float32, device=device)
            for name in ("h", "c", "n", "m")}


def slstm_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> torch.Tensor:
    """One-token step.  x: (B, d) -> (B, d); the cache's h, c, n and m
    (one layer's views) are updated in place."""
    B, d = x.shape
    gates = _gate_inputs(x, params["w_gates"], cfg.n_heads,
                         ops.tiered_matmul)
    names = ("h", "c", "n", "m")
    new = _slstm_cell(params["r_gates"].float(),
                      tuple(cache[n] for n in names), gates)
    for n, t in zip(names, new):
        cache[n].copy_(t)
    out = rms_norm(new[0].reshape(B, d).to(x.dtype), params["norm"])
    return ops.tiered_matmul(out, params["out_proj"])
