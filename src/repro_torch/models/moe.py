"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Counterpart of the reference package's ``models/moe.py``: an fp32 router,
softmax, top-k with renormalised gates, the Switch load-balancing aux
loss, row-local capacity C with positions from a stable sort, pairs past C
dropped, the experts' products over a dense (B, E, C, d) buffer
(``torch.matmul``, as the reference's ``jnp.einsum``), the combine, and
shared experts (DeepSeek/Moonlight style) run densely alongside.  Shard
hints are dropped (one card).

The dispatch and the combine are gathers, and so are their gradients
(:class:`_Take`): each buffer slot takes at most one (token, k) pair and
each pair at most one slot, so one map and its inverse move rows both
ways, and a token's k contributions are a sum over k.  No scatter-add with
repeated indices is run, whose order on the card would change the bits
from run to run.

:func:`moe_decode` is the one-token path: the same function at S = 1
(C = 8, every token's k experts at position 0, nothing dropped) with the
shared experts through ``ops.tiered_matmul`` and the routed experts
through ``ops.tiered_matmul_experts``, which reads only the experts the
batch picks; no host synchronisation.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import ACTIVATIONS, dense_init

#: tokens a row dispatches at once (the reference's chunked-prefill MoE)
CHUNK = 4096


def init_moe_params(generator: torch.Generator, cfg: ArchConfig,
                    n_layers: Optional[int], dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """Stacked over a leading layer axis of ``n_layers`` (or one unstacked
    layer with ``n_layers=None``): the router in fp32 (d, E), the experts
    (E, d, f) and (E, f, d), and the shared experts' (d, f s) and (f s, d)
    with s = ``moe_shared_experts``."""
    d, E, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    L = () if n_layers is None else (n_layers,)
    p = {
        "router": dense_init(generator, (*L, d, E), torch.float32),
        "w_gate": dense_init(generator, (*L, E, d, f), dtype),
        "w_up": dense_init(generator, (*L, E, d, f), dtype),
        "w_down": dense_init(generator, (*L, E, f, d), dtype),
    }
    if cfg.moe_shared_experts:
        fs = f * cfg.moe_shared_experts
        p["shared_gate"] = dense_init(generator, (*L, d, fs), dtype)
        p["shared_up"] = dense_init(generator, (*L, d, fs), dtype)
        p["shared_down"] = dense_init(generator, (*L, fs, d), dtype)
    return p


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(n_tokens * cfg.moe_top_k / cfg.moe_experts
            * cfg.moe_capacity_factor)
    return max(8, -(-c // 8) * 8)


def moe_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (output (B, S, d), aux loss).  A sequence longer
    than CHUNK and a multiple of it dispatches CHUNK tokens at a time, each
    chunk with its own capacity, and the aux loss is the chunks' mean, as
    the reference's ``lax.map`` over chunks."""
    S = x.shape[1]
    if S > CHUNK and S % CHUNK == 0:
        outs, auxs = zip(*(_moe_core(params, xc, cfg)
                           for xc in x.split(CHUNK, dim=1)))
        return torch.cat(outs, dim=1), torch.stack(auxs).mean()
    return _moe_core(params, x, cfg)


def _route(params, x: torch.Tensor, cfg: ArchConfig):
    """fp32 router logits -> (probs, top-k gates renormalised, top-k
    experts), x: (..., d)."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def dispatch_maps(flat_e: torch.Tensor, E: int, C: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_e: (B, P) each pair's expert (pair p = token p // k, choice
    p % k).  Returns ``pair_slot`` (B, P): the pair's slot e * C + pos in
    the (E * C) buffer, pos its rank among the row's pairs of expert e in
    pair order (the reference's stable-argsort rank), or E * C where pos
    >= C (dropped); and ``slot_pair`` (B, E * C): the pair in each slot, or
    P for an empty slot."""
    B, P = flat_e.shape
    dev = flat_e.device
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    start = torch.searchsorted(sorted_e, experts)
    count = torch.searchsorted(sorted_e, experts, right=True) - start
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=dev).expand(B, P))
    pos = rank - torch.gather(start, 1, flat_e)
    pair_slot = torch.where(pos < C, flat_e * C + pos,
                            torch.full_like(pos, E * C))
    c = torch.arange(C, device=dev)
    at = (start[:, :, None] + c).clamp_max(P - 1).reshape(B, E * C)
    slot_pair = torch.where((c < count[:, :, None]).reshape(B, E * C),
                            torch.gather(order, 1, at),
                            torch.full_like(at, P))
    return pair_slot, slot_pair


def _take(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """src (B, n, d), index (B, m) in [0, n] -> (B, m, d): row index[b, i]
    of src, zeros where the index is n."""
    B, n, d = src.shape
    pad = torch.cat([src, src.new_zeros(B, 1, d)], dim=1)
    return torch.gather(pad, 1, index[:, :, None].expand(B, index.shape[1],
                                                         d))


class _Take(torch.autograd.Function):
    """:func:`_take` of a one-to-one map: ``index`` picks each row of src
    at most once, and ``inverse`` (B, n), in [0, m], names the output row
    that picked each src row (m: none).  The gradient is the same gather
    through ``inverse``: no scatter-add."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _take(src, index)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return _take(grad, inverse), None, None


def _sum_over_k(y: torch.Tensor) -> torch.Tensor:
    """(..., k, d) -> (..., d), added in the order j = 0 .. k-1 in y's
    dtype (each add rounded), as the reference's scatter-add into zeros."""
    out = y[..., 0, :]
    for j in range(1, y.shape[-2]):
        out = out + y[..., j, :]
    return out


def _shared(params, x: torch.Tensor, act, matmul) -> torch.Tensor:
    return matmul(act(matmul(x, params["shared_gate"]))
                  * matmul(x, params["shared_up"]), params["shared_down"])


def _moe_core(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    act = ACTIVATIONS[cfg.activation]
    probs, gates, idx = _route(params, x, cfg)                # (B, S, .)

    # load-balancing aux loss (Switch): E * mean(frac_tokens * frac_prob)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx, E).float().mean(dim=(0, 1, 2))
    aux = E * (me * ce).sum()

    C = _capacity(S, cfg)                       # row-local capacity
    pair_slot, slot_pair = dispatch_maps(idx.reshape(B, S * k), E, C)
    pairs = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    buf = _Take.apply(pairs, slot_pair, pair_slot).view(B, E, C, d)
    h = (act(torch.matmul(buf, params["w_gate"]))
         * torch.matmul(buf, params["w_up"]))
    h = torch.matmul(h, params["w_down"])                     # (B, E, C, d)
    picked = _Take.apply(h.reshape(B, E * C, d), pair_slot, slot_pair)
    picked = picked * gates.reshape(B, S * k, 1).to(x.dtype)
    out = _sum_over_k(picked.view(B, S, k, d))
    if cfg.moe_shared_experts:
        out = out + _shared(params, x, act, torch.matmul)
    return out, aux


def moe_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """One token a row: x (B, d) -> (B, d), what :func:`_moe_core` gives
    at S = 1.  The router stays an fp32 ``torch.matmul``; each routed
    product is one ``tiered_matmul_experts`` launch over the B k (token,
    choice) rows, each shared one a ``tiered_matmul`` launch."""
    B, d = x.shape
    k = cfg.moe_top_k
    act = ACTIVATIONS[cfg.activation]
    _, gates, idx = _route(params, x, cfg)                    # (B, k)
    rows = x[:, None, :].expand(B, k, d).reshape(B * k, d)   # row b k + j
    expert = idx.reshape(-1).to(torch.int32)

    def routed(a, w):
        return ops.tiered_matmul_experts(a, w, expert)

    h = act(routed(rows, params["w_gate"])) * routed(rows, params["w_up"])
    y = routed(h, params["w_down"]).view(B, k, d) * gates[..., None].to(
        x.dtype)
    out = _sum_over_k(y)
    if cfg.moe_shared_experts:
        out = out + _shared(params, x, act, ops.tiered_matmul)
    return out
