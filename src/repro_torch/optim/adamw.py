"""AdamW with an fp32 master copy and optional 8-bit quantized moments.

The optimizer state is the canonical Unimem offload victim (touched once
per step, 12-16 bytes a parameter in fp32): the runtime places it on the
host tier for HBM-constrained architectures.  Counterpart of the reference
package's ``optim/adamw.py``, with the same state keys (``master``, ``mu``,
``nu``, ``step``) and arithmetic.  Unlike the reference, which returns new
arrays (and the training loop donates the old ones), :func:`adamw_update`
updates the parameters and the state in place and returns the same
objects: at gemma-2b width a second copy of the 30 GB of state would not
fit beside the first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .. import _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True
    moments_dtype: str = "float32"     # "float32" | "bfloat16" | "int8"
    quant_block: int = 256


# ------------------------------------------------------------- int8 moments
def _quant(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise int8: (q (n_blocks, block) int8, scale (n_blocks, 1)
    fp32), zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.view(-1, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # tensor by tensor: CUDA divides by a host scalar through its
    # reciprocal, which can land an ulp away from the CPU's quotient
    scale = amax / amax.new_full((), 127.0)
    q = torch.round(blocks / scale.clamp(min=1e-12)).to(torch.int8)
    return q, scale.float()


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moments_dtype == "bfloat16" else torch.float32


# ----------------------------------------------------------------- opt state
def init_opt_state(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments, ``step`` 0 (an int32 scalar) and, with
    ``master_fp32``, an fp32 copy of the parameters."""
    leaves, treedef = _tree.flatten(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros_like_moment(p):
        if cfg.moments_dtype == "int8":
            q, s = _quant(torch.zeros(p.shape, device=p.device),
                          cfg.quant_block)
            return {"q": q, "s": s}
        return torch.zeros(p.shape, dtype=_moment_dtype(cfg), device=p.device)

    state = {
        "mu": _tree.unflatten(treedef, [zeros_like_moment(p) for p in leaves]),
        "nu": _tree.unflatten(treedef, [zeros_like_moment(p) for p in leaves]),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_fp32:
        state["master"] = _tree.unflatten(treedef, [
            p.to(torch.float32, copy=True) for p in leaves])
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the reference's order, of each
    leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in _tree.leaves(tree)))


def _read_moment(m, shape) -> torch.Tensor:
    """The moment in fp32: the state tensor itself for fp32 moments (so
    that updating it updates the state), a new tensor otherwise."""
    if isinstance(m, dict):
        return _dequant(m["q"], m["s"], shape)
    return m if m.dtype == torch.float32 else m.float()


def _write_moment(m, val: torch.Tensor, cfg: AdamWConfig) -> None:
    if isinstance(m, dict):
        q, s = _quant(val, cfg.quant_block)
        m["q"].copy_(q)
        m["s"].copy_(s)
    elif m is not val:
        m.copy_(val)


@torch.no_grad()
def adamw_update(grads: Any, params: Any, state: Dict[str, Any],
                 cfg: AdamWConfig, lr: float
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics) -- the
    same ``params`` and ``state`` objects, updated."""
    state["step"] += 1
    step_f = state["step"].float()
    gnorm = global_norm(grads)
    clip = torch.clamp(gnorm.new_tensor(cfg.grad_clip)
                       / gnorm.clamp(min=1e-12), max=1.0)
    bc1 = 1.0 - torch.pow(step_f.new_tensor(cfg.b1), step_f)
    bc2 = 1.0 - torch.pow(step_f.new_tensor(cfg.b2), step_f)

    flat_p, treedef = _tree.flatten(params)
    flat_g = _tree.leaves(grads)
    flat_mu = _tree.flatten_up_to(treedef, state["mu"])
    flat_nu = _tree.flatten_up_to(treedef, state["nu"])
    flat_ma = (_tree.leaves(state["master"]) if cfg.master_fp32
               else [None] * len(flat_p))
    for g, p, mu, nu, master in zip(flat_g, flat_p, flat_mu, flat_nu,
                                    flat_ma):
        g = g.float() * clip
        m = _read_moment(mu, g.shape)
        v = _read_moment(nu, g.shape)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        gg = g * (1 - cfg.b2)
        v.mul_(cfg.b2).add_(gg.mul_(g))
        del gg, g
        base = master if master is not None else p.float()
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        upd.add_(base * cfg.weight_decay)
        base.sub_(upd.mul_(lr))
        del upd
        _write_moment(mu, m, cfg)
        _write_moment(nu, v, cfg)
        p.copy_(base)
    return params, state, {"grad_norm": gnorm, "step": step_f}


def opt_state_bytes(params: Any, cfg: AdamWConfig) -> int:
    n = sum(t.numel() for t in _tree.leaves(params))
    per = 4 if cfg.master_fp32 else 0
    if cfg.moments_dtype == "int8":
        per += 2 * (1 + 4 / cfg.quant_block)
    elif cfg.moments_dtype == "bfloat16":
        per += 4
    else:
        per += 8
    return int(n * per)
