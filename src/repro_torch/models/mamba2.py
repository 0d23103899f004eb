"""Mamba-2 (SSD) block and the chunked linear-recurrence engine
(counterpart of the reference package's ``models/mamba2.py``).

The SSD recurrence  S_t = a_t * S_{t-1} + k_t v_t^T,  y_t = S_t^T q_t  is
computed chunkwise: :func:`chunked_linear_scan` keeps the reference's
signature and (B, S, H, .) layout and runs through the ``ssd_scan`` kernel
and its backward kernel (via :mod:`..kernels.ops`), handing them permuted
views with k and q broadcast over H: nothing is copied.  The reference
computes the same scan in plain ``jnp`` (its Pallas kernel is not on the
model's path); here the model's scan is the kernel.

The one-token decode (:func:`mamba2_decode`) sends ``in_proj`` and
``out_proj`` through the ``tiered_matmul`` kernel, as every decode product
of the port, and updates the SSM state and the conv window in place (the
reference returns a new cache).  Its recurrence step is plain PyTorch, as
in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import dense_init, rms_norm


# ---------------------------------------------------------------------------
def chunked_linear_scan(a: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q: torch.Tensor, *, chunk: int = 256,
                        initial_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan of S_t = a_t S_{t-1} + k_t v_t^T ;  y_t = S_t^T q_t.

    a: (B, S, H) per-step decay in (0, 1]; k, q: (B, S, H, N);
    v: (B, S, H, P).  Returns y: (B, S, H, P) and final state (B, H, N, P),
    both fp32.  Chunks of Q = min(chunk, S), as the reference."""
    S = k.shape[1]
    t = lambda x: x.float().transpose(1, 2)          # noqa: E731  (B, H, S, .)
    y, final = ops.ssd_scan(t(a), t(k), t(v), t(q), chunk=min(chunk, S),
                            initial_state=(None if initial_state is None
                                           else initial_state.float()))
    return y.transpose(1, 2), final


def linear_scan_step(state: torch.Tensor, a: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Single-token recurrence step (decode), in place on ``state``.

    state: (B, H, N, P) fp32; a: (B, H); k, q: (B, H, N); v: (B, H, P).
    Returns y (B, H, P)."""
    state.mul_(a[..., None, None].float()).add_(
        torch.einsum("bhn,bhp->bhnp", k.float(), v.float()))
    return torch.einsum("bhnp,bhn->bhp", state, q.float())


# ---------------------------------------------------------------------------
def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    return d_in, N, d_in // cfg.ssm_head_dim, d_in + 2 * N


def init_mamba2_params(generator: torch.Generator, cfg: ArchConfig,
                       n_layers: int, dtype=torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """Stacked over a leading layer axis of ``n_layers``; ``a_log``,
    ``dt_bias`` and ``d_skip`` are fp32 whatever ``dtype`` is, as in the
    reference."""
    d, L = cfg.d_model, n_layers
    d_in, N, H, conv_ch = _dims(cfg)
    dev = generator.device
    return {
        # order: [z (d_in), x (d_in), B (N), C (N), dt (H)]
        "in_proj": dense_init(generator, (L, d, 2 * d_in + 2 * N + H), dtype),
        "conv_w": dense_init(generator, (L, cfg.ssm_conv, conv_ch), dtype,
                             scale=0.5),
        "conv_b": torch.zeros((L, conv_ch), dtype=dtype, device=dev),
        "a_log": torch.zeros((L, H), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((L, H), -2.0, dtype=torch.float32, device=dev),
        "d_skip": torch.ones((L, H), dtype=torch.float32, device=dev),
        "norm": torch.zeros((L, d_in), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (L, d_in, d), dtype),
    }


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    d_in, N, H, _ = _dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * N]
    dt = proj[..., d_in + d_in + 2 * N:]
    return z, xbc, dt, d_in, N, H


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU.  xbc: (B, S, C); w: (K, C).
    The K taps are summed in the reference's order."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _gate_and_project(params, y, xs, z, dtype, d_in: int) -> torch.Tensor:
    """y + xs * D, cast back to the model's dtype, gated RMS norm; returns
    the product's input (..., d_in)."""
    y = y + xs.float() * params["d_skip"][:, None]
    y = y.reshape(*y.shape[:-2], d_in).to(dtype)
    return rms_norm(y * F.silu(z), params["norm"])


def mamba2_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ArchConfig, *, chunk: int = 256) -> torch.Tensor:
    """Full-sequence Mamba-2 block.  x: (B, S, d) -> (B, S, d).  The
    projections are ``torch.matmul`` (the reference leaves them to XLA);
    the scan is the ``ssd_scan`` kernel."""
    B, S, _ = x.shape
    P = cfg.ssm_head_dim
    proj = torch.matmul(x, params["in_proj"])
    z, xbc, dt, d_in, N, H = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = xbc[..., :d_in].reshape(B, S, H, P)
    dt = F.softplus(dt.float() + params["dt_bias"])           # (B, S, H)
    a = torch.exp(dt * -torch.exp(params["a_log"]))           # decay in (0,1]
    # one (B, S, N) tensor each, broadcast over H (stride 0): no copy
    k = xbc[..., d_in:d_in + N].float()[:, :, None].expand(B, S, H, N)
    q = xbc[..., d_in + N:].float()[:, :, None].expand(B, S, H, N)
    v = xs * dt[..., None]
    y, _ = chunked_linear_scan(a, k, v, q, chunk=chunk)
    y = _gate_and_project(params, y, xs, z, x.dtype, d_in)
    return torch.matmul(y, params["out_proj"])


def init_mamba2_cache(cfg: ArchConfig, batch: int, device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """{"ssm": (batch, H, N, P) fp32, "conv": (batch, K - 1, C) bf16}."""
    d_in, N, H, conv_ch = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, N, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=torch.bfloat16, device=device),
    }


def mamba2_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cache: Dict[str, torch.Tensor],
                  cfg: ArchConfig) -> torch.Tensor:
    """One-token step.  x: (B, d) -> (B, d); ``cache["ssm"]`` and
    ``cache["conv"]`` (one layer's views) are updated in place."""
    B = x.shape[0]
    P = cfg.ssm_head_dim
    proj = ops.tiered_matmul(x, params["in_proj"])
    z, xbc, dt, d_in, N, H = _split_proj(proj, cfg)
    window = cache["conv"]
    win = torch.cat([window, xbc[:, None].to(window.dtype)], dim=1)  # (B,K,C)
    conv = F.silu((win * params["conv_w"][None]).sum(dim=1)
                  + params["conv_b"])
    window.copy_(win[:, 1:])
    xs = conv[:, :d_in].reshape(B, H, P)
    dt = F.softplus(dt.float() + params["dt_bias"])            # (B, H)
    a = torch.exp(dt * -torch.exp(params["a_log"]))
    k = conv[:, None, d_in:d_in + N].expand(B, H, N)
    q = conv[:, None, d_in + N:].expand(B, H, N)
    y = linear_scan_step(cache["ssm"], a, k, xs * dt[..., None], q)
    y = _gate_and_project(params, y, xs, z, x.dtype, d_in)
    return ops.tiered_matmul(y, params["out_proj"])
