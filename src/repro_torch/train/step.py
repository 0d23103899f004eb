"""Training step builder: loss -> grads (microbatched) -> AdamW update.

Counterpart of the reference package's ``train/step.py``, with its
``auto_microbatches`` (pure arithmetic).  ``microbatches
> 1`` accumulates fp32 gradients over slices of the batch (the
activation-memory knob that, with per-layer remat, bounds live activations
to one microbatch x one layer).  The parameters and the optimizer state
are updated in place (see :mod:`..optim.adamw`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from .. import _tree
from ..configs.base import ArchConfig
from ..models import lm
from ..optim import AdamWConfig, adamw_update


def _grads(params, cfg: ArchConfig, batch, remat: bool
           ) -> Tuple[List[torch.Tensor], Any, Dict[str, torch.Tensor]]:
    """(gradient leaves, treedef, detached loss metrics) of one batch."""
    leaves, treedef = _tree.flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    loss, metrics = lm.loss_fn(_tree.unflatten(treedef, live), cfg, batch,
                               remat=remat)
    # a leaf the batch does not reach (``frontend_proj`` without frontend
    # embeddings) gets a zero gradient, as under ``jax.grad``
    grads = torch.autograd.grad(loss, live, materialize_grads=True)
    return list(grads), treedef, {k: v.detach() for k, v in metrics.items()}


def _slices(batch: Dict[str, torch.Tensor], n: int):
    size = next(iter(batch.values())).shape[0] // n
    for i in range(n):
        yield {k: v[i * size:(i + 1) * size] for k, v in batch.items()}


def _accumulate(params, cfg, batch, microbatches: int, remat: bool,
                acc_dtype):
    """Gradients and metrics over ``microbatches`` slices, summed in
    ``acc_dtype`` and averaged, as the reference's scan."""
    if microbatches == 1:
        grads, treedef, metrics = _grads(params, cfg, batch, remat)
        return _tree.unflatten(treedef, grads), metrics
    acc, treedef, ms = None, None, []
    for mb in _slices(batch, microbatches):
        grads, treedef, m = _grads(params, cfg, mb, remat)
        if acc is None:
            acc = [torch.zeros(g.shape, dtype=acc_dtype, device=g.device)
                   for g in grads]
        for a, g in zip(acc, grads):
            a.add_(g.to(a.dtype))
        # a microbatch's gradients go before the next one's backward: the
        # step holds the accumulator and one microbatch's set, no more
        # (``g`` too: the loop variable would keep the last leaf alive)
        del grads, g
        ms.append(m)
    for a in acc:                   # the same bits as ``a / microbatches``
        a.div_(microbatches)
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return _tree.unflatten(treedef, acc), metrics


def build_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                     microbatches: int = 1, remat: bool = True,
                     lr: float = 3e-4) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); metrics hold ``loss``, ``aux``, ``grad_norm`` and ``step``."""

    def train_step(params, opt_state, batch):
        grads, metrics = _accumulate(params, cfg, batch, microbatches, remat,
                                     torch.float32)
        params, opt_state, opt_metrics = adamw_update(
            grads, params, opt_state, opt_cfg, lr)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = metrics.pop("nll")
        return params, opt_state, metrics

    return train_step


def build_grads_step(cfg: ArchConfig, *, microbatches: int = 1,
                     remat: bool = True) -> Callable:
    """Forward+backward only: grads_step(params, batch) -> (grads,
    metrics), microbatches summed in bfloat16 as the reference does."""

    def grads_step(params, batch):
        return _accumulate(params, cfg, batch, microbatches, remat,
                           torch.bfloat16)

    return grads_step


def auto_microbatches(cfg: ArchConfig, global_batch: int, seq_len: int,
                      dp: int, tp: int,
                      *, act_budget_bytes: float = 2e9) -> int:
    """Pick the microbatch count that bounds per-device live activations.

    With per-layer remat the live set is ~ one boundary activation per layer
    per microbatch: L x (tokens/dp) x d_model x 2 bytes / tp."""
    tokens_per_dp = global_batch * seq_len / dp
    per_layer = tokens_per_dp * cfg.d_model * 2 / tp
    if cfg.is_moe:
        # dispatch buffers / expert activations saved for backward
        per_layer *= 4
    total = per_layer * cfg.n_layers
    mb = 1
    while total / mb > act_budget_bytes and mb < global_batch:
        mb *= 2
    while global_batch % mb:
        mb *= 2
    return min(mb, global_batch)
