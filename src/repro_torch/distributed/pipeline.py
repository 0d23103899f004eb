"""Pipeline parallelism: a GPipe-style microbatch schedule over a
``stage`` mesh dim, each stage a rank, the activations handed round the
stage ring with ``batch_isend_irecv``.

Counterpart of the reference package's ``distributed/pipeline.py``.  Off
by default (the assigned shapes fit DP x TP), provided as the PP building
block for >2-pod scale-out: stages hold disjoint layer ranges;
microbatches stream through with boundary activations handed to the next
stage.  The bubble fraction is (S-1)/(M+S-1) for S stages and M
microbatches.

Each rank returns the whole (M, mb, ...) output: the last stage's is
broadcast over the stage group at the end.  That is what the reference's
``out_specs=P(None)`` declares; its returned array is stage 0's buffer,
zeros for S >= 2 (ROADMAP R8, P19).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from .. import _tree


def pipeline_forward(layer_fn: Callable, n_stages: int, n_microbatches: int,
                     mesh, stage_axis: str = "stage"):
    """Returns fn(stage_params, x_microbatches) -> y_microbatches.

    ``mesh``: a ``DeviceMesh`` with a dim named ``stage_axis`` of
    ``n_stages`` ranks.  ``stage_params``: tree with a leading stage dim,
    each rank reading its own row; ``x_microbatches``: (M, mb, ...) inputs,
    the same on every rank.  ``layer_fn(params_for_stage, x) -> x`` keeps
    x's shape.
    """
    S = n_stages
    if mesh[stage_axis].size() != S:
        raise ValueError(f"mesh dim {stage_axis!r} has "
                         f"{mesh[stage_axis].size()} ranks, not {S}")
    group = mesh.get_group(stage_axis)
    sid = mesh.get_local_rank(stage_axis)
    peer = [dist.get_global_rank(group, s) for s in range(S)]

    def run(stage_params: Any, xs: torch.Tensor) -> torch.Tensor:
        leaves, treedef = _tree.flatten(stage_params)
        params = _tree.unflatten(treedef, [p[sid] for p in leaves])
        M = xs.shape[0]
        if M != n_microbatches:
            raise ValueError(f"{M} microbatches, not {n_microbatches}")
        buf = torch.zeros_like(xs[0])             # this stage's next input
        outs = torch.zeros_like(xs)
        for t in range(M + S - 1):
            mb_idx = t - sid
            if 0 <= mb_idx < M:
                y = layer_fn(params, xs[mb_idx] if sid == 0 else buf)
            else:
                y = torch.zeros_like(buf)
            if sid == S - 1 and 0 <= t - (S - 1) < M:
                outs[t - (S - 1)] = y
            if S > 1:             # hand off to the next stage, as ppermute
                buf = torch.empty_like(y)
                for w in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, y.contiguous(),
                                   peer[(sid + 1) % S], group),
                        dist.P2POp(dist.irecv, buf, peer[(sid - 1) % S],
                                   group)]):
                    w.wait()
        if S > 1:
            dist.broadcast(outs, src=peer[S - 1], group=group)
        return outs

    return run
