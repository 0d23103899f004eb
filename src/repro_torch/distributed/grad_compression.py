"""Gradient compression for cross-pod reduction: int8 quantization with
error feedback.

Counterpart of the reference package's ``distributed/grad_compression.py``.
At 2+ pods the ``pod`` axis crosses the slower inter-pod links; compressing
gradients 4x (fp32->int8 with per-block scales) before the cross-pod
all-reduce cuts that traffic proportionally.  Error feedback (residual
carried to the next step) keeps convergence (1-bit Adam / EF-SGD lineage).

The reference's axis name is a process group here (a mesh dim's, from
``DeviceMesh.get_group(name)``).  As there, what is all-reduced is the
dequantized value ``sent``: the int8 codes and scales it stands for are
what a wire format would carry.  The quantizer gives the reference's bits
on the CPU and the same bits on a card: its divisions are tensor by tensor
(CUDA divides by a host scalar as a product with its reciprocal, which can
round a scale one unit in the last place apart), and it saturates the
codes to int8's range explicitly.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from .. import _tree


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q (n_blocks, block) int8, scale (n_blocks, 1) in x's dtype), x
    flattened and zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.view(-1, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = amax / amax.new_full((), 127.0)
    # a bf16 quotient can round to +-127.5, and then to 128: saturated to
    # int8's range as XLA's conversion is (a plain cast would wrap)
    q = torch.round(blocks / scale.clamp(min=1e-12)).clamp(-128, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape
                    ) -> torch.Tensor:
    """The fp32 values ``q`` codes (fp32 times the scale's dtype, as the
    reference's promotion), cut to ``shape``."""
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compressed_psum(x: torch.Tensor, group: Optional[dist.ProcessGroup], *,
                    block: int = 256, error: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 error-feedback all-reduce (sum) of ``x`` over ``group``.

    Returns (reduced value, new error residual)."""
    if error is not None:
        x = x + error
    q, scale = quantize_int8(x, block)
    sent = dequantize_int8(q, scale, x.shape)
    new_error = x - sent
    dist.all_reduce(sent, group=group)
    return sent, new_error


def tree_compressed_psum(tree: Any, group: Optional[dist.ProcessGroup],
                         errors: Any = None) -> Tuple[Any, Any]:
    leaves, treedef = _tree.flatten(tree)
    errs = (_tree.flatten_up_to(treedef, errors) if errors is not None
            else [None] * len(leaves))
    out, new_errs = [], []
    for leaf, err in zip(leaves, errs):
        r, e = compressed_psum(leaf, group, error=err)
        out.append(r)
        new_errs.append(e)
    return _tree.unflatten(treedef, out), _tree.unflatten(treedef, new_errs)
