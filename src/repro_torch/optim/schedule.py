"""LR schedules."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, base_lr: float, warmup: int = 100,
                    total: int = 10000, min_frac: float = 0.1
                    ) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then cosine decay to
    ``min_frac * base_lr`` at ``total``; a float32 scalar tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, base_lr * cos)
