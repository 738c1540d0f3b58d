"""LR schedules (``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr, warmup_steps, total_steps,
                  min_ratio: float = 0.1):
    """Linear warmup to ``base_lr``, then cosine decay to ``min_ratio`` of
    it at ``total_steps``, in fp32. Every argument may be a number or a
    tensor (the multi-job step passes one value per bank row)."""
    dev = next((x.device for x in (step, base_lr, warmup_steps, total_steps)
                if isinstance(x, torch.Tensor)), None)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    step, base_lr = f32(step), f32(base_lr)
    warmup_steps, total_steps = f32(warmup_steps), f32(total_steps)
    warm = base_lr * step / torch.clamp_min(warmup_steps, 1.0)
    frac = (step - warmup_steps) / torch.clamp_min(total_steps - warmup_steps,
                                                   1.0)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
