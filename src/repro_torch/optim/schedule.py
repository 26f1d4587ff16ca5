import math

import torch


def cosine_schedule(step, *, lr, warmup, total_steps, min_ratio=0.1):
    """Linear warm-up to `lr` over `warmup` steps, then a cosine decay to
    `min_ratio`·lr at `total_steps`: a 0-d float32 tensor on the device of
    `step` (the CPU for a Python int), computed in float32 as the
    reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                       0.0, 1.0)
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5
                * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
