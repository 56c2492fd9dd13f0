"""Learning-rate schedules, pure functions of the step.  Counterpart of
``src/repro/optim/schedule.py``: each returns an fp32 0-d tensor, formed
in the reference's order of operations."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def linear_decay(peak_lr: float, total_steps: int):
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        return peak_lr * torch.clamp(1.0 - step / total_steps, 0.0, 1.0)
    return f
