"""Learning-rate schedules (the port of ``repro/optim/schedule.py``): each
maps a step (an int or an integer tensor) to a 0-d f32 tensor."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    fn: object

    def __call__(self, step):
        return self.fn(step)


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float) -> Schedule:
    return Schedule(lambda step: torch.tensor(lr, dtype=torch.float32))


def linear_warmup_cosine(peak_lr: float, warmup: int, total: int,
                         floor: float = 0.0) -> Schedule:
    def fn(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return Schedule(fn)


def step_decay(lr: float, decay: float, every: int) -> Schedule:
    def fn(step):
        k = torch.floor_divide(_f32(step), every)
        return lr * torch.pow(torch.tensor(decay, dtype=torch.float32), k)
    return Schedule(fn)
