"""Learning-rate schedules, PyTorch port of ``repro.optim.schedule``.

A schedule maps the step count (an int, or a 0-d tensor) to a Python
float: the optimizers keep the step on the host.
"""
from __future__ import annotations

import math


def constant(value: float):
    return lambda step: float(value)


def warmup_cosine(peak: float, *, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warmup to ``peak`` then cosine decay to ``floor``."""

    def sched(step):
        step = float(step)
        if step < warmup_steps:
            return peak * step / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * prog))

    return sched


def inverse_sqrt(peak: float, *, warmup_steps: int):
    def sched(step):
        step = max(float(step), 1.0)
        if step < warmup_steps:
            return peak * step / max(warmup_steps, 1)
        return peak * math.sqrt(warmup_steps / step)

    return sched
