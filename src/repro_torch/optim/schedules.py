"""LR schedules, evaluated on the host in float32 like the reference's
jnp versions: a schedule maps a step to a Python float that is exactly an
f32 value."""
from __future__ import annotations

import numpy as np


def constant_lr(lr: float):
    return lambda step: float(np.float32(lr))


def warmup_step_decay(base_lr: float, warmup_steps: int, decay_steps=(),
                      decay_factor=0.1):
    decay_steps = tuple(decay_steps)
    f32 = np.float32

    def fn(step):
        s = f32(step)
        warm = f32(base_lr) * np.minimum(
            f32(1.0), (s + f32(1.0)) / f32(max(warmup_steps, 1)))
        drops = f32(sum(f32(s >= d) for d in decay_steps))
        return float(f32(warm * f32(decay_factor) ** drops))

    return fn
