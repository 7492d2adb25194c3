"""LR schedule: a pure function of the step counter, in f32 arithmetic as
the JAX package's ``optim/schedule.py`` computes it."""
from __future__ import annotations

import numpy as np


def linear_warmup_cosine(step: int, warmup: int, total: int,
                         min_ratio: float = 0.1) -> float:
    t = np.float32(step)
    if t < warmup:
        return float((t + np.float32(1.0)) / np.float32(max(warmup, 1)))
    prog = np.clip((t - np.float32(warmup))
                   / np.float32(max(total - warmup, 1)),
                   np.float32(0.0), np.float32(1.0))
    cos = np.float32(min_ratio) + np.float32((1 - min_ratio) * 0.5) * (
        np.float32(1.0) + np.cos(np.float32(np.pi) * prog))
    return float(cos)
