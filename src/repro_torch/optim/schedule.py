"""LR schedules (the port of ``repro.optim.schedule``), evaluated on the
host in f32 with numpy, as the JAX package evaluates them in f32."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Schedule:
    kind: str = "cosine"            # 'cosine' | 'step' | 'constant'
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    boundaries: Tuple[int, ...] = ()  # step-decay drop points (x0.1)
    min_lr_frac: float = 0.1

    def __call__(self, step: int) -> float:
        f = np.float32
        s = f(step)
        warm = np.minimum(s / f(max(self.warmup_steps, 1)), f(1.0))
        if self.kind == "constant":
            lr = f(self.base_lr)
        elif self.kind == "step":
            lr = f(self.base_lr)
            for b in self.boundaries:
                if step >= b:
                    lr = lr * f(0.1)
        else:  # cosine
            frac = np.clip((s - f(self.warmup_steps))
                           / f(max(self.total_steps - self.warmup_steps, 1)),
                           f(0.0), f(1.0))
            cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * frac))
            lr = f(self.base_lr) * (f(self.min_lr_frac)
                                    + f(1 - self.min_lr_frac) * cos)
        return float(f(lr * warm))

    def lr_changed(self, step: int) -> bool:
        """True at step-decay boundaries."""
        return step in self.boundaries
