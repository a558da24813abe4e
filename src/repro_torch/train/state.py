"""TrainState: everything a training step carries between steps."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim import adamw
from repro_torch.policies import PolicyState


class TrainState(NamedTuple):
    params: Any              # parameter dict, updated in place by AdamW
    opt: adamw.AdamWState
    # Precision-policy state (learned bitlengths + controller registers).
    pstate: PolicyState
    step: int
    gen: torch.Generator     # every draw of the step comes from here
    # Error-feedback residual of compressed gradients (f32, shaped like the
    # parameters; None without TrainConfig.grad_compress_bits).
    grad_residual: Any = None
