"""Baseline policy: no adaptation. (The JAX package's fixed-bitlength
``static`` policy is not ported yet.)"""
from __future__ import annotations

import dataclasses

from repro_torch.policies import base


@dataclasses.dataclass(frozen=True)
class NonePolicy(base.Policy):
    """Full-precision baseline: every hook is a no-op."""

    name = "none"
    enabled = False
