"""Baseline policies: no adaptation, and fixed (Gist-style) bitlengths
(the port of ``repro.policies.static``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.policies import base


@dataclasses.dataclass(frozen=True)
class NonePolicy(base.Policy):
    """Full-precision baseline: every hook is a no-op."""

    name = "none"
    enabled = False


@dataclasses.dataclass(frozen=True)
class StaticPolicy(base.Policy):
    """Fixed bitlengths everywhere (the paper's Gist-style ablation).

    ``static_exp_bits=None`` keeps the container's full exponent; setting
    it runs the exponent truncation QE and BitWave drive adaptively.

    Departure from the JAX package: its ``quantize_weight`` applies the
    non-differentiable ``containers.truncate_mantissa``, so every weight
    matrix gets a zero gradient and never trains. Here the weight
    fake-quant is straight-through, like QM's; its forward values are the
    same bits."""

    static_act_bits: int = 3
    static_weight_bits: int = 7
    static_exp_bits: Optional[int] = None

    name = "static"

    @property
    def adapts_exponent(self):  # type: ignore[override]
        return self.static_exp_bits is not None

    def forward_view(self, learn, cview, dims):
        return {}

    def _exp(self, dims, device=None) -> torch.Tensor:
        e = dims.exp_bits if self.static_exp_bits is None else \
            self.static_exp_bits
        return torch.tensor(e, dtype=torch.int32, device=device)

    def _decision(self, man_bits, dims, device) -> base.PrecisionDecision:
        return base.PrecisionDecision(
            man_bits=torch.tensor(man_bits, dtype=torch.int32,
                                  device=device),
            exp_bits=self._exp(dims, device))

    def act_decision(self, pslice, generator, dims):
        """The fixed decision, on the device of the step's generator (where
        the stash's pack reads it)."""
        return self._decision(self.static_act_bits, dims,
                              None if generator is None else generator.device)

    def quantize_act(self, x, pslice, generator, dims):
        return base.apply_decision_ste(
            x, self._decision(self.static_act_bits, dims, x.device), dims,
            adapts_exponent=self.adapts_exponent)

    def quantize_weight(self, w, pslice, n_int, dims):
        return base.apply_decision_ste(
            w, self._decision(self.static_weight_bits, dims, w.device), dims,
            adapts_exponent=self.adapts_exponent)

    def decision_summary(self, state, dims):
        return {"man_bits": float(self.static_act_bits),
                "exp_bits": float(self.static_exp_bits
                                  if self.static_exp_bits is not None
                                  else dims.exp_bits)}
