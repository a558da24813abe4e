"""Controller policies: BitChop (mantissa) and BitWave (mantissa and
exponent), the port of ``repro.policies.bitwave``.

Both observe the per-batch training loss and steer network-wide integer
bitlengths through the eq. 8-9 EMA controller in ``core.bitchop``. They
learn nothing, so ``learn`` is empty and everything lives in ``ctrl``:
0-d tensors on the model's device, which the stash's fused pack reads
without a host sync. Weights stay untouched ("Presently, BitChop adjusts
the mantissa only for the activations", §IV-B); BitWave spends the same
controller's shrink decisions on the exponent field too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import bitchop
from repro_torch.policies import base


def _exp_bits(dims: base.ScopeDims, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(dims.exp_bits, dtype=torch.int32, device=like.device)


@dataclasses.dataclass(frozen=True)
class BitChopPolicy(base.Policy):
    """BitChop (§IV-B): loss-EMA controlled network-wide mantissa bits."""

    alpha: float = 0.1
    eps_alpha: float = 0.1
    eps_scale: float = 1.0
    max_bits: Optional[int] = None  # None -> container mantissa bits
    min_bits: int = 0
    period: int = 1
    warmup_steps: int = 8
    lr_change_hold: int = 100

    name = "bitchop"
    requires_act_bits = True

    @property
    def quantizes_weights(self):  # §IV-B: activations only
        return False

    def _cfg(self, dims: base.ScopeDims) -> bitchop.BitChopConfig:
        return bitchop.BitChopConfig(
            alpha=self.alpha, eps_alpha=self.eps_alpha,
            eps_scale=self.eps_scale,
            max_bits=(dims.man_bits if self.max_bits is None
                      else self.max_bits),
            min_bits=self.min_bits, period=self.period,
            warmup_steps=self.warmup_steps,
            lr_change_hold=self.lr_change_hold)

    def init_state(self, dims, device=None):
        return base.PolicyState(learn={},
                                ctrl=bitchop.init(self._cfg(dims), device))

    def control_view(self, ctrl, dims):
        return {"act": bitchop.effective_bits(ctrl, self._cfg(dims))}

    def forward_view(self, learn, cview, dims):
        return cview

    def scan_slices(self, view, dims):
        return {"act": view["act"].expand(dims.n_periods)}

    def rem_slice(self, view, i, dims):
        return {"act": view["act"]}

    def act_decision(self, pslice, generator, dims):
        n = pslice["act"].to(torch.int32)
        return base.PrecisionDecision(man_bits=n, exp_bits=_exp_bits(dims, n))

    def quantize_act(self, x, pslice, generator, dims):
        return base.ste_truncate(x, pslice["act"])

    def observe(self, ctrl, loss, lr_changed, dims):
        return bitchop.update(ctrl, loss, self._cfg(dims),
                              lr_changed=lr_changed)

    def metrics(self, state, dims):
        return {"bc_bits": bitchop.effective_bits(
            state.ctrl, self._cfg(dims)).to(torch.float32)}

    def snapshot(self, state):
        return {"bc_bits": state.ctrl.n}

    def decision_summary(self, state, dims):
        return {"man_bits": float(state.ctrl.n),
                "exp_bits": float(dims.exp_bits)}


@dataclasses.dataclass(frozen=True)
class BitWavePolicy(base.Policy):
    """BitWave: BitChop's controller driving mantissa AND exponent bits.
    One shrink budget per decision, spent round-robin (mantissa first);
    regressions grow both fields at once. The exponent truncation is
    ``containers.truncate_exponent`` (flush under, saturate over)."""

    alpha: float = 0.1
    eps_alpha: float = 0.1
    eps_scale: float = 1.0
    max_man_bits: Optional[int] = None  # None -> container field widths
    min_man_bits: int = 0
    max_exp_bits: Optional[int] = None
    min_exp_bits: int = 2
    period: int = 1
    warmup_steps: int = 8
    lr_change_hold: int = 100

    name = "bitwave"
    adapts_exponent = True
    requires_act_bits = True

    @property
    def quantizes_weights(self):  # like BitChop: activations only
        return False

    def _cfg(self, dims: base.ScopeDims) -> bitchop.BitWaveConfig:
        return bitchop.BitWaveConfig(
            alpha=self.alpha, eps_alpha=self.eps_alpha,
            eps_scale=self.eps_scale,
            max_man_bits=(dims.man_bits if self.max_man_bits is None
                          else self.max_man_bits),
            min_man_bits=self.min_man_bits,
            max_exp_bits=(dims.exp_bits if self.max_exp_bits is None
                          else self.max_exp_bits),
            min_exp_bits=self.min_exp_bits, period=self.period,
            warmup_steps=self.warmup_steps,
            lr_change_hold=self.lr_change_hold)

    def init_state(self, dims, device=None):
        return base.PolicyState(
            learn={}, ctrl=bitchop.bitwave_init(self._cfg(dims), device))

    def control_view(self, ctrl, dims):
        man, exp = bitchop.bitwave_effective(ctrl, self._cfg(dims))
        return {"act": man, "act_e": exp}

    def forward_view(self, learn, cview, dims):
        return cview

    def scan_slices(self, view, dims):
        return {k: v.expand(dims.n_periods) for k, v in view.items()}

    def rem_slice(self, view, i, dims):
        return view

    def act_decision(self, pslice, generator, dims):
        # Callers that drive only one bitlength (the CNN path) may omit
        # the exponent leaf; full width is the safe default.
        man = pslice["act"].to(torch.int32)
        exp = pslice.get("act_e")
        exp = _exp_bits(dims, man) if exp is None else exp.to(torch.int32)
        return base.PrecisionDecision(man_bits=man, exp_bits=exp)

    def quantize_act(self, x, pslice, generator, dims):
        return base.apply_decision_ste(
            x, self.act_decision(pslice, generator, dims), dims,
            adapts_exponent=True)

    def observe(self, ctrl, loss, lr_changed, dims):
        return bitchop.bitwave_update(ctrl, loss, self._cfg(dims),
                                      lr_changed=lr_changed)

    def metrics(self, state, dims):
        man, exp = bitchop.bitwave_effective(state.ctrl, self._cfg(dims))
        return {"bw_man_bits": man.to(torch.float32),
                "bw_exp_bits": exp.to(torch.float32)}

    def snapshot(self, state):
        return {"bw_man": state.ctrl.n_man, "bw_exp": state.ctrl.n_exp}

    def decision_summary(self, state, dims):
        return {"man_bits": float(state.ctrl.n_man),
                "exp_bits": float(state.ctrl.n_exp)}
