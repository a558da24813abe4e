"""Learned-bitlength policy: Quantum Mantissa (the port of
``repro.policies.quantum``; Quantum Exponent comes later).

One real-valued bitlength per tensor scope (per period x {act, w}, plus
remainder layers) is learned jointly with the model: the data gradient
flows through ``core.quantum_mantissa.qm_quantize`` at the weights and
through the stash estimator (``stash_grad``) at the activations, a
footprint-weighted penalty (eq. 7) pushes bits down, and the policy takes
a plain SGD step clipped to the container's range.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import containers
from repro_torch.core import quantum_mantissa as qm
from repro_torch.policies import base
from repro_torch.policies.base import jclip


@dataclasses.dataclass(frozen=True)
class _LearnedBitsPolicy(base.Policy):
    """Shared machinery: state layout, SGD update, penalty, estimators."""

    gamma: float = 0.1            # regularizer strength (eq. 7)
    init_bits: Optional[float] = None  # None -> container's full field
    lr: float = 0.01              # SGD learning rate for the bitlengths

    def _max_bits(self, dims: base.ScopeDims) -> int:
        raise NotImplementedError

    def _truncate(self, x, n_int):
        raise NotImplementedError

    # state -------------------------------------------------------------

    def init_state(self, dims, device=None):
        bits = (float(self._max_bits(dims)) if self.init_bits is None
                else float(self.init_bits))

        def full(n):
            return torch.full((n,), bits, dtype=torch.float32, device=device,
                              requires_grad=True)

        learn = {"act": full(dims.n_periods), "w": full(dims.n_periods),
                 "act_rem": full(dims.n_rem), "w_rem": full(dims.n_rem)}
        return base.PolicyState(learn=learn, ctrl={})

    def forward_view(self, learn, cview, dims):
        return learn

    def scan_slices(self, view, dims):
        return {"act": view["act"], "w": view["w"]}

    # estimators ---------------------------------------------------------

    def stash_grad(self, dh, h_q, pslice, dims):
        """Importance-weighted bitlength estimate from the realized stash:
        compare the stash against re-truncation at floor(n) (the mass a
        one-bit-tighter budget would lose) and scale by 1/frac, the
        inverse probability that the extra bit was drawn. ``dh`` is the
        period output's cotangent, as in the JAX package."""
        nf = jclip(pslice["act"].detach(), 0.0, float(self._max_bits(dims)))
        floor_n = torch.floor(nf).to(torch.int32)
        frac = nf - floor_n.to(torch.float32)
        diff = (h_q - self._truncate(h_q, floor_n)).to(torch.float32)
        dn = torch.sum(dh.to(torch.float32) * diff) / torch.clamp(frac,
                                                                  min=0.05)
        return {"act": dn, "w": torch.zeros((), dtype=torch.float32,
                                            device=dh.device)}

    # loss & updates -----------------------------------------------------

    def penalty(self, learn, lam, dims):
        top = float(self._max_bits(dims))
        total = sum(torch.sum(lam[k] * jclip(learn[k], 0.0, top))
                    for k in ("act", "w", "act_rem", "w_rem"))
        return torch.tensor(self.gamma, dtype=torch.float32,
                            device=total.device) * total

    def update_learn(self, learn, grads, dims):
        top = float(self._max_bits(dims))
        with torch.no_grad():
            return {k: torch.clamp(learn[k] - self.lr * grads[k], 0.0, top)
                    .requires_grad_() for k in learn}

    # reporting ----------------------------------------------------------

    def _means(self, state, dims):
        top = float(self._max_bits(dims))
        with torch.no_grad():
            return (torch.mean(torch.clamp(state.learn["act"], 0, top)),
                    torch.mean(torch.clamp(state.learn["w"], 0, top)))

    def _deployed_mean(self, state, dims) -> float:
        """Deployment bits: learned fractional bitlengths round up."""
        top = float(self._max_bits(dims))
        with torch.no_grad():
            cat = torch.cat([state.learn[k].reshape(-1)
                             for k in ("act", "act_rem")])
            return float(torch.mean(torch.ceil(torch.clamp(cat, 0.0, top))))


@dataclasses.dataclass(frozen=True)
class QMPolicy(_LearnedBitsPolicy):
    """Quantum Mantissa (§IV-A): learned per-scope mantissa bitlengths."""

    name = "qm"
    has_stash_grad = True

    def _max_bits(self, dims):
        return dims.man_bits

    def _truncate(self, x, n_int):
        return containers.truncate_mantissa(x, n_int)

    def act_decision(self, pslice, generator, dims):
        n = containers.stochastic_bitlength(pslice["act"], generator,
                                            dims.man_bits)
        return base.PrecisionDecision(
            man_bits=n, exp_bits=torch.tensor(dims.exp_bits,
                                              dtype=torch.int32))

    def weight_draws(self, pslice, generator, count, dims):
        return containers.stochastic_bitlength(
            pslice["w"], generator, dims.man_bits, shape=(count,))

    def quantize_weight(self, w, pslice, n_int, dims):
        return qm.qm_quantize(w, pslice["w"], n_int)

    def metrics(self, state, dims):
        act, w = self._means(state, dims)
        return {"qm_act_mean": act, "qm_w_mean": w}

    def decision_summary(self, state, dims):
        return {"man_bits": self._deployed_mean(state, dims),
                "exp_bits": float(dims.exp_bits)}
