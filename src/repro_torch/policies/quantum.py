"""Learned-bitlength policies: Quantum Mantissa and Quantum Exponent
(the port of ``repro.policies.quantum``).

Both learn one real-valued bitlength per tensor scope (per period x
{act, w}, plus remainder layers) jointly with the model: the data gradient
flows through ``core.quantum_mantissa.qm_quantize`` /
``core.quantum_exponent.qe_quantize`` at the weights and through the stash
estimator (``stash_grad``) at the activations, a footprint-weighted
penalty (eq. 7) pushes bits down, and the policy takes a plain SGD step
clipped to [a lower bound (0 for QM, 2 for QE), the container's field].
``policies.get("qm+qe")`` composes them (``policies/composite.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import containers
from repro_torch.core import quantum_exponent as qe
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

    def _min_bits(self, dims: base.ScopeDims) -> float:
        """Lower bound of the learned bitlengths (the penalty keeps 0)."""
        return 0.0

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

    def rem_slice(self, view, i, dims):
        return {"act": view["act_rem"][i], "w": view["w_rem"][i]}

    # quantizers ---------------------------------------------------------

    def quantize_act(self, x, pslice, generator, dims):
        """The weights' quantizer on an activation (the CNN path): one
        draw of the act bitlength, then its estimator's forward."""
        n_int = self.weight_draws({"w": pslice["act"]}, generator, 1,
                                  dims)[0]
        return self.quantize_weight(x, {"w": pslice["act"]}, n_int, dims)

    # estimators ---------------------------------------------------------

    def stash_grad(self, dh, h_q, pslice, dims):
        """Importance-weighted bitlength estimate from the realized stash:
        compare the stash against re-truncation at floor(n) (the mass a
        one-bit-tighter budget would lose) and scale by 1/frac, the
        inverse probability that the extra bit was drawn. ``dh`` is the
        period output's cotangent, as in the JAX package."""
        nf = jclip(pslice["act"].detach(), self._min_bits(dims),
                   float(self._max_bits(dims)))
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
        lo = self._min_bits(dims)
        with torch.no_grad():
            return {k: torch.clamp(learn[k] - self.lr * grads[k], lo, top)
                    .requires_grad_() for k in learn}

    # reporting ----------------------------------------------------------

    def _means(self, state, dims):
        top = float(self._max_bits(dims))
        with torch.no_grad():
            return (torch.mean(torch.clamp(state.learn["act"], 0, top)),
                    torch.mean(torch.clamp(state.learn["w"], 0, top)))

    def _deployed_mean(self, state, dims) -> float:
        """Deployment bits: learned fractional bitlengths round up. The
        mean is JAX's ``jnp.mean``: the f32 sum times the f32 reciprocal
        of the count (13 periods of 7 bits give 7.0000005, which
        ``container_for_decision`` rounds up to 8), on every device."""
        top = float(self._max_bits(dims))
        with torch.no_grad():
            cat = torch.cat([state.learn[k].reshape(-1)
                             for k in ("act", "act_rem")])
            total = float(torch.sum(torch.ceil(
                torch.clamp(cat, self._min_bits(dims), top))))
        return float(np.float32(total) * np.float32(1.0 / cat.numel()))

    def _deployed_per_period(self, state, dims):
        """Per-period deployed act bitlengths (rounded up, host floats)."""
        top = float(self._max_bits(dims))
        with torch.no_grad():
            v = torch.ceil(torch.clamp(state.learn["act"],
                                       self._min_bits(dims), top))
            return [float(b) for b in v]


@dataclasses.dataclass(frozen=True)
class QMPolicy(_LearnedBitsPolicy):
    """Quantum Mantissa (§IV-A): learned per-scope mantissa bitlengths."""

    name = "qm"
    has_stash_grad = True
    requires_act_bits = True

    def _max_bits(self, dims):
        return dims.man_bits

    def _truncate(self, x, n_int):
        return containers.truncate_mantissa(x, n_int)

    def act_decision(self, pslice, generator, dims):
        n = containers.stochastic_bitlength(pslice["act"], generator,
                                            dims.man_bits)
        return base.PrecisionDecision(
            man_bits=n, exp_bits=torch.tensor(dims.exp_bits,
                                              dtype=torch.int32,
                                              device=n.device))

    def weight_draws(self, pslice, generator, count, dims):
        return containers.stochastic_bitlength(
            pslice["w"], generator, dims.man_bits, shape=(count,))

    def quantize_weight(self, w, pslice, n_int, dims):
        return qm.qm_quantize(w, pslice["w"], n_int)

    def metrics(self, state, dims):
        act, w = self._means(state, dims)
        return {"qm_act_mean": act, "qm_w_mean": w}

    def snapshot(self, state):
        return {"act": state.learn["act"], "w": state.learn["w"]}

    def decision_summary(self, state, dims):
        return {"man_bits": self._deployed_mean(state, dims),
                "exp_bits": float(dims.exp_bits)}

    def layer_decisions(self, state, dims):
        return [(b, float(dims.exp_bits))
                for b in self._deployed_per_period(state, dims)]


@dataclasses.dataclass(frozen=True)
class QEPolicy(_LearnedBitsPolicy):
    """Quantum Exponent (§IV): learned per-scope exponent bitlengths in
    [MIN_EXP_BITS, exp_bits], backed by ``containers.truncate_exponent``
    (underflow flushes, overflow saturates). Gentler defaults than QM: the
    field is smaller, and flushing a needed binade hurts more than a
    dropped mantissa bit."""

    gamma: float = 0.05

    name = "qe"
    adapts_exponent = True
    has_stash_grad = True
    requires_act_bits = True

    def _max_bits(self, dims):
        return dims.exp_bits

    def _min_bits(self, dims):
        return float(containers.MIN_EXP_BITS)

    def _truncate(self, x, e_int):
        return containers.truncate_exponent(x, e_int)

    def act_decision(self, pslice, generator, dims):
        e = containers.stochastic_bitlength(
            pslice["act"], generator, dims.exp_bits,
            min_bits=containers.MIN_EXP_BITS)
        return base.PrecisionDecision(
            man_bits=torch.tensor(dims.man_bits, dtype=torch.int32,
                                  device=e.device),
            exp_bits=e)

    def weight_draws(self, pslice, generator, count, dims):
        return containers.stochastic_bitlength(
            pslice["w"], generator, dims.exp_bits,
            min_bits=containers.MIN_EXP_BITS, shape=(count,))

    def quantize_weight(self, w, pslice, e_int, dims):
        return qe.qe_quantize(w, pslice["w"], e_int)

    def metrics(self, state, dims):
        act, w = self._means(state, dims)
        return {"qe_act_mean": act, "qe_w_mean": w}

    def snapshot(self, state):
        return {"act_e": state.learn["act"], "w_e": state.learn["w"]}

    def decision_summary(self, state, dims):
        return {"man_bits": float(dims.man_bits),
                "exp_bits": self._deployed_mean(state, dims)}

    def layer_decisions(self, state, dims):
        return [(float(dims.man_bits), b)
                for b in self._deployed_per_period(state, dims)]
