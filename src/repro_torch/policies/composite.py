"""Composition: several policies on the same tensors in one step (the port
of ``repro.policies.composite``).

``policies.get("qm+qe")`` builds one. Sub-policy state is namespaced by
sub-policy name (``learn = {"qm": {...}, "qe": {...}}``); decisions combine
field-wise by ``min`` (each sub-policy constrains the field it adapts and
leaves the other at full width); weight quantizers run in registration
order (mantissa truncation before exponent clamping for "qm+qe", so
saturation cannot bring dropped mantissa bits back).

Draws. The JAX package folds one key per sub-policy; here every draw comes
from the step's one generator, in a fixed order: per period, each
sub-policy's act draw in registration order (``act_decision``), then per
layer each sub-policy's weight draws in registration order
(``weight_draws``, one dict of per-leaf integer bitlengths per layer).
Only the sub-policies that quantize weights draw for them and fake-quantize
them (``quantizes_weights``: not BitChop or BitWave).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.policies import base


@dataclasses.dataclass(frozen=True)
class CompositePolicy(base.Policy):
    policies: Tuple[base.Policy, ...] = ()

    @property
    def name(self):  # type: ignore[override]
        return "+".join(p.name for p in self.policies)

    @property
    def enabled(self):  # type: ignore[override]
        return any(p.enabled for p in self.policies)

    @property
    def adapts_exponent(self):  # type: ignore[override]
        return any(p.adapts_exponent for p in self.policies)

    @property
    def has_stash_grad(self):  # type: ignore[override]
        return any(p.has_stash_grad for p in self.policies)

    @property
    def requires_act_bits(self):  # type: ignore[override]
        return any(p.requires_act_bits for p in self.policies)

    @property
    def quantizes_weights(self):  # type: ignore[override]
        return any(p.quantizes_weights for p in self.policies)

    def _sub(self, fn):
        return {p.name: fn(p) for p in self.policies}

    def _state(self, state, p):
        return base.PolicyState(learn=state.learn[p.name],
                                ctrl=state.ctrl[p.name])

    def init_state(self, dims, device=None):
        states = self._sub(lambda p: p.init_state(dims, device))
        return base.PolicyState(
            learn={k: s.learn for k, s in states.items()},
            ctrl={k: s.ctrl for k, s in states.items()})

    def control_view(self, ctrl, dims):
        return self._sub(lambda p: p.control_view(ctrl[p.name], dims))

    def forward_view(self, learn, cview, dims):
        return self._sub(
            lambda p: p.forward_view(learn[p.name], cview[p.name], dims))

    def scan_slices(self, view, dims):
        return self._sub(lambda p: p.scan_slices(view[p.name], dims))

    def rem_slice(self, view, i, dims):
        return self._sub(lambda p: p.rem_slice(view[p.name], i, dims))

    def act_decision(self, pslice, generator, dims):
        man = exp = None
        for p in self.policies:
            d = p.act_decision(pslice[p.name], generator, dims)
            man = d.man_bits if man is None else torch.minimum(man,
                                                               d.man_bits)
            exp = d.exp_bits if exp is None else torch.minimum(exp,
                                                               d.exp_bits)
        return base.PrecisionDecision(man_bits=man, exp_bits=exp)

    def quantize_act(self, x, pslice, generator, dims):
        for p in self.policies:
            x = p.quantize_act(x, pslice[p.name], generator, dims)
        return x

    def weight_draws(self, pslice, generator, count, dims):
        return {p.name: p.weight_draws(pslice[p.name], generator, count, dims)
                for p in self.policies if p.quantizes_weights}

    def quantize_weight(self, w, pslice, n_int, dims):
        for p in self.policies:
            if p.quantizes_weights:
                w = p.quantize_weight(w, pslice[p.name], n_int[p.name], dims)
        return w

    def stash_grad(self, dh, h_q, pslice, dims):
        # A sub-policy without an estimator adds nothing (a controller's
        # slice holds integer bitlengths, which have no cotangent).
        return self._sub(
            lambda p: p.stash_grad(dh, h_q, pslice[p.name], dims)
            if p.has_stash_grad else {})

    def penalty(self, learn, lam, dims):
        return sum(p.penalty(learn[p.name], lam, dims)
                   for p in self.policies)

    def update_learn(self, learn, grads, dims):
        return self._sub(
            lambda p: p.update_learn(learn[p.name], grads[p.name], dims))

    def observe(self, ctrl, loss, lr_changed, dims):
        return self._sub(
            lambda p: p.observe(ctrl[p.name], loss, lr_changed, dims))

    def metrics(self, state, dims):
        out = {}
        for p in self.policies:
            out.update(p.metrics(self._state(state, p), dims))
        return out

    def snapshot(self, state):
        out = {}
        for p in self.policies:
            out.update(p.snapshot(self._state(state, p)))
        return out

    def decision_summary(self, state, dims):
        man, exp = float(dims.man_bits), float(dims.exp_bits)
        for p in self.policies:
            d = p.decision_summary(self._state(state, p), dims)
            man = min(man, d["man_bits"])
            exp = min(exp, d["exp_bits"])
        return {"man_bits": man, "exp_bits": exp}

    def layer_decisions(self, state, dims):
        per_sub = [p.layer_decisions(self._state(state, p), dims)
                   for p in self.policies]
        return [(min(d[0] for d in ds), min(d[1] for d in ds))
                for ds in zip(*per_sub)]
