"""AdaptivFloat-style policy: learned per-scope exponent bias offsets (the
port of ``repro.policies.afloat``).

On top of Quantum Exponent's learned exponent bitlengths, ``afloat``
learns one bias offset per scope, in binades, that slides the e-bit
window to where the tensor's magnitudes live
(``containers.truncate_exponent(..., bias_offset=round(b))``). The value
path is straight-through; the bias gradient is the two-sided difference
of the realized quantization, d loss / d b ~= g . (q(b+1) - q(b-1)) / 2.
Deployment maps through QE's dense ``sfp-m{K}e{E}`` containers (the
decision and summary methods are QE's).

Draws. The JAX package draws twice per weight tensor: QE's bitlength from
the leaf key, then the window's from ``fold_in(key, 10)``. Here both are
drawn before the period runs, from the step's generator: ``weight_draws``
returns a ``(count, 2)`` tensor, column 0 QE's bitlength and column 1 the
window's, leaf after leaf. ``quantize_act`` (the CNN path) draws the same
pair for the activation. On the decoder the stash goes through QE's
``act_decision``, as in the JAX package, so ``act_b`` never reaches the
forward there and stays at ``init_bias``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import containers
from repro_torch.core import quantum_exponent as qe
from repro_torch.policies import base
from repro_torch.policies.quantum import QEPolicy

_BIAS_KEYS = ("act_b", "w_b", "act_rem_b", "w_rem_b")


def _round_bias(b: torch.Tensor) -> torch.Tensor:
    """round(b) as int32 on b's device (half to even, as ``jnp.round``)."""
    return torch.round(b.detach().to(torch.float32)).to(torch.int32)


class _AfBiasShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e, b):
        bi = _round_bias(b)
        ctx.save_for_backward(x, e, bi)
        ctx.b_shape, ctx.b_dtype = b.shape, b.dtype
        return containers.truncate_exponent(x, e, bias_offset=bi)

    @staticmethod
    def backward(ctx, g):
        x, e, bi = ctx.saved_tensors
        db = None
        if ctx.needs_input_grad[2]:
            hi = containers.truncate_exponent(x, e, bias_offset=bi + 1)
            lo = containers.truncate_exponent(x, e, bias_offset=bi - 1)
            db = 0.5 * torch.sum(g.to(torch.float32)
                                 * (hi - lo).to(torch.float32))
            db = db.reshape(ctx.b_shape).to(ctx.b_dtype)
        # Straight-through in x; e learns through qe_quantize.
        return g, None, db


def af_bias_shift(x: torch.Tensor, e, b: torch.Tensor) -> torch.Tensor:
    """Re-clamp ``x`` to the e-bit window shifted by round(b) binades:
    straight-through in ``x``, no gradient in the drawn ``e``, the
    two-sided finite difference in the f32 bias ``b``."""
    return _AfBiasShift.apply(x, torch.as_tensor(e, device=x.device), b)


@dataclasses.dataclass(frozen=True)
class AFloatPolicy(QEPolicy):
    """QE bitlengths plus AdaptivFloat learned per-scope bias offsets."""

    bias_lr: float = 0.05
    init_bias: float = 0.0
    max_bias: float = 64.0  # |offset| cap in binades (past f32's range)

    name = "afloat"

    # state: QE's bitlengths plus one bias per scope ---------------------

    def init_state(self, dims, device=None):
        st = super().init_state(dims, device)

        def bias(n):
            return torch.full((n,), float(self.init_bias),
                              dtype=torch.float32, device=device,
                              requires_grad=True)

        learn = dict(st.learn, act_b=bias(dims.n_periods),
                     w_b=bias(dims.n_periods), act_rem_b=bias(dims.n_rem),
                     w_rem_b=bias(dims.n_rem))
        return base.PolicyState(learn=learn, ctrl=st.ctrl)

    def scan_slices(self, view, dims):
        return {"act": view["act"], "w": view["w"],
                "act_b": view["act_b"], "w_b": view["w_b"]}

    def rem_slice(self, view, i, dims):
        return {"act": view["act_rem"][i], "w": view["w_rem"][i],
                "act_b": view["act_rem_b"][i], "w_b": view["w_rem_b"][i]}

    # draws and quantizers: QE's range reduction, then the shifted window

    def weight_draws(self, pslice, generator, count, dims):
        return containers.stochastic_bitlength(
            pslice["w"], generator, dims.exp_bits,
            min_bits=containers.MIN_EXP_BITS, shape=(count, 2))

    def quantize_weight(self, w, pslice, e_int, dims):
        w = qe.qe_quantize(w, pslice["w"], e_int[0])
        return af_bias_shift(w, e_int[1], pslice["w_b"])

    def quantize_act(self, x, pslice, generator, dims):
        view = {"w": pslice["act"], "w_b": pslice["act_b"]}
        e_int = self.weight_draws(view, generator, 1, dims)[0]
        return self.quantize_weight(x, view, e_int, dims)

    def stash_grad(self, dh, h_q, pslice, dims):
        g = super().stash_grad(dh, h_q, pslice, dims)
        g.update({k: torch.zeros((), dtype=torch.float32, device=dh.device)
                  for k in ("act_b", "w_b") if k in pslice})
        return g

    # loss and updates: the biases are unpenalized and clip symmetrically

    def penalty(self, learn, lam, dims):
        core = {k: v for k, v in learn.items() if not k.endswith("_b")}
        return super().penalty(core, lam, dims)

    def update_learn(self, learn, grads, dims):
        lo = self._min_bits(dims)
        top = float(self._max_bits(dims))
        with torch.no_grad():
            out = {}
            for k in learn:
                if k.endswith("_b"):
                    v = torch.clamp(learn[k] - self.bias_lr * grads[k],
                                    -self.max_bias, self.max_bias)
                else:
                    v = torch.clamp(learn[k] - self.lr * grads[k], lo, top)
                out[k] = v.requires_grad_()
            return out

    # reporting ----------------------------------------------------------

    def metrics(self, state, dims):
        m = super().metrics(state, dims)
        with torch.no_grad():
            return {"af_act_e_mean": m["qe_act_mean"],
                    "af_w_e_mean": m["qe_w_mean"],
                    "af_act_bias_mean": torch.mean(state.learn["act_b"]),
                    "af_w_bias_mean": torch.mean(state.learn["w_b"])}

    def snapshot(self, state):
        return {"act_e": state.learn["act"], "w_e": state.learn["w"],
                "act_bias": state.learn["act_b"],
                "w_bias": state.learn["w_b"]}
