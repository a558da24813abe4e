"""Quantum Exponent: learning exponent bitlengths with gradient descent.

The port of ``repro.core.quantum_exponent`` (paper §IV), the exponent-side
sibling of Quantum Mantissa. A real-valued exponent bitlength e per tensor
scope is learned jointly with the model:

  forward  : q = T(x, floor(e) + Bernoulli(frac(e)))
  backward : dL/dx = dL/dq                                     (STE)
             dL/de = sum(dL/dq * (T(x, floor(e)+1) - T(x, floor(e))))

where T is ``containers.truncate_exponent`` (underflow flushes to zero,
overflow saturates). dL/de is the exact derivative of E[T(x, e)], which is
piecewise-linear in e. Exponent bitlengths live in [MIN_EXP_BITS,
exp_bits]. As in ``core.quantum_mantissa``, the caller draws the integer
bitlength and passes it in, so a recompute of the same layer sees the
same draw.
"""
from __future__ import annotations

import torch

from repro_torch.core import containers


class _QEQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e, e_int):
        ctx.save_for_backward(x, e)
        return containers.truncate_exponent(x, e_int)

    @staticmethod
    def backward(ctx, g):
        x, e = ctx.saved_tensors
        de = None
        if ctx.needs_input_grad[1]:
            spec = containers.spec_for(x)
            ef = torch.clamp(e.detach().to(torch.float32),
                             float(containers.MIN_EXP_BITS),
                             float(spec.exp_bits))
            floor_e = torch.floor(ef).to(torch.int32)
            ceil_e = torch.clamp(floor_e + 1, max=spec.exp_bits)
            # dE[T]/de = T(x, floor+1) - T(x, floor)   (0 once e >= exp_bits)
            diff = (containers.truncate_exponent(x, ceil_e)
                    - containers.truncate_exponent(x, floor_e))
            de = torch.sum(g.to(torch.float32) * diff.to(torch.float32))
            de = de.reshape(e.shape).to(e.dtype)
        return g.to(x.dtype), de, None


def qe_quantize(x: torch.Tensor, e: torch.Tensor,
                e_int: torch.Tensor) -> torch.Tensor:
    """T(x, e_int) with the Quantum Exponent gradients: straight-through
    for ``x`` and the expectation's slope for the f32 bitlength ``e``.
    ``e_int`` is the integer drawn from ``e`` for this use."""
    return _QEQuantize.apply(x, e, e_int)


def qe_quantize_deterministic(x: torch.Tensor, e) -> torch.Tensor:
    """Deployment-mode truncation: the learned bitlength rounds up
    (§IV-A4)."""
    spec = containers.spec_for(x)
    e_int = torch.clamp(torch.ceil(torch.as_tensor(e, dtype=torch.float32)),
                        containers.MIN_EXP_BITS, spec.exp_bits)
    return containers.truncate_exponent(x, e_int.to(torch.int32))
