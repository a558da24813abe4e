"""Quantum Mantissa: learning mantissa bitlengths with gradient descent.

The port of ``repro.core.quantum_mantissa`` (paper §IV-A). A real-valued
bitlength n per tensor scope is learned jointly with the model:

  forward  : q = Q(x, floor(n) + Bernoulli(frac(n)))          (eq. 5, 6)
  backward : dL/dx = dL/dq                                     (STE)
             dL/dn = sum(dL/dq * (Q(x, floor(n)+1) - Q(x, floor(n))))

The dL/dn term is the exact derivative of E[Q(x, n)], which is
piecewise-linear in n. The JAX package draws the integer bitlength inside
its custom VJP from a replayable key; here the caller draws it
(``containers.stochastic_bitlength``) and passes it in, so a recompute of
the same layer sees the same draw.
"""
from __future__ import annotations

import torch

from repro_torch.core import containers


class _QMQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, n_int):
        ctx.save_for_backward(x, n)
        return containers.truncate_mantissa(x, n_int)

    @staticmethod
    def backward(ctx, g):
        x, n = ctx.saved_tensors
        dn = None
        if ctx.needs_input_grad[1]:
            spec = containers.spec_for(x)
            nf = torch.clamp(n.detach().to(torch.float32), 0.0,
                             float(spec.man_bits))
            floor_n = torch.floor(nf).to(torch.int32)
            ceil_n = torch.clamp(floor_n + 1, max=spec.man_bits)
            # dE[Q]/dn = Q(x, floor+1) - Q(x, floor)   (0 once n >= man_bits)
            diff = (containers.truncate_mantissa(x, ceil_n)
                    - containers.truncate_mantissa(x, floor_n))
            dn = torch.sum(g.to(torch.float32) * diff.to(torch.float32))
            dn = dn.reshape(n.shape).to(n.dtype)
        return g.to(x.dtype), dn, None


def qm_quantize(x: torch.Tensor, n: torch.Tensor,
                n_int: torch.Tensor) -> torch.Tensor:
    """Q(x, n_int) with the Quantum Mantissa gradients: straight-through
    for ``x`` and the expectation's slope for the f32 bitlength ``n``.
    ``n_int`` is the integer drawn from ``n`` for this use."""
    return _QMQuantize.apply(x, n, n_int)
