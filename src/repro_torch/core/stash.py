"""SFP-compressed activation stashing (the port of ``repro.core.stash``).

The forward pass encodes each period's input activation as it is stashed
and the backward pass decodes it on the way back in (paper §V):

    h = sfp_scan(layer_fn, compress, decompress, h0, xs, stash_grad)

  forward : for period i, stash c_i = compress(h_i, x_i) and compute
            h_{i+1} = layer_fn(decompress(c_i, x_i), x_i) without saving
            anything else: compute consumes the quantized values (§IV-A1).
  backward: decompress c_i once, recompute the period under autograd and
            take its vector-Jacobian product for h, the period's
            parameters and its policy slice. Only the packed containers
            live across the forward/backward gap.

The JAX package writes this as a ``jax.custom_vjp`` around ``lax.scan``;
here each period is one ``torch.autograd.Function`` and the periods chain
through autograd. The gradient is straight-through at the stash boundary
(dL/dh = dL/dh_q); ``stash_grad`` adds the learned-bitlength (Quantum
Mantissa / Exponent) estimates from the realized stash to the policy slice's cotangent. The
JAX package also threads a small ``extras`` carry (MoE aux losses); the
port's dense family has no MoE, so it has none. Every random draw a
period makes is taken before it runs and stored in ``x``, so the
recompute sees the forward's draws.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Path = Tuple[Any, ...]


def float_leaves(tree, path: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, tensor) of every floating-point tensor in a nest of dicts
    and lists, in iteration order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in float_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in float_leaves(v, path + (i,))]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [(path, tree)]
    return []


def substitute(tree, subs: Dict[Path, torch.Tensor], path: Path = ()):
    """``tree`` with the leaves at the paths of ``subs`` (as given by
    ``float_leaves``) replaced."""
    if isinstance(tree, dict):
        return {k: substitute(v, subs, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [substitute(v, subs, path + (i,)) for i, v in enumerate(tree)]
    return subs.get(path, tree)


class _Period:
    """What one period's autograd Function needs beyond its tensors."""

    def __init__(self, layer_fn, compress, decompress, stash_grad, x):
        self.layer_fn = layer_fn
        self.compress = compress
        self.decompress = decompress
        self.stash_grad = stash_grad
        self.x = x
        self.paths = [p for p, _ in float_leaves(x)]


class _StashedPeriod(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, period: _Period, *leaves):
        c = period.compress(h, period.x)
        h_new = period.layer_fn(period.decompress(c, period.x), period.x)
        ctx.period = period
        ctx.stash = c
        return h_new

    @staticmethod
    def backward(ctx, dh):
        period = ctx.period
        need = ctx.needs_input_grad[2:]
        h_q = period.decompress(ctx.stash, period.x)
        with torch.enable_grad():
            hq = h_q.detach().requires_grad_(True)
            subs = {p: t.detach().requires_grad_(n)
                    for (p, t), n in zip(float_leaves(period.x), need)}
            out = period.layer_fn(hq, substitute(period.x, subs))
            wrt = [hq] + [subs[p] for p, n in zip(period.paths, need) if n]
            grads = list(torch.autograd.grad(out, wrt, dh,
                                             allow_unused=True))
        dh_prev = grads.pop(0)
        leaf_grads = [grads.pop(0) if n else None for n in need]
        if period.stash_grad is not None:
            index = {p: i for i, p in enumerate(period.paths)}
            for p, g in float_leaves(period.stash_grad(dh, h_q, period.x)):
                i = index[p]
                if need[i]:
                    leaf_grads[i] = (g if leaf_grads[i] is None
                                     else leaf_grads[i] + g.to(
                                         leaf_grads[i].dtype))
        return (dh_prev, None, *leaf_grads)


def sfp_scan(layer_fn: Callable[[torch.Tensor, Any], torch.Tensor],
             compress: Callable[[torch.Tensor, Any], Any],
             decompress: Callable[[Any, Any], torch.Tensor],
             h0: torch.Tensor, xs: List[Any],
             stash_grad: Optional[Callable[[torch.Tensor, torch.Tensor, Any],
                                           Any]] = None) -> torch.Tensor:
    """Run ``layer_fn`` over the periods ``xs`` with a compressed stash.

    Args:
      layer_fn:   (h, x) -> h_new, one period.
      compress:   (h, x) -> packed (the stashed representation).
      decompress: (packed, x) -> h_q with h's shape and dtype.
      h0:         the first period's input.
      xs:         one nest of dicts/lists per period (parameters, policy
                  slice, integer draws); its float tensors are the
                  period's differentiable inputs.
      stash_grad: optional (dh, h_q, x) -> nest of cotangents, keyed like
                  ``x``, added to those of the recompute (QM / QE bitlength
                  gradients). ``dh`` is the period output's cotangent.
    """
    h = h0
    for x in xs:
        period = _Period(layer_fn, compress, decompress, stash_grad, x)
        h = _StashedPeriod.apply(h, period,
                                 *[t for _, t in float_leaves(x)])
    return h


def identity_compress(h, x):
    """Baseline: stash the raw activation (remat with saved carries)."""
    del x
    return h


def identity_decompress(c, x):
    del x
    return c
