"""SFP-compressed activation stashing (the port of ``repro.core.stash``).

The forward pass encodes each period's input activation as it is stashed
and the backward pass decodes it on the way back in (paper §V):

    h, extras, aux = sfp_scan(layer_fn, compress, decompress, h0, xs,
                              stash_grad)

  forward : for period i, stash c_i = compress(h_i, x_i) and compute
            (h_{i+1}, e_{i+1}, aux_i) = layer_fn(decompress(c_i, x_i), e_i,
            x_i) without saving anything else: compute consumes the
            quantized values (§IV-A1).
  backward: decompress c_i once, recompute the period under autograd and
            take its vector-Jacobian product for h, e_i, the period's
            parameters and its policy slice. Only the packed containers
            (and the small ``extras`` carry e_i) live across the
            forward/backward gap.

The JAX package writes this as a ``jax.custom_vjp`` around ``lax.scan``;
here each period is one ``torch.autograd.Function`` and the periods chain
through autograd. The gradient is straight-through at the stash boundary
(dL/dh = dL/dh_q); ``stash_grad`` adds the learned-bitlength (Quantum
Mantissa / Exponent) estimates from the realized stash to the policy
slice's cotangent. ``extras`` is a small differentiable side carry (the
MoE auxiliary loss summed over the layers), kept raw as JAX keeps it in
its ``extras_seq``; ``aux`` is each period's metrics, detached. Every
random draw a period makes is taken before it runs and stored in ``x``,
so the recompute sees the forward's draws.
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
    """What one period's autograd Function needs beyond its tensors; the
    forward leaves the period's detached ``aux`` metrics here."""

    def __init__(self, layer_fn, compress, decompress, stash_grad, x):
        self.layer_fn = layer_fn
        self.compress = compress
        self.decompress = decompress
        self.stash_grad = stash_grad
        self.x = x
        self.paths = [p for p, _ in float_leaves(x)]
        self.aux = None


class _StashedPeriod(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, extras, period: _Period, *leaves):
        c = period.compress(h, period.x)
        h_new, e_new, aux = period.layer_fn(period.decompress(c, period.x),
                                            extras, period.x)
        period.aux = {k: v.detach() for k, v in aux.items()}
        ctx.period = period
        ctx.stash = c
        ctx.save_for_backward(extras)
        return h_new, e_new

    @staticmethod
    def backward(ctx, dh, dextras):
        period = ctx.period
        need = ctx.needs_input_grad[3:]
        (extras,) = ctx.saved_tensors
        h_q = period.decompress(ctx.stash, period.x)
        with torch.enable_grad():
            hq = h_q.detach().requires_grad_(True)
            e_in = extras.detach().requires_grad_(True)
            subs = {p: t.detach().requires_grad_(n)
                    for (p, t), n in zip(float_leaves(period.x), need)}
            out, e_out, _ = period.layer_fn(hq, e_in,
                                            substitute(period.x, subs))
            wrt = [hq, e_in] + [subs[p] for p, n in zip(period.paths, need)
                                if n]
            grads = list(torch.autograd.grad((out, e_out), wrt,
                                             (dh, dextras),
                                             allow_unused=True))
        dh_prev, de_prev = grads.pop(0), grads.pop(0)
        leaf_grads = [grads.pop(0) if n else None for n in need]
        if period.stash_grad is not None:
            index = {p: i for i, p in enumerate(period.paths)}
            for p, g in float_leaves(period.stash_grad(dh, h_q, period.x)):
                i = index[p]
                if need[i]:
                    leaf_grads[i] = (g if leaf_grads[i] is None
                                     else leaf_grads[i] + g.to(
                                         leaf_grads[i].dtype))
        return (dh_prev, de_prev, None, *leaf_grads)


def sfp_scan(layer_fn: Callable[[torch.Tensor, torch.Tensor, Any],
                                Tuple[torch.Tensor, torch.Tensor, Any]],
             compress: Callable[[torch.Tensor, Any], Any],
             decompress: Callable[[Any, Any], torch.Tensor],
             h0: torch.Tensor, xs: List[Any],
             stash_grad: Optional[Callable[[torch.Tensor, torch.Tensor, Any],
                                           Any]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, List[Any]]:
    """Run ``layer_fn`` over the periods ``xs`` with a compressed stash.

    Args:
      layer_fn:   (h, extras, x) -> (h_new, extras_new, aux), one period;
                  ``extras`` is an f32 scalar that starts at 0, ``aux`` a
                  dict of metric tensors (no gradient).
      compress:   (h, x) -> packed (the stashed representation).
      decompress: (packed, x) -> h_q with h's shape and dtype.
      h0:         the first period's input.
      xs:         one nest of dicts/lists per period (parameters, policy
                  slice, integer draws); its float tensors are the
                  period's differentiable inputs.
      stash_grad: optional (dh, h_q, x) -> nest of cotangents, keyed like
                  ``x``, added to those of the recompute (QM / QE bitlength
                  gradients). ``dh`` is the period output's cotangent.

    Returns (h after the last period, the final extras, each period's
    detached aux).
    """
    h = h0
    extras = torch.zeros((), dtype=torch.float32, device=h0.device)
    aux = []
    for x in xs:
        period = _Period(layer_fn, compress, decompress, stash_grad, x)
        h, extras = _StashedPeriod.apply(h, extras, period,
                                         *[t for _, t in float_leaves(x)])
        aux.append(period.aux)
    return h, extras, aux


def identity_compress(h, x):
    """Baseline: stash the raw activation (remat with saved carries)."""
    del x
    return h


def identity_decompress(c, x):
    del x
    return c
