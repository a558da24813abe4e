"""GPipe-style pipeline parallelism over a ring of ranks (the port of
``repro.distributed.pipeline``).

Layers split into S stages along a ``pipe`` mesh dim; each rank holds one
stage's parameters and microbatches stream through with the GPipe
schedule: (n_micro + S - 1) ticks, bubble included, each tick every rank
applies its stage to the activation it holds and passes the result to the
next rank of the ring (a send and a receive, ``batch_isend_irecv``). The
last stage's outputs are summed over the ring with zeros from the others,
so every rank returns them (the JAX package's masked ``psum``).

It is differentiable: the forward keeps each tick's graph, and the
backward walks the ticks in reverse, sending each received activation's
cotangent back round the ring (the transpose of JAX's ``ppermute``). Every
rank takes part in every tick's exchange, so the ranks never wait on an
exchange another rank skips.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.stash import float_leaves, substitute
from repro_torch.distributed import sharding as shd


def _ring(t: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``t`` to global rank ``dst`` while receiving a tensor like it
    from ``src``."""
    recv = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _Plan:
    def __init__(self, stage_fn, stage_params, group):
        self.stage_fn = stage_fn
        self.stage_params = stage_params
        self.group = group
        self.paths = [p for p, _ in float_leaves(stage_params)]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, x, *leaves):
        group = plan.group
        S, stage = dist.get_world_size(group), dist.get_rank(group)
        nxt = dist.get_global_rank(group, (stage + 1) % S)
        prv = dist.get_global_rank(group, (stage - 1) % S)
        n_micro = x.shape[0]
        ticks = n_micro + S - 1
        params = [t.detach().requires_grad_() for t in leaves]
        tree = substitute(plan.stage_params, dict(zip(plan.paths, params)))
        buf = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        graphs = []
        for t in range(ticks):
            h_in = (x[min(t, n_micro - 1)] if stage == 0 else buf).detach()
            h_in.requires_grad_()
            with torch.enable_grad():
                h = plan.stage_fn(tree, h_in)
            graphs.append((h_in, h))
            if stage == S - 1 and t >= S - 1:
                outs[t - (S - 1)] = h.detach()
            if t < ticks - 1:
                buf = _ring(h.detach(), nxt, prv, group) if S > 1 else \
                    h.detach()
        ctx.plan, ctx.graphs, ctx.params = plan, graphs, params
        ctx.ring = (nxt, prv)
        return shd.all_reduce_(outs, group)

    @staticmethod
    def backward(ctx, g_outs):
        plan, graphs, params = ctx.plan, ctx.graphs, ctx.params
        group = plan.group
        S, stage = dist.get_world_size(group), dist.get_rank(group)
        nxt, prv = ctx.ring
        n_micro = g_outs.shape[0]
        ticks = len(graphs)
        dx = torch.zeros_like(g_outs)
        dparams = [torch.zeros_like(p) for p in params]
        g_buf = torch.zeros_like(g_outs[0])
        for t in reversed(range(ticks)):
            # The cotangent of this tick's output: what the next rank's
            # use of it sent back, and the emitted microbatch's.
            if t < ticks - 1:
                g_h = (_ring(g_buf, prv, nxt, group) if S > 1 else g_buf)
            else:
                g_h = torch.zeros_like(g_buf)
            if stage == S - 1 and t >= S - 1:
                g_h = g_h + g_outs[t - (S - 1)]
            h_in, h = graphs[t]
            graphs[t] = None
            grads = torch.autograd.grad(h, [h_in] + params, g_h,
                                        allow_unused=True)
            for p, g in zip(dparams, grads[1:]):
                if g is not None:
                    p += g
            if stage == 0:
                dx[min(t, n_micro - 1)] += grads[0]
                g_buf = torch.zeros_like(g_buf)
            else:
                g_buf = grads[0]
        # x is the same on every rank: its gradient is stage 0's.
        return (None, shd.all_reduce_(dx, group), *dparams)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, group
                   ) -> torch.Tensor:
    """Run microbatches through the S stages of ``group`` (S its size).

    Args:
      stage_fn: (params, h) -> h of the same shape, the stage each rank
        applies to the activation it holds.
      stage_params: this rank's stage's parameters (a nest of dicts and
        lists of tensors): the rank of index s in ``group`` is stage s.
      x_micro: (n_micro, mb, ...) microbatches, the same on every rank.
      group: the process group of the ``pipe`` dim.

    Returns the (n_micro, mb, ...) outputs of the last stage, on every
    rank.
    """
    plan = _Plan(stage_fn, stage_params, group)
    return _Pipeline.apply(plan, x_micro,
                           *[t for _, t in float_leaves(stage_params)])
