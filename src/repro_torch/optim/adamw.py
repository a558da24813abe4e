"""AdamW with decoupled weight decay, f32 moments, global-norm clipping
(the port of ``repro.optim.adamw``).

Moments are f32 whatever the parameter dtype; the update is computed in
f32 and cast back. The port updates parameters and moments in place (the
JAX package returns new trees): at full width a second copy of the
moments alone would be 21 GB. Step-count scalars are computed in f32
with numpy, as JAX computes them, so the two agree to f32 rounding.

Sharded parameters (DTensors, the sharded train step's) update through
their local shards, with moments of the same placements, and the clipping
norm is the norm over every shard of the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.stash import float_leaves
from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    m: Any          # f32 tensors shaped like the parameters
    v: Any
    count: int


def leaves(tree) -> List[torch.Tensor]:
    """The parameter tensors of a nest of dicts/lists, in order."""
    return [t for _, t in float_leaves(tree)]


def zeros_like(tree):
    """f32 zeros shaped like every tensor of a nest of dicts/lists, on its
    device (the moments; the error-feedback residual of
    ``train/grad_compress.py``)."""
    if isinstance(tree, dict):
        return {k: zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [zeros_like(v) for v in tree]
    if isinstance(tree, shd.DTensor):
        loc = torch.zeros(tree.to_local().shape, dtype=torch.float32,
                          device=tree.device)
        return shd.DTensor.from_local(loc, tree.device_mesh,
                                      tree.placements, run_check=False)
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def init(params) -> AdamWState:
    return AdamWState(m=zeros_like(params), v=zeros_like(params), count=0)


def global_norm(grads: List[torch.Tensor], params=None) -> torch.Tensor:
    """The norm of every gradient. With DTensor ``params`` (the leaves the
    gradients belong to) each gradient is its leaf's local shard: its
    squares count once over the ranks that replicate it, summed over the
    whole mesh."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
    ps = [] if params is None else params
    if not any(isinstance(p, shd.DTensor) for p in ps):
        return torch.sqrt(torch.sum(torch.stack(sq)))
    shards = [shd.sharding_of(p) for p in ps]
    total = torch.sum(torch.stack(
        [s / shd.replicas(sh) for s, sh in zip(sq, shards)]))
    return torch.sqrt(shd.all_reduce_(total, shd.mesh_group(shards[0].mesh)))


def update(grads: List[torch.Tensor], state: AdamWState, params,
           cfg: AdamWConfig, lr: float) -> Tuple[Any, AdamWState,
                                                  torch.Tensor]:
    """One step over ``grads`` (one f32 tensor per parameter leaf, in
    ``leaves(params)`` order). Returns (params, state, pre-clip grad
    norm); parameters and moments are updated in place."""
    norm = global_norm(grads, leaves(params))   # clipped to cfg.grad_clip
    scale = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-9), max=1.0)
    count = state.count + 1
    f32 = np.float32
    b1c = float(f32(1.0) - f32(cfg.b1) ** f32(count))
    b2c = float(f32(1.0) - f32(cfg.b2) ** f32(count))
    with torch.no_grad():
        for p, m, v, g in zip(*([shd.local(t) for t in leaves(tree)]
                                for tree in (params, state.m, state.v)),
                              grads):
            g = g.to(torch.float32) * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
            del g
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            pf = p.to(torch.float32)
            decay = cfg.weight_decay if p.dim() >= 2 else 0.0
            p.copy_((pf - lr * (step + decay * pf)).to(p.dtype))
    return params, AdamWState(m=state.m, v=state.v, count=count), norm
