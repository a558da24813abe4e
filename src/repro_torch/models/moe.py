"""Mixture-of-Experts FFN: top-k routing with capacity and scatter dispatch
(the port of ``repro.models.moe``).

Dispatch is per batch row (one group a row): each (token, slot)
assignment gets a position within its expert from an exclusive cumulative
sum over the row's assignments in token-major order (token s, slot k at
s * K + k, so earlier tokens win a full expert), assignments past the
capacity C go to a drop bucket, and the kept tokens are scattered into an
(E * C, d) buffer. Each slot of the buffer receives at most one token, so
the scatter is exact. The experts run as batched matmuls over that
buffer, their outputs are gathered back and combined with the
renormalized gate weights. The router runs in f32 (its weight is f32 in a
bf16 model) and yields the Switch load-balance loss and the router
z-loss; the share of dropped assignments is a metric.

The JAX package computes the expert products as einsums outside any
Pallas kernel, so no hand-written kernel replaces them here either.

Expert parallelism (``moe_forward(shards=)``): the experts split over the
EP group (the mesh's ``model`` dim), each rank holding ``E / ep`` of them.
Routing and capacity stay per batch row, so each rank routes its own rows
in full. Where the EP ranks hold the same rows (the tp layout) each one
computes the router's logits for its own experts (gathered whole over
the group), scatters only into its own experts' slots and sums the
combined outputs over the group; no token moves. Where they hold
different rows (the fsdp layout) each builds its rows' buffer for every
expert and the expert slices go to their owners and back by an
all-to-all. The aux values are the global batch's: the per-rank means of
the router probabilities, the top-1 assignments, the squared
log-sum-exp and the kept assignments are averaged over the batch ranks
before the lb product, and where the EP ranks hold the same rows the aux
losses' gradient is counted once over the group (``sharding.shared``).

Decode under a mesh (``moe_decode(ep=, rows=)``) keeps the JAX package's
one capacity group over the whole batch: the rows are gathered over the
batch axes (B x d), routed together with the token-major cumsum, each EP
rank computes its own experts' slots of every row as the tp layout's
training does (the router cut to its experts' columns where it is whole,
as in the fsdp layout), the combined outputs are summed over the EP
group, and each rank keeps its own rows.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import common

# The logical axes of each leaf (the JAX package's ``ParamFactory`` names).
PARAM_AXES = {"router": ("embed", "experts"),
              "w_in": ("experts", "embed", "expert_ff"),
              "w_gate": ("experts", "embed", "expert_ff"),
              "w_out": ("experts", "expert_ff", "embed")}


class Shards(NamedTuple):
    """Where an MoE layer's experts and rows live under a mesh: ``ep`` the
    expert-parallel group (a ``sharding.TensorParallel``), ``exchange``
    whether its ranks hold different rows (the tokens then move by an
    all-to-all), ``batch`` the group of the batch ranks and ``n_batch``
    their number (the aux values' means span them)."""

    ep: Any
    exchange: bool
    batch: Any
    n_batch: int


def moe_init(cfg: ArchConfig, gen: torch.Generator, device, dtype
             ) -> Dict[str, torch.Tensor]:
    """The router (d, E) in f32 whatever ``dtype``, and the experts'
    ``w_in`` (E, d, ffe), ``w_out`` (E, ffe, d) and, with GLU, ``w_gate``
    (E, d, ffe) in ``dtype``; each N(0, 1 / shape[0]) as the JAX
    package's ``ParamFactory`` draws them, so the expert tensors at
    E ** -0.5 (their leading axis is the expert count)."""
    d, E, ffe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    params = {
        "router": common.normal_init((d, E), gen, device, torch.float32),
        "w_in": common.normal_init((E, d, ffe), gen, device, dtype),
        "w_out": common.normal_init((E, ffe, d), gen, device, dtype),
    }
    if cfg.glu:
        params["w_gate"] = common.normal_init((E, d, ffe), gen, device,
                                              dtype)
    return params


def capacity_for(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts
            * cfg.capacity_factor)
    return max(c, cfg.top_k)


def _exchanged(params, buf: torch.Tensor, cfg: ArchConfig, ep
               ) -> torch.Tensor:
    """``_experts`` over every expert of this rank's rows' buffer (B, E,
    C, d) when each rank of ``ep`` holds E / ep.size experts: the expert
    slices go to their owners, each runs its experts over every rank's
    rows, and the outputs come back."""
    B, E, C, d = buf.shape
    n = ep.size
    x = buf.reshape(B, n, E // n, C, d).transpose(0, 1)
    x = shd.all_to_all(x, ep.group).reshape(n * B, E // n, C, d)
    y = shd.all_to_all(_experts(params, x, cfg).reshape(n, B, E // n, C, d),
                       ep.group)
    return y.transpose(0, 1).reshape(B, E, C, d)


def _experts(params, buf: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The expert FFNs over the dispatch buffer (B, E, C, d) -> (B, E, C, d):
    one batched matmul a projection, experts as the batch."""
    B, E, C, d = buf.shape
    x = buf.transpose(0, 1).reshape(E, B * C, d)
    inner = torch.bmm(x, params["w_in"])
    a = common.activation(cfg.act)(inner.to(torch.float32)).to(buf.dtype)
    if cfg.glu:
        a = a * torch.bmm(x, params["w_gate"])
    out = torch.bmm(a, params["w_out"])
    return out.reshape(E, B, C, d).transpose(0, 1)


def select(params, h: torch.Tensor, cfg: ArchConfig, group=None):
    """The router's choice for h (B, S, d): (logits (B, S, E) f32, probs,
    gate weights (B, S, K), expert indices (B, S, K): the top-k). With
    ``group`` the router holds this rank's experts' columns and the logits
    are gathered whole over the group."""
    logits = shd.gather(h.to(torch.float32) @ params["router"], 2, group)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.topk(probs, cfg.top_k, dim=-1).indices
    return logits, probs, gates(probs, idx), idx


def gates(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The chosen experts' probabilities, renormalized to sum to one."""
    gate = probs.gather(-1, idx)
    return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)


def place(idx: torch.Tensor, cfg: ArchConfig):
    """Each assignment's position within its expert (B, S, K), from the
    exclusive cumsum over a row's assignments in token-major order, and
    the keep mask (position below the row's capacity)."""
    B, S, K = idx.shape
    onehot = F.one_hot(idx, cfg.n_experts).reshape(B, S * K, -1)
    pos = torch.cumsum(onehot, dim=1) - onehot            # exclusive
    pos = (pos * onehot).sum(-1).reshape(B, S, K)
    return pos, pos < capacity_for(cfg, S)


def route(params, h: torch.Tensor, cfg: ArchConfig, group=None):
    """``select`` then ``place``: (logits, probs, gate, idx, pos, keep)."""
    logits, probs, gate, idx = select(params, h, cfg, group)
    return (logits, probs, gate, idx) + place(idx, cfg)


def moe_forward(params, h: torch.Tensor, cfg: ArchConfig,
                shards: Optional[Shards] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """h (B, S, d) -> (B, S, d), and the aux values in f32:
    ``moe_lb_loss`` (E * sum(mean probs * mean top-1 one-hot)),
    ``moe_z_loss`` (mean squared log-sum-exp of the router logits) and
    ``moe_drop_frac`` (the share of assignments past capacity). Under
    ``shards`` ``h`` is this rank's rows, ``params`` its experts (and,
    where the EP ranks share the rows, its router columns), and the aux
    values are the global batch's (see the module's note)."""
    B, S, d = h.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity_for(cfg, S)
    ep = shards.ep if shards is not None else None
    shared = ep is not None and not shards.exchange
    group = ep.group if shared else None
    h = shd.copy_to(h, group)
    logits, probs, gate, idx, pos, keep = route(params, h, cfg, group)

    # The experts this rank's buffer holds: its own where the rows are
    # shared, else every one.
    n_loc, e0 = (E // ep.size, ep.rank * E // ep.size) if shared else (E, 0)
    mask = keep & (idx >= e0) & (idx < e0 + n_loc) if shared else keep
    seg = torch.where(mask, (idx - e0) * C + pos, n_loc * C).reshape(
        B, S * K)
    data = h[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d)
    buf = torch.scatter(h.new_zeros((B, n_loc * C + 1, d)), 1,
                        seg[..., None].expand(B, S * K, d), data)
    buf = buf[:, :n_loc * C].reshape(B, n_loc, C, d)

    out_buf = (_exchanged(params, buf, cfg, ep) if ep is not None and
               shards.exchange else _experts(params, buf, cfg))
    out_flat = out_buf.reshape(B, n_loc * C, d)
    gathered = torch.gather(
        out_flat, 1, torch.clamp_max(seg, n_loc * C - 1)[..., None].expand(
            B, S * K, d)).reshape(B, S, K, d)
    weight = (gate * mask.to(torch.float32)).to(h.dtype)
    out = shd.reduce((gathered * weight[..., None]).sum(2), group)

    # Every rank of a shared group computes the aux losses whole.
    probs, logits = shd.shared(probs, group), shd.shared(logits, group)
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(idx[..., 0], E).to(torch.float32).reshape(-1, E).mean(0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    kept = keep.to(torch.float32).mean()
    if shards is not None:
        # The means of the batch ranks' equal shares (one rank's bits).
        stats = shd.sum_over(torch.cat([me, ce, z[None], kept[None]]),
                             shards.batch) / shards.n_batch
        me, ce, z, kept = stats[:E], stats[E:2 * E], stats[-2], stats[-1]
    aux = {"moe_lb_loss": E * torch.sum(me * ce), "moe_z_loss": z,
           "moe_drop_frac": 1.0 - kept}
    return out, aux


def moe_decode(params, h: torch.Tensor, cfg: ArchConfig, ep=None,
               rows=None) -> torch.Tensor:
    """The single-token path: the whole batch (B, 1, d) routes as one
    group, so the capacity, max(int(B * K / E * cf), K), depends on B and
    can drop tokens (as the JAX package's does). Under a mesh ``h`` is
    this rank's rows, ``rows`` the group of the batch ranks (None: every
    rank holds every row) and ``ep`` the expert-parallel group's
    ``sharding.TensorParallel`` (the module's note)."""
    B, S, d = h.shape
    if S != 1:
        raise ValueError(f"moe_decode takes one token a row, got {S}")
    if ep is None:
        out, _ = moe_forward(params, h.reshape(1, B, d), cfg)
        return out.reshape(B, S, d)
    x = h.reshape(B, d)
    if rows is not None:
        x = shd.all_gather(x, 0, rows)
    E = cfg.n_experts
    router = params["router"]
    if router.shape[1] == E and ep.size > 1:
        n = E // ep.size
        router = router[:, ep.rank * n:(ep.rank + 1) * n]
    out, _ = moe_forward(dict(params, router=router), x[None], cfg,
                         shards=Shards(ep=ep, exchange=False, batch=None,
                                       n_batch=1))
    out = out[0]
    if rows is not None:
        r = dist.get_rank(rows)
        out = out[r * B:(r + 1) * B]
    return out.reshape(B, S, d)
