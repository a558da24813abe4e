"""Logical-axis sharding rules (the port of ``repro.distributed.sharding``)
and the collectives the sharded train step computes with.

Parameters carry *logical* axis names (``DecoderModel.param_axes``); the
rules map them onto the dims of a ``torch.distributed`` ``DeviceMesh``:

  embed    -> data   (FSDP / ZeRO-3: weights shard their non-TP dim over
                      data; the model all-gathers them per layer and the
                      backward reduce-scatters their gradients)
  heads/ff/vocab/experts/lru/ssm_inner -> model   (tensor parallelism)
  batch    -> (pod, data)
  cache_seq-> model  (the decode KV cache's sequence, flash-decoding
                      style: each rank attends over its slots and the
                      ranks' partials are combined)

Anything unlisted is replicated. A leaf's sharding is a ``Sharding``: the
mesh and one ``Placement`` per mesh dim (``Shard(dim)`` or
``Replicate()``), the port's counterpart of a ``NamedSharding``. The train
state holds ``DTensor``s of those placements; the model computes on their
local shards and calls the differentiable collectives below itself, since
nothing in PyTorch partitions a whole step the way GSPMD does and the
port's kernels take plain contiguous tensors:

  gather    all-gather forward, reduce-scatter backward (an FSDP weight)
  reduce    all-reduce forward, identity backward (the partial output of a
            row-parallel product, or of a vocab-sharded embedding lookup)
  copy_to   identity forward, all-reduce backward (the input of a
            column-parallel product)
  all_to_all  an exchange of equal blocks, the inverse exchange backward
            (the expert-parallel dispatch of tokens that other ranks hold)

and the compositions ``sum_over`` (all-reduce both ways: a statistic
summed over ranks whose outputs differ) and ``shared`` (a value every
rank computes whole; its gradient divided by the group's size, since the
group sums it later). ``kept_axis`` says which leaves a layer keeps
sharded when it gathers its weights.

Sharded serving places each cache leaf by its logical axes, refined (a
dim the mesh does not divide stays whole), keeps it as a DTensor of the
rank's shard (``from_local``) and combines the
decode attention over the cache's sequence shards with ``lse_combine``
(each rank's normalized output and log-sum-exp, the packed caches' shard
view) or ``softmax_stats`` (the plain softmax's max and sum taken over
the ranks, for the caches read unpacked). In the fsdp layout the batch
already takes ``model``, so ``spec_from_axes`` drops ``cache_seq``'s
second use of it: the cache's sequence stays whole on each rank, and only
the tp layout combines over sequence shards.

The functions that only plan (``rules_for``, ``spec_from_axes``,
``refine_shardings``, ``batch_specs``) read nothing of a mesh but its dim
names and shape, so a ``MeshShape`` stands in for one without processes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.codecs.base import PackedTensor

Rules = Dict[str, Optional[Tuple[str, ...]]]


class MeshShape(NamedTuple):
    """A mesh's dim names and sizes, without processes (for planning)."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


class TensorParallel(NamedTuple):
    """This rank's place on the TP axis: its group, the axis size and its
    index along it."""

    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where one leaf lives: ``mesh`` and one placement per mesh dim."""

    mesh: Any
    placements: Tuple[Placement, ...]


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(_names(mesh), tuple(mesh.shape)))


def rules_for(mesh, *, fsdp: bool = True, layout: str = "tp") -> Rules:
    """Logical -> mesh mapping.

    layout='tp'   : TP over `model` (heads/ff/vocab/experts) + FSDP over
                    `data`; the default.
    layout='fsdp' : ZeRO-3 over both axes: weights and batch shard over
                    (data x model), no tensor parallelism, so the only
                    collectives are per-layer weight all-gathers and
                    gradient reduce-scatters (experts stay over model).
    """
    multi_pod = "pod" in _names(mesh)
    if layout == "fsdp":
        batch_axes = (("pod", "data", "model") if multi_pod
                      else ("data", "model"))
        return {
            "embed": batch_axes,
            "embed_r": None,
            "heads": None, "ff": None, "expert_ff": None, "vocab": None,
            "experts": ("model",),
            "lru": None, "ssm_inner": None, "state": None,
            "conv": None, "norm": None, "layers": None,
            "batch": batch_axes,
            "seq": None,
            "cache_seq": ("model",),
            "kv": None,
        }
    if layout != "tp":
        raise ValueError(f"unknown layout {layout!r}: 'tp' or 'fsdp'")
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        "embed": ("data",) if fsdp else None,
        "embed_r": None,
        "heads": ("model",),
        "ff": ("model",),
        "expert_ff": None,
        "vocab": ("model",),
        "experts": ("model",),
        "lru": ("model",),
        "ssm_inner": ("model",),
        "state": None,
        "conv": None,
        "norm": None,
        "layers": None,
        "batch": batch_axes,
        "seq": None,
        "cache_seq": ("model",),
        "kv": None,
    }


def spec_from_axes(axes: Tuple[Optional[str], ...], rules: Rules, mesh
                   ) -> Tuple[Placement, ...]:
    """The placements (one per mesh dim) of a leaf with logical ``axes``.
    A mesh dim shards at most one tensor dim: a later axis mapped to a dim
    already used stays replicated there. Several mesh dims on one tensor
    dim must come in mesh order (the first outermost, as a DTensor nests
    them)."""
    names = _names(mesh)
    placements = [Replicate()] * len(names)
    used = set()
    for dim, ax in enumerate(axes):
        target = rules.get(ax) if ax is not None else None
        if not target:
            continue
        target = tuple(t for t in target if t not in used)
        if not target:
            continue
        order = [names.index(t) for t in target]
        if order != sorted(order):
            raise ValueError(f"axis {ax!r} maps to {target}, out of the "
                             f"mesh's order {names}")
        used.update(target)
        for i in order:
            placements[i] = Shard(dim)
    return tuple(placements)


# Logical axes whose mesh dim a layer keeps sharded: a rank computes with
# its own heads, ff columns, vocab rows, experts or channels.
TP_AXES = frozenset({"heads", "ff", "vocab", "experts", "lru", "ssm_inner"})


def kept_axis(axes: Tuple[Optional[str], ...], sharding: Sharding,
              axis: str = "model") -> Optional[str]:
    """``axis`` when it shards a dim of the leaf whose logical axis is one
    of ``TP_AXES`` (the layer computes on that shard), else None (the
    layer gathers the leaf whole over it)."""
    names = _names(sharding.mesh)
    if axis not in names:
        return None
    p = sharding.placements[names.index(axis)]
    if isinstance(p, Shard) and axes[p.dim] in TP_AXES:
        return axis
    return None


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of a nest of dicts, lists, NamedTuples (a
    cache's ``KVCache``, ``PackedKV``, ``SSDCache``, ``LRUCache``) and
    ``PackedTensor`` parts, and of trees of the same structure in
    ``rest`` (whose leaves may be anything, e.g. axes tuples); ``is_leaf``
    stops the descent."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    if isinstance(tree, PackedTensor):
        return PackedTensor(tree.codec, tree.shape, tree.dtype, {
            k: tree_map(fn, v, *(r.data[k] for r in rest), is_leaf=is_leaf)
            for k, v in tree.data.items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_specs(axes_tree: Any, rules: Rules, mesh) -> Any:
    """A tree of logical-axes tuples -> a tree of placement tuples."""
    return tree_map(lambda a: spec_from_axes(a, rules, mesh), axes_tree,
                    is_leaf=_is_axes)


def tree_shardings(mesh, axes_tree: Any, rules: Optional[Rules] = None
                   ) -> Any:
    """A tree of logical-axes tuples -> a tree of ``Sharding``s."""
    return tree_map(lambda p: Sharding(mesh, p),
                    tree_specs(axes_tree, rules or rules_for(mesh), mesh),
                    is_leaf=lambda x: isinstance(x, tuple))


def batch_specs(rules: Rules, kind: str, has_cond: bool, mesh
                ) -> Dict[str, Sharding]:
    """The batch's shardings: rows over the rules' batch axes."""
    def rows(ndim):
        return Sharding(mesh, spec_from_axes(
            ("batch",) + (None,) * (ndim - 1), rules, mesh))
    specs = {"tokens": rows(2)}
    if kind == "train":
        specs["labels"] = rows(2)
    if has_cond and kind != "decode":
        specs["cond_embeddings"] = rows(3)
    return specs


def refine_shardings(shapes_tree: Any, shardings_tree: Any, mesh) -> Any:
    """Drop the sharding of every tensor dim the mesh dims on it do not
    divide (e.g. a batch of 1): a DTensor's shards must be even here, as
    JAX's jit ``in_shardings`` must divide. ``shapes_tree`` holds anything
    with a ``shape`` (tensors on the meta device)."""
    sizes = tuple(mesh.shape)

    def refine(leaf, sh):
        if not isinstance(sh, Sharding):
            return sh
        shape = tuple(leaf.shape)
        per_dim: Dict[int, int] = {}
        for i, p in enumerate(sh.placements):
            if isinstance(p, Shard):
                per_dim[p.dim] = per_dim.get(p.dim, 1) * sizes[i]
        placements = tuple(
            Replicate() if isinstance(p, Shard) and (
                p.dim >= len(shape) or shape[p.dim] % per_dim[p.dim])
            else p for p in sh.placements)
        return Sharding(sh.mesh, placements)

    return tree_map(refine, shapes_tree, shardings_tree,
                    is_leaf=lambda x: hasattr(x, "shape")
                    and not isinstance(x, (dict, list)))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, (Replicate(),) * len(_names(mesh)))


# --- the active mesh ------------------------------------------------------
# JAX's models read these at trace time for their sharding hints. The
# port's model takes its mesh explicitly and nothing in the port reads
# them: they are the module's public API, kept for callers that plan with
# the rules and held to JAX's in ``tests/test_torch_dist_rules.py``.

_ACTIVE_MESH: list = [None]
_ACTIVE_RULES: list = [None]


def set_active_mesh(mesh, rules: Optional[Rules] = None) -> None:
    _ACTIVE_MESH[0] = mesh
    _ACTIVE_RULES[0] = rules if rules is not None else (
        rules_for(mesh) if mesh is not None else None)


def active_mesh():
    return _ACTIVE_MESH[0]


def active_rules() -> Optional[Rules]:
    return _ACTIVE_RULES[0]


def batch_axis_for(mesh, size: int):
    """The batch's mesh axes (one name, or a tuple of several) when they
    divide ``size``, else None."""
    rules = _ACTIVE_RULES[0] or rules_for(mesh)
    axes = rules["batch"]
    sizes = axis_sizes(mesh)
    if size % math.prod(sizes[a] for a in axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def heads_target() -> Optional[str]:
    """Mesh axis for attention heads under the active rules (None: heads
    stay replicated, as in the fsdp layout)."""
    rules = _ACTIVE_RULES[0]
    if rules is None:
        return "model"
    t = rules.get("heads")
    return t[0] if t else None


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


# --- process groups and DTensors -------------------------------------------

_GROUPS: Dict[Any, Any] = {}


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank over the mesh dims ``axes`` (None
    for no dims). One dim is the mesh's own group; several are created
    once, by the members of each group only."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = _names(mesh)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.shape[i] for i in dims))
        me, group = dist.get_rank(), None
        for row in rows.tolist():
            if me in row:
                group = dist.new_group(row, use_local_synchronization=True)
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def mesh_group(mesh):
    """The group of every rank of ``mesh``."""
    return axes_group(mesh, _names(mesh))


def is_rank0(mesh) -> bool:
    """Whether this rank sits at the mesh's origin (its writer)."""
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def local_chunk(t: torch.Tensor, sharding: Sharding
                ) -> Optional[torch.Tensor]:
    """This rank's shard of the whole tensor ``t`` (None off the mesh)."""
    coord = sharding.mesh.get_coordinate()
    if coord is None:
        return None
    sizes = tuple(sharding.mesh.shape)
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            if t.shape[p.dim] % sizes[i]:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split over {sizes[i]} ranks (refine the "
                                 f"shardings first)")
            t = t.chunk(sizes[i], dim=p.dim)[coord[i]]
    return t


def distribute(t: torch.Tensor, sharding: Sharding) -> Optional[DTensor]:
    """The whole tensor ``t`` (the same on every rank) as a DTensor of
    ``sharding``: each rank keeps a copy of its shard, with no
    communication. None on a rank off the mesh."""
    loc = local_chunk(t.detach(), sharding)
    if loc is None:
        return None
    return DTensor.from_local(
        loc.clone(memory_format=torch.contiguous_format), sharding.mesh,
        list(sharding.placements), run_check=False)


def from_local(t: torch.Tensor, sharding: Sharding, shape) -> DTensor:
    """This rank's shard ``t`` (no copy) as the DTensor of a whole
    ``shape`` placed by ``sharding`` (the serving cache's leaves)."""
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, sharding.mesh, list(sharding.placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def sharding_of(x: DTensor) -> Sharding:
    return Sharding(x.device_mesh, tuple(x.placements))


def local(x):
    """A DTensor's local shard (a view of its storage); other leaves as
    they are."""
    return x.to_local() if isinstance(x, DTensor) else x


def full(x):
    """A DTensor gathered whole on every rank of its mesh (innermost mesh
    dim first); other leaves as they are."""
    if not isinstance(x, DTensor):
        return x
    mesh, t = x.device_mesh, x.to_local()
    for i in reversed(range(len(x.placements))):
        p = x.placements[i]
        if isinstance(p, Shard):
            t = all_gather(t, p.dim, mesh.get_group(_names(mesh)[i]))
    return t


def replicas(sharding: Sharding) -> int:
    """How many ranks hold each shard: the product of the replicated mesh
    dims."""
    return math.prod(n for n, p in zip(tuple(sharding.mesh.shape),
                                       sharding.placements)
                     if not isinstance(p, Shard))


def shard_axes(sharding: Sharding) -> Tuple[str, ...]:
    """The mesh dims that shard the leaf."""
    return tuple(n for n, p in zip(_names(sharding.mesh),
                                   sharding.placements)
                 if isinstance(p, Shard))


# --- collectives -------------------------------------------------------------

# PyTorch 2.13 renames ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
# to ``*_single`` and warns on the old names; older releases have only the
# old ones.
_all_gather_base = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter_base = getattr(dist, "reduce_scatter_single",
                               dist.reduce_scatter_tensor)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (not
    differentiable; ``gather`` is)."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_base(out, xt, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    gt = g.movedim(dim, 0).contiguous()
    out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]),
                      dtype=g.dtype, device=g.device)
    _reduce_scatter_base(out, gt, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (``op`` "sum" or "max"); None is no group."""
    if group is not None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def lse_combine(o: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """Join attention partials over sequence shards (flash-decoding): each
    rank's ``o`` (..., hd) f32 is its softmax over its own slots,
    normalized, and ``lse`` (...) the log-sum-exp of those scores (-inf
    where it saw none). Returns the softmax over every rank's slots, in
    f32: sum_r w_r o_r / sum_r w_r with w_r = exp(lse_r - max lse), by an
    all-reduce max and one all-reduce sum over ``group`` (None: this
    rank's slots are all; one rank gives its own ``o`` bit for bit)."""
    m = all_reduce_(lse.clone(), group, op="max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    num = all_reduce_(torch.cat([o * w, w], dim=-1), group)
    return num[..., :-1] / num[..., -1:]


def softmax_stats(s: torch.Tensor, group):
    """The max over the last dim of scores ``s`` split over ``group``'s
    ranks (each holds its slots), and the shifted exponentials with their
    sum over every rank: (exp(s - max), sum), the softmax's own
    arithmetic, so ``e / sum`` is the softmax over the whole dim."""
    m = all_reduce_(torch.amax(s, dim=-1, keepdim=True), group, op="max")
    e = torch.exp(s - m)
    return e, all_reduce_(torch.sum(e, dim=-1, keepdim=True), group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _reduce_scatter(g, ctx.dim, ctx.group)
        else:
            n = dist.get_world_size(ctx.group)
            g = g.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)].contiguous()
        return g, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def gather(x: torch.Tensor, dim: int, group, summed: bool = True
           ) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group``; the gradient is
    reduce-scattered back (summed over the group's partial gradients), or
    with ``summed=False`` each rank keeps its slice of its own gradient
    (every rank of the group computed the same whole gradient)."""
    return x if group is None else _Gather.apply(x, dim, group, summed)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of ``x`` (dim 0 in ``group``-size equal blocks) goes to
    rank j; returns the blocks received, in rank order. The gradient goes
    back by the inverse exchange (the same one)."""
    return x if group is None else _AllToAll.apply(x, group)


def shared(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged, where every rank of ``group`` computes it whole;
    its gradient divided by the group's size, so that the sum over the
    group a later collective takes counts it once."""
    return x if group is None else _Shared.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``, its gradient summed too: each rank's
    output differs, and every rank's share of the gradient of the sum is
    needed."""
    return copy_to(reduce(x, group), group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``; the gradient passes through."""
    return x if group is None else _Reduce.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def materialize(x: torch.Tensor, sharding: Sharding,
                keep: Optional[str] = None, same: Optional[str] = None
                ) -> torch.Tensor:
    """A leaf's local shard gathered over every mesh dim that shards it
    but ``keep`` (innermost first, so nested shards rejoin in order);
    differentiable. Over ``same`` every rank computes the whole leaf's
    same gradient (``gather(summed=False)``)."""
    names = _names(sharding.mesh)
    for i in reversed(range(len(names))):
        p = sharding.placements[i]
        if isinstance(p, Shard) and names[i] != keep:
            x = gather(x, p.dim, sharding.mesh.get_group(names[i]),
                       summed=names[i] != same)
    return x
