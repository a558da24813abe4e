"""Decoder model over the ported families: GLOBAL/LOCAL attention layers
with a dense MLP or a Mixture-of-Experts FFN (``models/moe.py``), Mamba-2
SSD layers (``models/mamba2.py``, no MLP) and RG-LRU layers
(``models/rglru.py``, with the MLP), in the config's period.

Parameters are a plain dict: ``embed``, ``final_norm`` and ``layers``, one
dict per layer in order (the JAX package stacks each period's layers and
scans over them; ``repro_torch.convert`` unstacks that tree), and an
untied model's ``head``. Training
runs ``loss`` / ``forward``: the periods go through ``core.stash.sfp_scan``
with the policy's container as the cross-pass activation stash (or, with
``stash_containers``, each period's own container: the per-layer plan of
``stash_plan``), and a policy that quantizes weights fake-quantizes them
at their use sites. The remainder layers (n_layers % len(period)) run
after the periods, outside the stash scan, each behind its own
straight-through stash decision (``apply_decision_ste``) and with its own
weight fake-quant. An MoE model's auxiliary losses ride the scan's
``extras`` carry into the loss, its routing metrics beside it. Serving runs
``prefill`` over the prompt and ``decode_step`` per token over a KV cache
that is updated in place — raw bf16, or packed by a registry codec
(``kv_container``): read through the fused decode kernel for the SFP
containers, unpacked whole for ``bit_exact`` and ``gecko8`` — or, for the
continuous-batching engine, ``decode_step_paged`` over a paged pool for
the GLOBAL layers and per-slot rings for the LOCAL ones. SSD and RG-LRU
layers keep a per-row recurrent state (and their conv inputs' tails) that
no codec packs.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``) and sharding
``rules`` (``distributed.sharding.rules_for``) the model trains on local
shards: ``param_axes`` names every leaf's logical axes, ``shardings`` is
where each leaf lives, and ``forward`` / ``loss`` take each leaf's local
shard. Each layer fake-quantizes its local shards under the policy, then
gathers them over the dims that shard them but the one it keeps
(``sharding.kept_axis``: the TP axis of its own heads, ff columns,
experts or channels; again in the stash recompute, whose backward
reduce-scatters their gradients), computes those under tensor
parallelism (``tp``) and sums its row-parallel outputs; the embedding,
logits and cross-entropy run across vocab shards, and every rank takes
its batch rows. MoE layers split their experts over ``model`` in both
layouts (``moe.Shards``), SSD layers their heads and RG-LRU layers their
channels in the tp layout. Attention heads that do not split over the TP
axis (``attention.kv_local``) are computed whole on every TP rank, their
weights gathered with a backward that keeps each rank's slice of the
same gradient.

Serving on a mesh: ``prefill`` and ``decode_step`` take the local shards
of the parameters (or their DTensors) and the whole batch of tokens, keep
the rank's rows, and return the whole batch's logits (gathered over the
vocab shards and the batch ranks, so a greedy pick is the one-device
pick) and the rank's cache (``serve.engine.cache_axes`` says where each
leaf lives: the KV sequence over ``model`` in the tp layout, the SSD
heads and RG-LRU channels with the rank's own). Each layer gathers its
weights as training does; attention serves through
``attention.DecodeShard`` (the attention module's note), MoE decode
routes the whole batch as one group (``moe.moe_decode(ep=, rows=)``),
SSD and RG-LRU layers step their own heads and channels. The paged
engine refuses a mesh (``serve.engine.PagedEngine``).
"""
from __future__ import annotations

import itertools
import math
from typing import (Any, Dict, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import NotYetPorted, codecs, policies, resolve_device
from repro_torch.configs.base import ArchConfig, GLOBAL, LOCAL, RGLRU, SSD
from repro_torch.core import containers, stash
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention, common, mamba2, moe, rglru
from repro_torch.serve import kvcache

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3
MOE_AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
KINDS = (GLOBAL, LOCAL, SSD, RGLRU)
# The logical axes of each layer block's leaves, by the block's key.
BLOCK_AXES = {"attn": attention.PARAM_AXES, "mlp": common.MLP_AXES,
              "moe": moe.PARAM_AXES, "ssd": mamba2.PARAM_AXES,
              "rglru": rglru.PARAM_AXES}
NORM_AXES = {"scale": ("embed",)}
KV_WEIGHTS = ("wk", "wv")
PAGED_MESH = ("paged serving under a mesh: the JAX package's paged pool has "
              "no sharding axes to port (ROADMAP §A, sharded serving)")


class LeafPlan(NamedTuple):
    """How a layer gathers one leaf: its ``sharding``, the mesh axis it
    keeps sharded (``keep``) and the one over which every rank computes
    the whole leaf's same gradient (``same``)."""

    sharding: Any
    keep: Optional[str]
    same: Optional[str]


class RunState(NamedTuple):
    """Per-step inputs of a training forward: the generator every draw of
    the step comes from, and the policy's forward view (opaque here)."""

    gen: Optional[torch.Generator]
    pol: Any


def scope_dims(cfg: ArchConfig) -> policies.ScopeDims:
    return policies.ScopeDims.for_dtype(cfg.compute_dtype,
                                        n_periods=cfg.n_periods,
                                        n_rem=len(cfg.remainder))


def _index(tree, i: int):
    """Entry ``i`` of every tensor in a nest of dicts (a policy's per-period
    scan slices)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _quantized(leaf: torch.Tensor) -> bool:
    """The weight leaves a policy fake-quantizes: every >= 2-D float."""
    return leaf.dim() >= 2 and leaf.is_floating_point()


META = torch.device("meta")


def _numel(tree) -> int:
    """Elements of every tensor in a nest of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return sum(_numel(t) for t in (tree.values() if isinstance(tree, dict)
                                   else tree))


def _axes_like(tree, table):
    """``table``'s axes tuples over the structure of the tensor nest
    ``tree``."""
    if isinstance(tree, dict):
        return {k: _axes_like(v, table[k]) for k, v in tree.items()}
    if len(table) != tree.dim():
        raise ValueError(f"axes {table} for a {tree.dim()}-D leaf")
    return table


def _sharding_leaves(tree, path=()):
    """(path, Sharding) of every leaf of a shardings nest, in
    ``float_leaves`` order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _sharding_leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _sharding_leaves(v, path + (i,))]
    return [(path, tree)]


def _count_truncation(count, h, t):
    """Add to ``count`` the values of ``h`` that the exponent truncation
    ``t`` flushed to zero and those it saturated."""
    for key, n in (("flushed", ((t == 0) & (h != 0)).sum()),
                   ("saturated", ((t != h) & (t != 0)).sum())):
        count[key] = count.get(key, 0) + n


class DecoderModel:
    def __init__(self, cfg: ArchConfig, policy=None,
                 kv_container: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 stash_containers: Optional[Sequence[str]] = None,
                 mesh=None, rules=None):
        """``policy``: a ``policies.Policy``, a registry name or None (full
        precision). ``device`` defaults to CUDA and raises without a GPU;
        pass ``device="cpu"`` for the plain path on the CPU.
        ``stash_containers`` (one codec name per period) packs each
        period's stash in its own container instead of the policy's: the
        per-layer realized containers of ``stash_plan``. Each period is its
        own compress/decompress pair in ``sfp_scan``, so a new plan needs
        only a new model. ``mesh`` and ``rules`` (default
        ``rules_for(mesh)``, the tp layout) make it a sharded model (see
        the module's note)."""
        bad = set(cfg.period) - set(KINDS)
        if bad:
            raise ValueError(f"{cfg.name}: unknown layer kinds {bad}")
        self.cfg = cfg
        self.policy = policies.coerce(policy)
        self.kv_container = kv_container
        if stash_containers is not None:
            stash_containers = tuple(stash_containers)
            if len(stash_containers) != cfg.n_periods:
                raise ValueError(
                    f"stash_containers needs one codec per period "
                    f"({cfg.n_periods}), got {len(stash_containers)}")
        self.stash_containers = stash_containers
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds()
        self.dims = scope_dims(cfg)
        # Debug counter of the stash's exponent truncation, off when None:
        # a dict to which every stash compress adds (as device tensors, so
        # without a host sync) the values it flushed to zero ("flushed")
        # and the values it saturated ("saturated").
        self.truncation_count: Optional[Dict[str, torch.Tensor]] = None
        self.mesh = mesh
        self.rules = (shd.rules_for(mesh) if mesh is not None and rules is None
                      else rules)
        self.shardings = self.tp = self._moe = None
        self.heads_mode = attention.KV_OWN
        self._embed_mesh = self._unembed_mesh = None
        # ``_decode_shard``'s plans by the cache's length, built once.
        self._decode_shards: Dict[int, attention.DecodeShard] = {}
        if mesh is not None:
            self._shard_init()

    # -- sharding ------------------------------------------------------------

    def param_axes(self) -> Dict[str, Any]:
        """The logical axes of every leaf of ``init``'s tree (the JAX
        package's ``param_axes``, one entry a layer instead of a leading
        ``layers`` axis)."""
        meta = self._draw(torch.Generator(), META)
        axes = {"embed": _axes_like(meta["embed"], common.EMBED_AXES),
                "final_norm": _axes_like(meta["final_norm"], NORM_AXES),
                "layers": [{k: _axes_like(v, NORM_AXES if k.endswith("norm")
                                          else BLOCK_AXES[k])
                            for k, v in lp.items()}
                           for lp in meta["layers"]]}
        if "head" in meta:
            axes["head"] = common.HEAD_AXES
        return axes

    def _shard_init(self):
        cfg, mesh = self.cfg, self.mesh
        self.batch_axes = tuple(self.rules["batch"])
        heads = self.rules.get("heads")
        self._tp_axis = heads[0] if heads else None
        if self._tp_axis is not None:
            # The vocab-parallel pieces of ``models.common`` take the
            # table's and the head's vocab shards over ``model``.
            if self._tp_axis != "model":
                raise ValueError(f"the TP axis must be named 'model', not "
                                 f"{self._tp_axis!r}")
            if {GLOBAL, LOCAL} & set(self.kinds):
                self.heads_mode = attention.kv_local(
                    cfg, shd.axis_sizes(mesh)["model"])
            self.tp = self._parallel("model")
            self._embed_mesh = self._unembed_mesh = mesh
        experts = self.rules.get("experts")
        if cfg.is_moe and experts:
            self._moe = moe.Shards(
                ep=self._parallel(experts[0]),
                exchange=experts[0] in self.batch_axes,
                batch=shd.axes_group(mesh, self.batch_axes),
                n_batch=self._batch_shards())
        axes = self.param_axes()
        planned = shd.tree_shardings(mesh, axes, self.rules)
        self.shardings = shd.refine_shardings(
            self._draw(torch.Generator(), META), planned, mesh)
        self._plans = self._plan(axes, planned, self.shardings)
        # Every layer of a kind shards alike.
        self._kind_plans = {}
        for kind, plan in zip(self.kinds, self._plans["layers"]):
            self._kind_plans.setdefault(kind, plan)

    def _parallel(self, axis: str) -> shd.TensorParallel:
        return shd.TensorParallel(self.mesh.get_group(axis),
                                  shd.axis_sizes(self.mesh)[axis],
                                  self.mesh.get_local_rank(axis))

    def _plan(self, axes, planned, refined, path=()):
        """The ``LeafPlan`` tree: a leaf keeps the axis
        ``sharding.kept_axis`` names, but the attention weights whose heads
        a rank does not own (the KV weights where the KV heads divide the
        TP degree; every weight where the heads are replicated, gathered
        with the same gradient on every TP rank). A leaf kept or gathered
        so must split evenly over that axis (ValueError)."""
        if isinstance(axes, dict):
            return {k: self._plan(v, planned[k], refined[k], path + (k,))
                    for k, v in axes.items()}
        if isinstance(axes, list):
            return [self._plan(v, planned[i], refined[i], path + (i,))
                    for i, v in enumerate(axes)]
        keep, same = shd.kept_axis(axes, planned), None
        if "attn" in path and keep is not None:
            if self.heads_mode == attention.REPLICATED:
                keep, same = None, keep
            elif (self.heads_mode == attention.KV_DIVIDE
                  and path[-1] in KV_WEIGHTS):
                keep = None
        axis = keep or same
        if axis is not None and shd.kept_axis(axes, refined) != axis:
            raise ValueError(f"{self.cfg.name}: {path} must split over the "
                             f"{axis} axis for tensor parallelism")
        return LeafPlan(refined, keep, same)

    def _tp_partial(self, path, plan: LeafPlan) -> bool:
        """Whether each TP rank computes only a share of the leaf's
        gradient while holding it whole over the TP axis: a leaf that axis
        does not shard inside a block that splits its heads, columns or
        channels over it (the head-dim norms, the KV weights a rank reads
        one head of, the SSD's ``w_B`` / ``w_C`` and their convs). Attention
        with replicated heads computes every gradient whole."""
        if (self._tp_axis is None or path[0] != "layers"
                or path[2] not in BLOCK_AXES):
            return False
        if path[2] == "attn" and self.heads_mode == attention.REPLICATED:
            return False
        return self._tp_axis not in shd.shard_axes(plan.sharding)

    def grad_reduce_axes(self) -> Dict[Tuple[Any, ...], Tuple[str, ...]]:
        """Per parameter leaf (by its ``float_leaves`` path), the mesh axes
        its local gradient must still be summed over after the backward:
        those it is replicated over while each rank computed only a share
        of its gradient (the batch axes, and the TP axis for
        ``_tp_partial`` leaves). Over the axes that shard it, the layer's
        gather already reduce-scattered the shares."""
        out = {}
        for path, plan in _sharding_leaves(self._plans):
            axes = set(self.batch_axes)
            if self._tp_partial(path, plan):
                axes.add(self._tp_axis)
            axes -= set(shd.shard_axes(plan.sharding))
            out[path] = tuple(a for a in self.mesh.mesh_dim_names
                              if a in axes)
        return out

    def _gather(self, tree, plans):
        """The local shards of a nest of leaves, each gathered whole but
        over its kept axis (``LeafPlan``); the nest itself without a
        mesh."""
        if self.mesh is None:
            return tree
        if isinstance(tree, dict):
            return {k: self._gather(v, plans[k]) for k, v in tree.items()}
        return shd.materialize(tree, plans.sharding, keep=plans.keep,
                               same=plans.same)

    def _kind_plan(self, kind):
        return self._kind_plans[kind] if self.mesh is not None else None

    def _gather_top(self, params, key: str):
        """``params[key]`` (the embedding, the final norm, the head) as
        ``_gather`` gives it."""
        return self._gather(params[key], self.mesh is not None
                            and self._plans[key])

    def local_params(self, params) -> Dict[str, Any]:
        """This rank's shards of whole parameters (the same on every rank),
        by ``shardings``; the tree itself without a mesh."""
        if self.mesh is None:
            return params
        return shd.tree_map(shd.local_chunk, params, self.shardings)

    def _rows(self, B: int):
        """This rank's rows of a B-row serving batch and the group of the
        batch ranks: (slice, group), or every row and None where the batch
        axes do not divide B (the rows then stay whole, as
        ``refine_shardings`` leaves them)."""
        n = self._batch_shards()
        if n == 1 or B % n:
            return slice(None), None
        idx = 0
        for a in self.batch_axes:
            idx = idx * shd.axis_sizes(self.mesh)[a] + \
                self.mesh.get_local_rank(a)
        return (slice(idx * B // n, (idx + 1) * B // n),
                shd.axes_group(self.mesh, self.batch_axes))

    def _decode_shard(self, L: int) -> Optional[attention.DecodeShard]:
        """How this rank serves an attention layer whose whole cache has L
        slots: None without a mesh. The sequence splits over the mesh dims
        that ``cache_seq`` maps to where they divide L (as
        ``sharding.refine_shardings`` places the cache). Built once an L."""
        if self.mesh is None:
            return None
        if L not in self._decode_shards:
            self._decode_shards[L] = self._plan_decode_shard(L)
        return self._decode_shards[L]

    def _plan_decode_shard(self, L: int) -> attention.DecodeShard:
        place = shd.spec_from_axes(attention.CACHE_AXES.k, self.rules,
                                   self.mesh)
        axes = tuple(a for a, p in zip(self.mesh.mesh_dim_names, place)
                     if isinstance(p, shd.Shard) and p.dim == 1)
        n = math.prod(shd.axis_sizes(self.mesh)[a] for a in axes)
        seq = None
        if axes and L % n == 0:
            group = shd.axes_group(self.mesh, axes)
            seq = shd.TensorParallel(group, n, dist.get_rank(group))
        tp = None if self.heads_mode == attention.REPLICATED else self.tp
        return attention.DecodeShard(tp, self.heads_mode, seq)

    def cache_axes(self, batch: int, max_len: int) -> Dict[str, Any]:
        """The logical axes of every leaf of ``init_cache(batch,
        max_len)`` (``serve.engine.cache_axes``)."""
        return {"layers": [self._layer_cache_axes(kind, batch, max_len)
                           for kind in self.kinds]}

    def _layer_cache_axes(self, kind: str, batch: int, max_len: int):
        if kind == SSD:
            return mamba2.CACHE_AXES
        if kind == RGLRU:
            return rglru.CACHE_AXES
        if self.kv_container is not None:
            return kvcache.packed_cache_axes(self.cfg, kind, batch, max_len,
                                             self.kv_container)
        return attention.CACHE_AXES

    def _cache_shardings(self, kind: str, batch: int, max_len: int):
        """One layer's cache shardings: each leaf placed by its logical
        axes, refined on its whole shape (a dim the mesh does not divide
        stays whole); with the whole shapes (meta tensors)."""
        whole = self._layer_cache(kind, batch, max_len, META)
        axes = self._layer_cache_axes(kind, batch, max_len)
        return shd.tree_map(
            lambda t, a: (shd.refine_shardings(t, shd.Sharding(
                self.mesh, shd.spec_from_axes(a, self.rules, self.mesh)),
                self.mesh), t.shape), whole, axes)

    def place_cache(self, cache: Dict[str, Any], batch: int, max_len: int
                    ) -> Dict[str, Any]:
        """A whole cache (the same on every rank, as ``init_cache`` or an
        unsharded prefill makes it) as this rank's DTensors; the cache
        itself without a mesh."""
        if self.mesh is None:
            return cache
        return {"layers": [shd.tree_map(
            lambda t, sh: shd.distribute(t, sh[0]), c,
            self._cache_shardings(kind, batch, max_len))
            for kind, c in zip(self.kinds, cache["layers"])]}

    def _as_dtensors(self, kind: str, local, batch: int, max_len: int):
        """One layer's cache of local shards as DTensors of its whole
        shapes and shardings."""
        return shd.tree_map(
            lambda t, sh: shd.from_local(t, sh[0], sh[1]), local,
            self._cache_shardings(kind, batch, max_len))

    def _logits(self, top, h: torch.Tensor, rows) -> torch.Tensor:
        """The serving logits (B, 1, V) f32 of final hidden states h: over
        a mesh, the vocab shards gathered over ``model`` and the rows over
        the batch ranks (``rows``, None where every rank holds them)."""
        cfg = self.cfg
        logits = common.unembed(top, h, tied=cfg.tie_embeddings,
                                softcap=cfg.final_softcap,
                                valid_vocab=cfg.vocab,
                                mesh=self._unembed_mesh)
        if self._unembed_mesh is not None:
            logits = shd.all_gather(logits, 2, self.tp.group)
        if rows is not None:
            logits = shd.all_gather(logits, 0, rows)
        return logits

    def _batch_shards(self) -> int:
        """How many ranks split the batch rows."""
        if self.mesh is None:
            return 1
        sizes = shd.axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)

    # -- parameters ----------------------------------------------------------

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        (normal, fan_in ** -0.5; embeddings unit scale; norms zero; an MoE
        layer's ``moe`` in place of ``mlp``, its router f32; an SSD or
        RG-LRU layer's block in place of ``attn`` (an SSD layer without
        ``mlp_norm`` and MLP), its vectors f32; an untied ``head`` of
        (d_model, padded vocab) last)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self._draw(gen, self.device)

    def _draw(self, gen, dev) -> Dict[str, Any]:
        """``init``'s tree, drawn from ``gen`` on ``dev``."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        params = {
            "embed": {"table": common.normal_init(
                (cfg.padded_vocab, cfg.d_model), gen, dev, dt, scale=1.0)},
            "final_norm": common.rmsnorm_init(cfg.d_model, dev, dt),
            "layers": [self._layer_init(kind, gen, dev, dt)
                       for kind in self.kinds],
        }
        if not cfg.tie_embeddings:
            # Drawn after every other leaf, so a tied model's weights do
            # not depend on this branch.
            params["head"] = common.normal_init(
                (cfg.d_model, cfg.padded_vocab), gen, dev, dt)
        return params

    def _layer_init(self, kind, gen, dev, dt) -> Dict[str, Any]:
        """One layer of ``kind``, drawn from ``gen``."""
        cfg = self.cfg
        layer = {"pre_norm": common.rmsnorm_init(cfg.d_model, dev, dt)}
        if kind == SSD:   # a Mamba-2 block carries no separate MLP
            layer["ssd"] = mamba2.ssd_init(cfg, gen, dev, dt)
            return layer
        if kind == RGLRU:
            layer["rglru"] = rglru.rglru_init(cfg, gen, dev, dt)
        else:
            layer["attn"] = attention.attn_init(cfg, gen, dev, dt)
        layer["mlp_norm"] = common.rmsnorm_init(cfg.d_model, dev, dt)
        if cfg.is_moe:
            layer["moe"] = moe.moe_init(cfg, gen, dev, dt)
        else:
            layer["mlp"] = common.mlp_init(cfg.d_model, cfg.d_ff, cfg.glu,
                                           gen, dev, dt)
        return layer

    def _emb_scale(self):
        return (self.cfg.d_model ** 0.5) if self.cfg.emb_scale else None

    # -- training ------------------------------------------------------------

    def _quantize_weights(self, slot_params, pslice, draws):
        """Fake-quantize every >= 2-D float leaf of one layer, leaf j with
        the j-th drawn bitlength (one draw per leaf, as the JAX package
        draws one key per leaf). A composite policy's ``draws`` is a dict
        of such vectors, one per sub-policy."""
        it = itertools.count()

        def pick(j):
            if isinstance(draws, dict):
                return {k: v[j] for k, v in draws.items()}
            return None if draws is None else draws[j]

        def quant(tree):
            if isinstance(tree, dict):
                return {k: quant(v) for k, v in tree.items()}
            if _quantized(tree):
                return self.policy.quantize_weight(tree, pslice,
                                                   pick(next(it)), self.dims)
            return tree

        return quant(slot_params)

    def _ffn(self, slot_params, hm):
        """The layer's FFN of the normed input ``hm``: the dense MLP, or
        the MoE with its aux values. Returns (out, extras loss
        MOE_LB_COEF * lb + MOE_Z_COEF * z, aux); None and None when
        dense."""
        cfg = self.cfg
        if not cfg.is_moe:
            return (common.mlp(slot_params["mlp"], hm, cfg.act, cfg.glu,
                               tp=self.tp), None, None)
        out, aux = moe.moe_forward(slot_params["moe"], hm, cfg,
                                   shards=self._moe)
        return out, (MOE_LB_COEF * aux["moe_lb_loss"]
                     + MOE_Z_COEF * aux["moe_z_loss"]), aux

    def _ffn_decode(self, slot_params, hm, rows=None):
        """The serving FFN of one token a row: MoE routes the batch as one
        group (``moe.moe_decode``; ``rows`` the batch ranks' group)."""
        cfg = self.cfg
        if cfg.is_moe:
            return moe.moe_decode(
                slot_params["moe"], hm, cfg, rows=rows,
                ep=self._moe.ep if self._moe is not None else None)
        return common.mlp(slot_params["mlp"], hm, cfg.act, cfg.glu,
                          tp=self.tp)

    def _apply_slot(self, slot_params, h, kind, *, positions, prefix_len):
        """One layer: (h, its extras loss, its aux values)."""
        cfg = self.cfg
        hn = common.rmsnorm(slot_params["pre_norm"], h)
        if kind == SSD:    # a Mamba-2 block carries no MLP
            return (h + mamba2.ssd_forward(slot_params["ssd"], hn, cfg,
                                           tp=self.tp), None, None)
        if kind == RGLRU:
            h = h + rglru.rglru_forward(slot_params["rglru"], hn, cfg,
                                        tp=self.tp)
        else:
            h = h + attention.attention_train(
                slot_params["attn"], hn, cfg, kind=kind,
                positions=positions, prefix_len=prefix_len,
                tp=(None if self.heads_mode == attention.REPLICATED
                    else self.tp))
        hm = common.rmsnorm(slot_params["mlp_norm"], h)
        out, eloss, aux = self._ffn(slot_params, hm)
        return h + out, eloss, aux

    def _codec_fns(self):
        """Stash compress/decompress/stash_grad closures; the raw
        activation when the policy is off. Each period's codec is
        ``x["codec"]`` (``_period_inputs``): the policy's container, or the
        period's own under a per-layer plan."""
        pol, dims = self.policy, self.dims
        if not pol.enabled:
            return stash.identity_compress, stash.identity_decompress, None

        def compress(h, x):
            # Fused quantize+pack: the drawn mantissa bitlength rides into
            # the pack kernel, one read of the activation. Exponent
            # truncation (QE) comes first, as plain elementwise work (the
            # JAX package has no kernel for it either): the container
            # stores the already-clamped exponents.
            act = x["draws"]["act"]
            if pol.adapts_exponent:
                t = containers.truncate_exponent(h, act["exp"])
                if self.truncation_count is not None:
                    _count_truncation(self.truncation_count, h, t)
                h = t
            return x["codec"].pack(h, bits=act["man"])

        def decompress(c, x):
            return x["codec"].unpack(c)

        stash_grad = None
        if pol.has_stash_grad:
            def stash_grad(dh, h_q, x):  # noqa: F811
                return {"pol": pol.stash_grad(dh, h_q, x["pol"], dims)}
        return compress, decompress, stash_grad

    def stash_plan(self, pstate: Optional[policies.PolicyState] = None
                   ) -> Tuple[str, ...]:
        """Per-period dense container names realized from the policy's
        current per-layer decisions (fresh state when ``pstate`` is None):
        each period's (man_bits, exp_bits) through ``codecs.dense_name``,
        so a period that learned 2 mantissa and 4 exponent bits stashes
        7-bit payloads while a precision-hungry neighbour keeps a wider
        container. On the host: pass the result as ``stash_containers`` to
        a new model when the plan changes."""
        pol = self.policy
        st = (pol.init_state(self.dims, self.device) if pstate is None
              else pstate)
        return tuple(codecs.dense_name(m, e)
                     for m, e in pol.layer_decisions(st, self.dims))

    def _draws(self, ps, layers, gen):
        """One scope's draws from ``gen``: its act decision (for "qm+qe",
        qm's draw then qe's), then per layer its weight draws (qm's for
        every leaf, then qe's) when the policy quantizes weights."""
        pol, dims = self.policy, self.dims
        d = pol.act_decision(ps, gen, dims)
        w = [pol.weight_draws(
            ps, gen, sum(1 for _, t in stash.float_leaves(lp)
                         if _quantized(t)), dims)
             for lp in layers] if pol.quantizes_weights else None
        return {"act": {"man": d.man_bits, "exp": d.exp_bits}, "w": w}

    def _period_inputs(self, params, run: RunState):
        """One ``sfp_scan`` input per period: its layers, its stash codec,
        its policy slice and every bitlength it draws, drawn here so the
        backward's recompute replays them. The order of the draws from
        ``run.gen``: period by period, ``_draws`` of each; then the
        remainder layers', one scope a layer (``_rem_inputs``, called
        after this). Layer i belongs to period i // len(period)."""
        cfg, pol, dims = self.cfg, self.policy, self.dims
        n_slot = len(cfg.period)
        slices = pol.scan_slices(run.pol, dims) if pol.enabled else None
        names = self.stash_containers or (pol.container,) * cfg.n_periods
        xs = []
        for p in range(cfg.n_periods):
            layers = params["layers"][p * n_slot:(p + 1) * n_slot]
            x = {"params": layers}
            if pol.enabled:
                ps = _index(slices, p)
                x["codec"] = codecs.get(names[p])
                x["pol"] = ps
                x["draws"] = self._draws(ps, layers, run.gen)
            xs.append(x)
        return xs

    def _rem_inputs(self, params, run: RunState):
        """Per remainder layer: its parameters, and under a policy its
        scope's slice (``rem_slice``) and ``_draws``, in layer order, after
        every period's draws."""
        cfg, pol = self.cfg, self.policy
        n_rem = len(cfg.remainder)
        xs = []
        for i, lp in enumerate(params["layers"][len(self.kinds) - n_rem:]):
            x = {"params": lp}
            if pol.enabled:
                x["pol"] = pol.rem_slice(run.pol, i, self.dims)
                x["draws"] = self._draws(x["pol"], [lp], run.gen)
            xs.append(x)
        return xs

    def _embed(self, params, tokens: torch.Tensor,
               cond_embeddings: Optional[torch.Tensor]):
        """The token embeddings, after a prefix-LM's ``cond_embeddings``
        (B, P, d_model) when given (P = ``cfg.prefix_tokens``; the frontend
        that makes them is a stub in both packages), in the compute dtype:
        (h (B, P + S, d), P)."""
        cfg = self.cfg
        h = common.embed(self._gather_top(params, "embed"), tokens,
                         self._emb_scale(), mesh=self._embed_mesh)
        if cond_embeddings is None:
            return h, 0
        P = cfg.prefix_tokens
        want = (tokens.shape[0], P, cfg.d_model)
        if not P or tuple(cond_embeddings.shape) != want:
            raise ValueError(
                f"{cfg.name}: cond_embeddings must be {want} (prefix_tokens "
                f"{P}), got {tuple(cond_embeddings.shape)}")
        cond = cond_embeddings.to(device=h.device, dtype=h.dtype)
        return torch.cat([cond, h], dim=1), P

    def forward(self, params, tokens: torch.Tensor, run: RunState,
                cond_embeddings: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence training forward: (logits (B, S, V) f32 over the
        token positions, metrics). A prefix-LM's ``cond_embeddings`` (B,
        P, d_model) go in front of the tokens as a prefix every position
        sees; the stash then holds all P + S positions. The metrics, as
        the JAX model's: ``moe_aux_loss`` (the MoE layers' weighted lb and
        z losses, summed; the loss adds it) and ``moe_lb_loss``,
        ``moe_z_loss``, ``moe_drop_frac`` (each period's sum over its
        layers, averaged over the periods); zeros for a dense model."""
        cfg, pol = self.cfg, self.policy
        h, P = self._embed(params, tokens, cond_embeddings)
        positions = torch.arange(h.shape[1], device=tokens.device)
        compress, decompress, stash_grad = self._codec_fns()

        def period_fn(h, extras, x):
            draws = x.get("draws")
            aux_sum = {}
            for i, kind in enumerate(cfg.period):
                sp = x["params"][i]
                if pol.quantizes_weights:
                    sp = self._quantize_weights(sp, x["pol"],
                                                draws["w"][i])
                sp = self._gather(sp, self._kind_plan(kind))
                h, eloss, aux = self._apply_slot(sp, h, kind,
                                                 positions=positions,
                                                 prefix_len=P)
                if eloss is not None:
                    extras = extras + eloss
                    aux_sum = {k: aux_sum[k] + aux[k] for k in MOE_AUX
                               } if aux_sum else aux
            return h, extras, aux_sum

        h, extras, aux = stash.sfp_scan(period_fn, compress, decompress, h,
                                        self._period_inputs(params, run),
                                        stash_grad)
        # Remainder layers, unrolled: the scope's stash decision realized
        # straight-through on the layer's input, its weights fake-quantized
        # with the scope's own bitlengths.
        for x, kind in zip(self._rem_inputs(params, run), cfg.remainder):
            lp = x["params"]
            if pol.enabled:
                act = x["draws"]["act"]
                h = policies.apply_decision_ste(
                    h, policies.PrecisionDecision(man_bits=act["man"],
                                                  exp_bits=act["exp"]),
                    self.dims, adapts_exponent=pol.adapts_exponent)
            if pol.quantizes_weights:
                lp = self._quantize_weights(lp, x["pol"], x["draws"]["w"][0])
            lp = self._gather(lp, self._kind_plan(kind))
            h, eloss, _ = self._apply_slot(lp, h, kind, positions=positions,
                                           prefix_len=P)
            if eloss is not None:
                extras = extras + eloss
        top = {k: self._gather_top(params, k)
               for k in ("embed", "final_norm", "head") if k in params}
        h = common.rmsnorm(top["final_norm"], h)
        if P:
            h = h[:, P:]
        logits = common.unembed(top, h, tied=cfg.tie_embeddings,
                                softcap=cfg.final_softcap,
                                valid_vocab=cfg.vocab,
                                mesh=self._unembed_mesh)
        metrics = {"moe_aux_loss": extras}
        for k in MOE_AUX:
            metrics[k] = (torch.stack([a[k] for a in aux]).mean()
                          if cfg.is_moe else
                          torch.zeros((), dtype=torch.float32,
                                      device=logits.device))
        return logits, metrics

    def loss(self, params, batch: Dict[str, torch.Tensor], run: RunState
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean cross-entropy + ``moe_aux_loss``, the forward's metrics
        with ``xent``). A prefix-LM's batch carries ``cond_embeddings``.
        Under a mesh, ``batch`` is this rank's rows and the loss and
        ``xent`` are its share of the global mean (its rows' mean over the
        number of batch shards): the shares summed over the batch ranks
        give the one-device values, and their gradients its gradient."""
        logits, metrics = self.forward(
            params, batch["tokens"], run,
            cond_embeddings=batch.get("cond_embeddings"))
        xent = common.softmax_xent(logits, batch["labels"],
                                   mesh=self._unembed_mesh)
        loss = xent + metrics["moe_aux_loss"]
        n = self._batch_shards()
        if n > 1:
            loss, xent = loss / n, xent / n
        return loss, dict(metrics, xent=xent)

    def layer_param_count(self, kind: Optional[str] = None) -> int:
        """Parameters of one layer of ``kind``, 1-D leaves included: the
        leaves of ``_layer_init``, drawn on the meta device (no memory).
        Without ``kind``, the count every layer of the model shares
        (ValueError if its kinds differ)."""
        cfg = self.cfg
        if kind is None:
            counts = {self.layer_param_count(k) for k in set(cfg.period)}
            if len(counts) > 1:
                raise ValueError(f"{cfg.name}: its layer kinds differ in "
                                 f"size; name one of {cfg.period}")
            return counts.pop()
        return _numel(self._layer_init(kind, torch.Generator(), META,
                                       cfg.compute_dtype))

    def param_count(self) -> int:
        """Parameters of the model: the leaves of ``init``, drawn on the
        meta device."""
        return _numel(self._draw(torch.Generator(), META))

    # -- serving -------------------------------------------------------------

    def _cache_len(self, kind: str, max_len: int) -> int:
        if self.kv_container is not None:
            return kvcache.cache_len(self.cfg, kind, max_len)
        return min(max_len, self.cfg.window) if kind == LOCAL else max_len

    def _layer_cache(self, kind: str, batch: int, max_len: int, dev=None):
        cfg, dt = self.cfg, self.cfg.compute_dtype
        dev = self.device if dev is None else dev
        if kind == SSD:
            return mamba2.ssd_cache_init(cfg, batch, dt, dev)
        if kind == RGLRU:
            return rglru.lru_cache_init(cfg, batch, dt, dev)
        if self.kv_container is not None:
            return kvcache.packed_cache_init(cfg, kind, batch, max_len,
                                             self.kv_container, device=dev)
        return attention.cache_init(cfg, kind, batch, max_len, dt, dev)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """One entry a layer: the attention layers' KV caches (packed with
        ``kv_container``), the SSD and RG-LRU layers' zero states; on a
        mesh, this rank's DTensors (``place_cache``)."""
        return self.place_cache(
            {"layers": [self._layer_cache(kind, batch, max_len)
                        for kind in self.kinds]}, batch, max_len)

    def prefill(self, params, tokens: torch.Tensor, max_len: int,
                cond_embeddings: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process a prompt (B, S), after a prefix-LM's ``cond_embeddings``
        (B, P, d_model) when given: (last-position logits (B, 1, V) f32,
        cache sized for ``max_len`` positions, at least P + S; decoding
        continues at position P + S). On a mesh see the module's note."""
        cfg = self.cfg
        B = tokens.shape[0]
        rows, row_group = self._rows(B)
        params = shd.tree_map(shd.local, params)
        tokens = tokens[rows]
        if cond_embeddings is not None:
            cond_embeddings = cond_embeddings[rows]
        h, P = self._embed(params, tokens, cond_embeddings)
        S = h.shape[1]
        max_len = max(max_len, S)
        positions = torch.arange(S, device=tokens.device)
        caches = []
        for lp, kind in zip(params["layers"], self.kinds):
            lp = self._gather(lp, self._kind_plan(kind))
            hn = common.rmsnorm(lp["pre_norm"], h)
            if kind == SSD:
                out, c = mamba2.ssd_forward(lp["ssd"], hn, cfg,
                                            return_cache=True, tp=self.tp)
            elif kind == RGLRU:
                out, c = rglru.rglru_forward(lp["rglru"], hn, cfg,
                                             return_cache=True, tp=self.tp)
            else:
                L = self._cache_len(kind, max_len)
                shard = self._decode_shard(L)
                out, (k, v) = attention.attention_train(
                    lp["attn"], hn, cfg, kind=kind, positions=positions,
                    prefix_len=P, return_kv=True,
                    tp=shard.tp if shard is not None else None)
                if kind == LOCAL:
                    k, v = attention.ring_pack_kv(k, v, L)
                else:
                    k = F.pad(k, (0, 0, 0, 0, 0, L - S))
                    v = F.pad(v, (0, 0, 0, 0, 0, L - S))
                k, v = attention.cache_shard(k, v, shard)
                c = attention.KVCache(k=k.to(cfg.compute_dtype),
                                      v=v.to(cfg.compute_dtype))
                if self.kv_container is not None:
                    c = kvcache.pack_prefill_cache(c, self.kv_container)
            h = h + out
            caches.append(c)
            if kind != SSD:    # a Mamba-2 block carries no MLP
                hm = common.rmsnorm(lp["mlp_norm"], h)
                h = h + self._ffn(lp, hm)[0]
        if self.mesh is not None:
            caches = [self._as_dtensors(kind, c, B, max_len)
                      for kind, c in zip(self.kinds, caches)]
        top = self._top(params)
        h = common.rmsnorm(top["final_norm"], h)
        return self._logits(top, h[:, -1:], row_group), {"layers": caches}

    def _top(self, params) -> Dict[str, Any]:
        """The embedding, final norm and head, each gathered as a layer
        gathers its leaves."""
        return {k: self._gather_top(params, k)
                for k in ("embed", "final_norm", "head") if k in params}

    def decode_step(self, params, cache: Dict[str, Any], token: torch.Tensor,
                    pos, tables: Optional[torch.Tensor] = None,
                    prefix_planes: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step, updating ``cache`` in place (an SSD or RG-LRU
        layer's entry is replaced by its new state). token (B, 1); ``pos``
        an int or (B,) absolute positions. Returns (logits (B, 1, V) f32,
        cache).

        With ``tables`` (B, nb) this is the continuous-batching paged
        step: GLOBAL layers of ``cache`` hold ``kvcache.PagedKV`` pool
        slices addressed through the tables, LOCAL layers per-slot packed
        rings read at per-row positions, SSD and RG-LRU layers a per-slot
        state row, stepped as in the contiguous path and replaced (idle
        slots carry pos 0 and a trash-block table row; their logits and
        state are garbage the engine discards or overwrites at the next
        prefill). ``prefix_planes`` makes every packed-attention read
        decode only the leading P' payload bits (the speculative draft);
        K/V writes stay full width. Both need ``kv_container``. On a mesh
        (the module's note) ``token`` and ``pos`` are the whole batch's
        and ``cache`` the rank's; the paged step refuses a mesh."""
        if (tables is not None or prefix_planes is not None) and \
                self.kv_container is None:
            raise ValueError("paged decode and prefix_planes (draft reads) "
                             "need a packed kv_container")
        if tables is not None and self.mesh is not None:
            raise NotYetPorted(PAGED_MESH)
        cfg = self.cfg
        B = token.shape[0]
        rows, row_group = self._rows(B)
        params = shd.tree_map(shd.local, params)
        pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
        pos = pos.reshape(-1).expand(B)[rows].contiguous()
        token = token[rows]
        h = common.embed(self._gather_top(params, "embed"), token,
                         self._emb_scale(), mesh=self._embed_mesh)
        for i, (lp, kind) in enumerate(zip(params["layers"], self.kinds)):
            lp = self._gather(lp, self._kind_plan(kind))
            hn = common.rmsnorm(lp["pre_norm"], h)
            entry, shard = cache["layers"][i], None
            if self.mesh is not None:
                # The rank's shards: views of the DTensors' storage, so the
                # attention caches' in-place writes land in them.
                entry = shd.tree_map(shd.local, entry)
                if kind in (GLOBAL, LOCAL):
                    shard = self._decode_shard(
                        kvcache.seq_len(cache["layers"][i]))
            if kind in (SSD, RGLRU):
                step = mamba2.ssd_decode if kind == SSD else \
                    rglru.rglru_decode
                out, new = step(lp[kind], hn, entry, cfg, tp=self.tp)
                if self.mesh is not None:
                    new = shd.tree_map(
                        lambda t, old: shd.from_local(
                            t, shd.sharding_of(old), old.shape),
                        new, cache["layers"][i])
                cache["layers"][i] = new
            elif tables is not None and kind == GLOBAL:
                out, _ = kvcache.attention_decode_paged(
                    lp["attn"], hn, entry, tables, pos, cfg,
                    container=self.kv_container,
                    prefix_planes=prefix_planes)
            elif self.kv_container is not None:
                out, _ = kvcache.attention_decode_packed(
                    lp["attn"], hn, entry, pos, cfg, kind=kind,
                    container=self.kv_container,
                    prefix_planes=prefix_planes, shard=shard)
            else:
                out, _ = attention.attention_decode(
                    lp["attn"], hn, entry, pos, cfg, kind=kind, shard=shard)
            h = h + out
            if kind != SSD:
                hm = common.rmsnorm(lp["mlp_norm"], h)
                h = h + self._ffn_decode(lp, hm, row_group)
        top = self._top(params)
        h = common.rmsnorm(top["final_norm"], h)
        return self._logits(top, h, row_group), cache

    def decode_step_paged(self, params, cache: Dict[str, Any],
                          token: torch.Tensor, pos: torch.Tensor,
                          tables: torch.Tensor,
                          prefix_planes: Optional[int] = None
                          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Paged decode step (``decode_step`` with ``tables``)."""
        return self.decode_step(params, cache, token, pos, tables=tables,
                                prefix_planes=prefix_planes)
