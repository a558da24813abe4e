"""The port's sharding rules, elastic re-meshing and input pipeline against
the JAX package's, on the CPU without process groups.

The rules, ``spec_from_axes``, ``refine_shardings`` and ``batch_specs``
must give, for every leaf of every config's ``param_axes`` on (2, 2) and
(2, 2, 2) meshes in both layouts, the placements JAX's ``PartitionSpec``s
say: a mesh dim named in the spec's entry for tensor dim d is
``Shard(d)``, any other ``Replicate()``. The port's ``param_axes`` (one
entry a layer) is JAX's with the stacked ``layers`` axis taken off.
``valid_tp_degrees`` and ``plan_remesh`` are pure functions, held to JAX's
over every device count from 1 to 512 at the batches of
``tests/test_elastic.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding

from repro import configs as jconfigs
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jshd
from repro.models.model import DecoderModel as JModel
from repro_torch import NotYetPorted
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SSD
from repro_torch.core.stash import float_leaves
from repro_torch.data import pipeline
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import sharding as tshd
from repro_torch.models import attention
from repro_torch.models.model import META, DecoderModel as TModel
from repro_torch.serve import engine

NAMES = sorted(jconfigs.names())
MESHES = {"2x2": (("data", "model"), (2, 2)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}


def _jax_mesh(names, shape):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:1] * n).reshape(shape), names)


def _placements(spec, names, ndim):
    """The placements a JAX PartitionSpec says, one per mesh dim."""
    out = [tshd.Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[names.index(name)] = tshd.Shard(d)
    return tuple(out)


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _unstacked(cfg, axes):
    """JAX's axes tree in the port's layout: one entry a layer, the
    periods' leading ``layers`` axis taken off."""
    strip = lambda t: jax.tree.map(lambda a: a[1:], t, is_leaf=_is_axes)
    layers = [strip(axes["periods"][f"slot{i}"])
              for _ in range(cfg.n_periods) for i in range(len(cfg.period))]
    layers += [axes["rem"][f"slot{i}"] for i in range(len(cfg.remainder))]
    out = {"embed": axes["embed"], "final_norm": axes["final_norm"],
           "layers": layers}
    if "head" in axes:
        out["head"] = axes["head"]
    return out


def _paths(tree, path=()):
    """(path, leaf) of a nest of dicts and lists whose leaves are axes
    tuples or shardings."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _paths(v, path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, path + (i,))]
    return [(path, tree)]


def _cut(cfg):
    """Two layers at d_model 90 and vocab 999 (odd heads' widths too),
    which some mesh products do not divide."""
    kw = dict(n_layers=2, d_model=90, vocab=999, vocab_pad_multiple=1)
    if cfg.n_heads:
        kw.update(n_heads=6, n_kv_heads=min(cfg.n_kv_heads, 3), head_dim=15)
    return dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _axes(name, cut):
    """(the port's ``param_axes``, JAX's unstacked, the port's leaves on
    the meta device) of config ``name``, at full size or at ``_cut``; one
    reading per config, shared by the meshes and layouts."""
    jc, tc = jconfigs.get(name), tconfigs.get(name)
    if cut:
        jc, tc = _cut(jc), _cut(tc)
    tm = TModel(tc, device="cpu")
    return (tm.param_axes(), _unstacked(jc, JModel(jc).param_axes()),
            tm._draw(None, META))


@pytest.mark.parametrize("name", NAMES)
def test_param_axes_match_jax(name):
    tax, jax_axes, _ = _axes(name, False)
    assert tax == jax_axes


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_placements_match_jax_specs(name, mesh, layout):
    """Every leaf, before and after ``refine_shardings`` (at full size and
    at ``_cut``)."""
    names, shape = MESHES[mesh]
    jmesh, tmesh = _jax_mesh(names, shape), tshd.MeshShape(names, shape)
    jrules = jshd.rules_for(jmesh, layout=layout)
    trules = tshd.rules_for(tmesh, layout=layout)
    assert trules == jrules
    for cut in (False, True):
        tax, jax_axes, meta = _axes(name, cut)
        assert tax == jax_axes
        tsh = tshd.tree_shardings(tmesh, tax, trules)
        refined = tshd.refine_shardings(meta, tsh, tmesh)
        for (path, axes), (_, sh), (_, rsh), (_, leaf) in zip(
                _paths(tax), _paths(tsh), _paths(refined),
                float_leaves(meta)):
            jspec = jshd.spec_from_axes(axes, jrules)
            want = _placements(jspec, names, len(axes))
            assert sh.placements == want, (path, jspec)
            assert tshd.spec_from_axes(axes, trules, tmesh) == want
            shape = jax.ShapeDtypeStruct(tuple(leaf.shape), np.float32)
            jref = jshd.refine_shardings(
                shape, NamedSharding(jmesh, jspec), jmesh)
            assert rsh.placements == _placements(jref.spec, names,
                                                 len(axes)), (path, jref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_batch_specs_and_axes_match_jax(mesh, layout):
    names, shape = MESHES[mesh]
    jmesh, tmesh = _jax_mesh(names, shape), tshd.MeshShape(names, shape)
    jrules = jshd.rules_for(jmesh, layout=layout)
    trules = tshd.rules_for(tmesh, layout=layout)
    for kind in ("train", "prefill", "decode"):
        for cond in (False, True):
            jb = jshd.batch_specs(jrules, kind, cond)
            tb = tshd.batch_specs(trules, kind, cond, tmesh)
            assert tb.keys() == jb.keys()
            for k, spec in jb.items():
                assert tb[k].placements == _placements(
                    spec, names, 3 if k == "cond_embeddings" else 2), k
    try:
        jshd.set_active_mesh(jmesh, jrules)
        tshd.set_active_mesh(tmesh, trules)
        for size in (1, 2, 3, 4, 8, 12):
            assert tshd.batch_axis_for(tmesh, size) == \
                jshd.batch_axis_for(jmesh, size)
        assert tshd.heads_target() == jshd.heads_target()
        assert tshd.model_axis_size(tmesh) == jshd.model_axis_size(jmesh)
        assert tshd.active_rules() == jshd.active_rules()
    finally:
        jshd.set_active_mesh(None)
        tshd.set_active_mesh(None)
    assert tshd.heads_target() == jshd.heads_target() == "model"


def test_spec_uses_each_mesh_axis_once():
    """JAX's ``tests/test_sharding_rules.py`` cases, as placements."""
    mesh = tshd.MeshShape(("data", "model"), (2, 2))
    rules = {"embed": ("data",), "ff": ("model",), "a": ("model",),
             "b": ("model",)}
    assert tshd.spec_from_axes(("embed", "ff"), rules, mesh) == (
        tshd.Shard(0), tshd.Shard(1))
    assert tshd.spec_from_axes(("a", "b"), rules, mesh) == (
        tshd.Replicate(), tshd.Shard(0))
    sh = tshd.Sharding(mesh, (tshd.Shard(0), tshd.Shard(1)))
    out = tshd.refine_shardings(np.zeros((3, 8)), sh, mesh)
    assert out.placements == (tshd.Replicate(), tshd.Shard(1))


@pytest.mark.parametrize("name", NAMES)
def test_remesh_plans_match_jax(name):
    jc, tc = jconfigs.get(name), tconfigs.get(name)
    assert telastic.valid_tp_degrees(tc) == jelastic.valid_tp_degrees(jc)
    for n in range(1, 513):
        for batch, prefer in ((256, 16), (64, 8), (8, 2)):
            want = jelastic.plan_remesh(n, jc, batch, prefer)
            got = telastic.plan_remesh(n, tc, batch, prefer)
            assert (got.shape, got.axes, got.dropped_devices) == (
                want.shape, want.axes, want.dropped_devices), (n, batch)


@pytest.mark.parametrize("name", NAMES)
def test_tp_degrees_past_the_heads_are_refused_by_name(name):
    """``attention.kv_local`` gives the mode of every TP degree of
    ``valid_tp_degrees``: where JAX's ``_qkv_specs`` would replicate the
    query heads (they do not split over the degree) or the KV heads (they
    neither split nor divide it), ``REPLICATED``; else a rank owns its
    KV heads exactly when they split (``KV_OWN``), or computes them all
    and reads its group's (``KV_DIVIDE``). Heads are no longer refused:
    gemma2-2b and paligemma replicate theirs at the production mesh's
    model axis of 16."""
    cfg = tconfigs.get(name)
    H, KH = cfg.n_heads, cfg.n_kv_heads
    for tp in telastic.valid_tp_degrees(cfg, 64):
        want = (attention.REPLICATED if H % tp or (KH % tp and tp % KH)
                else attention.KV_OWN if KH % tp == 0
                else attention.KV_DIVIDE)
        assert attention.kv_local(cfg, tp) == want, tp
    if name in ("gemma2-2b", "paligemma-3b"):
        assert attention.kv_local(cfg, 16) == attention.REPLICATED


class _PlanMesh:
    """What ``DecoderModel`` reads of a ``DeviceMesh`` to plan its shards,
    without processes: dim names, shape, and this rank at the origin."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    def size(self):
        return int(np.prod(self.shape))

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("name", NAMES)
def test_every_config_builds_on_its_valid_tp_degrees(name, monkeypatch):
    """``DecoderModel(cfg, mesh=, rules=)`` plans its shards for every
    config at full widths (one period and the remainder layers deep) on a
    (2, tp) mesh at every degree of
    ``valid_tp_degrees(cfg, 64)``, in both layouts: MoE, SSD and RG-LRU
    layers and heads that do not split raise nothing. The one refusal is
    an SSD head split across ranks (mamba2-370m's 32 heads at 64, which
    JAX's degrees allow since they count ``d_inner``, not heads): the
    uneven-split ``ValueError``. Under tp each layer keeps its TP leaves
    over ``model`` (the replicated heads' weights gathered whole, with
    ``same``), and the paged engine refuses the mesh (the JAX package's
    paged pool has no sharding axes)."""
    monkeypatch.setattr(tshd, "axes_group", lambda mesh, axes: None)
    full = tconfigs.get(name)
    # Full widths, one period and the remainder: every kind of leaf.
    n = len(full.period)
    cfg = dataclasses.replace(full, n_layers=n + full.n_layers % n)
    for tp in telastic.valid_tp_degrees(cfg, 64):
        for layout in ("tp", "fsdp"):
            mesh = _PlanMesh(("data", "model"), (2, tp))
            rules = tshd.rules_for(mesh, layout=layout)
            split = SSD not in cfg.period or cfg.ssm_heads % tp == 0
            if layout == "tp" and not split:
                with pytest.raises(ValueError, match="must split over the "
                                                     "model axis"):
                    TModel(cfg, device="cpu", mesh=mesh, rules=rules)
                continue
            model = TModel(cfg, device="cpu", mesh=mesh, rules=rules)
            plans = model._plans["layers"][0]
            replicated = model.heads_mode == attention.REPLICATED
            for block, leaves in plans.items():
                for leaf, plan in leaves.items():
                    if not hasattr(plan, "keep"):
                        continue
                    if layout == "fsdp" or tp == 1:
                        assert plan.same is None
                    elif block == "attn" and replicated and leaf in (
                            "wq", "wk", "wv", "wo"):
                        assert (plan.keep, plan.same) == (None, "model")
                    elif block in ("mlp", "rglru") or leaf in (
                            "wq", "wo", "w_x", "w_z", "w_dt", "A_log"):
                        assert plan.keep == "model", (block, leaf)
            if cfg.is_moe:
                assert model._moe.exchange == (layout == "fsdp")
            with pytest.raises(NotYetPorted, match="paged pool"):
                engine.PagedEngine(model, None)


def test_prefetch_preserves_order_and_count():
    """JAX's ``tests/test_data.py`` case."""
    def gen():
        for i in range(5):
            yield {"x": np.full((2,), i)}
    out = list(pipeline.prefetch(gen(), depth=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert float(b["x"][0]) == i


def test_prefetch_propagates_errors():
    """JAX's ``tests/test_data.py`` case."""
    def gen():
        yield {"x": np.zeros(1)}
        raise ValueError("boom")
    it = pipeline.prefetch(gen(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_stops_its_worker_when_closed():
    """Closing the consumer stops the worker before its next batch."""
    pulled = []

    def gen():
        for i in range(100):
            pulled.append(i)
            yield {"x": np.full((1,), i)}
    it = pipeline.prefetch(gen(), depth=1, device="cpu")
    assert float(next(it)["x"][0]) == 0
    it.close()
    n = len(pulled)
    import time
    time.sleep(0.2)
    assert len(pulled) <= n + 1 < 100


def test_place_whole_arrays():
    """Without shardings every array goes whole to the device: integers as
    int64, floats in their own dtype, bit for bit."""
    b = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
         "cond_embeddings": np.random.default_rng(0).standard_normal(
             (3, 2, 4)).astype(np.float32)}
    out = pipeline.place(b, None, device="cpu")
    assert out["tokens"].dtype == torch.int64
    assert out["cond_embeddings"].dtype == torch.float32
    for k in b:
        np.testing.assert_array_equal(out[k].numpy(), b[k])
    assert [p for p, _ in float_leaves(out)] == [("cond_embeddings",)]
