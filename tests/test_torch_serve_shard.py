"""The pieces of sharded serving that need no ranks, against the JAX
package: ``serve.engine.cache_axes`` leaf for leaf against JAX's
``engine.cache_axes`` for every config, raw and packed; and the decode
kernel's shard view on the CPU: ``ref.packed_flash_decode_shard`` over
four sequence shards, combined by their log-sum-exps, against the whole
plain decode and JAX's ``ref.packed_flash_decode``, and the kernel's
split mirror (``split_decode_plain``) with a first slot and a partial
last split against the plain shard view.

Inputs are made with numpy from a seed and packed by the JAX oracles. The
shard view and the whole decode sum the same terms in another order, in
f32: held to 2e-5 absolute and relative, as
``tests/test_torch_decode_split.py`` holds its split recurrence.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.models.model import DecoderModel as JModel
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import ref as tref
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.serve import engine
from test_torch_decode_split import (CONTAINERS, F32_TOL, _draft, _fields,
                                     _pack, _t, _values)

torch.set_num_threads(1)

ARCHS = ("gemma2-2b", "gemma3-12b", "gemma2-27b", "mistral-large-123b",
         "paligemma-3b", "musicgen-large", "olmoe-1b-7b",
         "phi3.5-moe-42b-a6.6b", "mamba2-370m", "recurrentgemma-9b")


# -- cache_axes --------------------------------------------------------------


def _jax_layers(axes, cfg):
    """JAX's cache axes tree, one entry a layer in the port's order, the
    leading "layers" axis of the periods dropped."""
    def strip(tree):
        if isinstance(tree, tuple) and all(a is None or isinstance(a, str)
                                           for a in tree):
            assert tree[0] == "layers", tree
            return tree[1:]
        if hasattr(tree, "data"):
            return type(tree)(tree.codec, tree.shape, tree.dtype,
                              {k: strip(v) for k, v in tree.data.items()})
        return type(tree)(*(strip(v) for v in tree))
    out = []
    for p in range(cfg.n_periods):
        for i in range(len(cfg.period)):
            out.append(strip(axes["periods"][f"slot{i}"]))
    for i in range(len(cfg.remainder)):
        out.append(axes["rem"][f"slot{i}"])
    return out


def _leaves(entry):
    if hasattr(entry, "data"):
        return {k: v for k, v in sorted(entry.data.items())}
    return entry


def test_every_config_is_covered():
    assert sorted(ARCHS) == sorted(tconfigs.base._REGISTRY)


@pytest.mark.parametrize("container", [None, "sfp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_match_jax(arch, container):
    """Every layer's cache leaves carry JAX's axes: raw KV ("batch",
    "cache_seq", "kv", None), packed parts ("batch", "cache_seq", None),
    the SSD and RG-LRU states and conv tails; the same leaf names."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    if container is not None and not ({"global", "local"}
                                      & set(tcfg.period)):
        container = None    # no KV cache: both packages store state only
    want = _jax_layers(jengine.cache_axes(
        JModel(jcfg, kv_container=container), 2, 4224), jcfg)
    got = engine.cache_axes(TModel(tcfg, kv_container=container,
                                   device="cpu"), 2, 4224)["layers"]
    assert len(got) == len(want) == tcfg.n_layers
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert g._fields == w._fields
        for a, b in zip(g, w):
            assert _leaves(a) == _leaves(b)


def test_gecko8_cache_axes_departure():
    """gecko8's grouped parts: JAX's are flat over the tensor's groups
    (the axes of a 2-D part, ("batch", "cache_seq")); the port's are
    (B, L, D / 64, .) and carry ("batch", "cache_seq", None, None). The
    signs and mantissas keep JAX's axes."""
    cfg = tconfigs.get("gemma2-2b")
    got = engine.cache_axes(TModel(cfg, kv_container="gecko8",
                                   device="cpu"), 2, 64)["layers"][0]
    want = _jax_layers(jengine.cache_axes(JModel(
        jconfigs.get("gemma2-2b"), kv_container="gecko8"), 2, 64),
        cfg)[0]
    for g, w in zip(got, want):
        assert g.data.keys() == w.data.keys()
        for k in g.data:
            if k in ("bases", "widths", "planes"):
                assert w.data[k] == ("batch", "cache_seq")
                assert g.data[k] == ("batch", "cache_seq", None, None)
            else:
                assert g.data[k] == w.data[k]


# -- the shard view on the CPU --------------------------------------------


def _combine(parts):
    """The log-sum-exp combine of (o, lse) partials, in f32, as
    ``sharding.lse_combine`` computes it over ranks."""
    lse = torch.stack([p[1] for p in parts])
    m = lse.max(0).values
    w = torch.exp(lse - m)[..., None]
    return (sum(wi * p[0] for wi, p in zip(w, parts))) / w.sum(0)


def _case(container, L, window, pos, draft, seed):
    jf, tf = _fields(container)
    rng = np.random.default_rng(seed)
    B, H, KH, hd = len(pos), 4, 2, 64
    q = (rng.standard_normal((B, 1, H, hd)) * 3).astype(np.float32)
    k = _pack(_values(rng, (B, L, KH * hd)), jf)
    v = _pack(_values(rng, (B, L, KH * hd)), jf)
    kw = dict(window=window, softcap=50.0,
              prefix_planes=_draft(jf) if draft else None)
    return jf, tf, q, k, v, kw


def _shards(k, v, n):
    """Each of n sequence shards' (k_payload, k_bases, v_payload,
    v_bases) and first slot."""
    L = k[1].shape[1]
    return [(tuple(_t(a[:, r * L // n:(r + 1) * L // n]) for a in (*k, *v)),
             r * L // n) for r in range(n)]


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("L,window,pos", [
    (1152, None, [0, 5, 287, 288, 700, 1151]),     # partial last blocks
    (256, 96, [300, 1000, 255, 5, 128, 200])])      # a wrapped ring
def test_shard_view_combined_equals_whole_decode(container, draft, L, window,
                                                 pos):
    """Four shards' (o, lse), combined, against the whole plain decode and
    JAX's; each shard's (o, lse) against the kernel's split mirror with
    the shard's first slot (splits of ``shard_split_l``, the last one
    partial: 288 = 4 x 64 + 32 slots, and a 64-slot ring shard of one
    partial 128-slot block); a shard with no visible slot gives lse -inf
    and weight 0."""
    jf, tf, q, k, v, kw = _case(container, L, window, pos, draft, seed=7)
    tq, tpos = torch.from_numpy(q), torch.tensor(pos, dtype=torch.int32)
    parts = []
    for args, slot0 in _shards(k, v, 4):
        part = tref.packed_flash_decode_shard(
            tq, *args, tpos, tf, slot0=slot0, L_global=L,
            block_l=tpfd.DEFAULT_BLOCK_L, **kw)
        mirror = tpfd.split_decode_plain(tq, *args, tpos, tf, slot0=slot0,
                                         L_global=L, **kw)
        for a, b in zip(part, mirror):
            assert torch.equal(torch.isinf(a), torch.isinf(b))
            np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL)
        parts.append(part)
    got = _combine(parts).reshape(len(pos), 1, 4, 64)
    whole = tref.packed_flash_decode(
        tq, *map(_t, (*k, *v)), tpos, tf, block_l=tpfd.DEFAULT_BLOCK_L, **kw)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **F32_TOL)
    jwant = jref.packed_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, (*k, *v)),
        jnp.asarray(pos, jnp.int32), jf, block_l=tpfd.DEFAULT_BLOCK_L, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)
    if window is None:   # row 0 at position 0 sees only shard 0's slot 0
        assert all(bool(torch.isinf(p[1][0]).all()) for p in parts[1:])


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
def test_shard_view_of_the_whole_cache_is_the_decode(container):
    """One shard that is the whole cache (a world of one): the shard
    view's o is the plain decode's before its rounding (bit for bit in
    f32), and ``sharding.lse_combine`` over no group returns it
    unchanged, so one rank rounds to the unsharded decode's bits."""
    jf, tf, q, k, v, kw = _case(container, 1152, None, [3, 600, 1151],
                                False, seed=8)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tpos = torch.tensor([3, 600, 1151], dtype=torch.int32)
    args = tuple(map(_t, (*k, *v)))
    o, lse = tops.packed_flash_decode_shard(
        tq, tops.Packed(*args[:2]), tops.Packed(*args[2:]), tpos, fields=tf,
        slot0=0, L_global=1152, **kw)
    combined = shd.lse_combine(o, lse, None)
    assert torch.equal(combined, o)
    want = tops.packed_flash_decode(tq, tops.Packed(*args[:2]),
                                    tops.Packed(*args[2:]), tpos, fields=tf,
                                    **kw)
    assert torch.equal(combined.to(torch.bfloat16).reshape(want.shape), want)


def test_shard_view_refuses_slots_outside_the_cache():
    _, tf, q, k, v, kw = _case("sfp8", 64, None, [3], False, seed=9)
    with pytest.raises(ValueError, match="outside"):
        tpfd.packed_flash_decode_shard(torch.from_numpy(q),
                                       *map(_t, (*k, *v)),
                                       torch.tensor([3], dtype=torch.int32),
                                       tf, slot0=32, L_global=64)


@pytest.mark.parametrize("L_global,split_l", [(1152, 64), (1088, 34),
                                              (48, 48), (100, 50)])
def test_shard_split_is_the_whole_reads_split(L_global, split_l):
    """The shard view splits as the whole cache's launch does."""
    assert tpfd.shard_split_l(L_global) == split_l == tpfd.split_plan(
        1, 2, 64, L_global).split_l
