"""Sharded serving of the reduced gemma2-2b on four CPU ranks against the
JAX package's one-device serving: ``prefill``, ``decode_step``,
``generate`` and the step functions on a mesh.

Model: ``tests/test_torch_slice.py``'s reduced gemma2-2b (4 layers,
d_model 256, 4 query heads over 2 KV heads of 192, window 32), in bf16, at
batch 4 from a 40-token prompt that wraps the local ring, 8 new tokens:
caches of 48 global and 32 ring slots. Meshes (1, 4) and (2, 2), layouts
tp and fsdp. In tp on (1, 4) each rank computes one query head and every
KV head (``KV_DIVIDE``) and holds a quarter of each cache's sequence; on
(2, 2) it computes its own KV head, and the prefill's all-to-all turns
head shards into sequence shards. In fsdp the batch takes ``model`` too,
so each rank holds its rows' whole cache. Caches raw, ``sfp8`` and
``sfp-m2e4`` (read through the decode kernel's shard view and the
log-sum-exp combine), ``gecko8`` and ``bit_exact`` (each rank unpacks its
shard; the plain softmax across ranks). The lossless ``gecko8`` and
``bit_exact`` are held to JAX's raw-cache run.

Tolerances and the near-tie rule are ``tests/test_torch_slice.py``'s for
bf16. The packed caches' shards, gathered, must equal the unsharded
port's packed bytes: a rank packs whole rows of its slots, the rows the
unsharded prefill packs. One spawn of four ranks runs every case.
"""
import numpy as np
import pytest

import torch

from repro_torch import convert
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.serve import kvcache
from torch_dist_serve_ranks import (_cfg, _numpy, by_margin, close,
                                    serve_and_spawn)

torch.set_num_threads(1)

B, S, NEW = 4, 40, 8
MAX_LEN = S + NEW
CASE = dict(arch="gemma2-2b", reduce=dict(n_layers=4, d_model=256),
            change=dict(n_heads=4, n_kv_heads=2, head_dim=192,
                        dtype="bfloat16"))
CONTAINERS = (None, "sfp8", "sfp-m2e4", "gecko8", "bit_exact")
# The JAX run each container is held to: the lossless codecs to the raw
# cache's.
JAX_RUN = {None: None, "sfp8": "sfp8", "sfp-m2e4": "sfp-m2e4",
           "gecko8": None, "bit_exact": None}
MESHES = (((1, 4), ("tp", "fsdp")), ((2, 2), ("tp", "fsdp")))
CASES = [(shape, layout, c) for shape, layouts in MESHES
         for layout in layouts for c in CONTAINERS]
TOL = dict(max=0.5, mean=0.06)
# The least share of the prompt's cache rows whose bf16 K/V the sharded
# prefill computes bit-equal to the unsharded one: [past the first layer
# (fsdp), in the first layer]. The first layer's K/V come from the
# embeddings alone; an fsdp rank computes its rows whole, as the unsharded
# model does; past the first layer of tp, the row-parallel sums add in
# another order, so the packed bytes are held to the pack of the mesh's
# own raw K/V alone.
MIN_SAME = (0.9, 1.0)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX's runs, the unsharded port's prefill caches, and one spawn of
    four ranks serving every case."""
    runs, params, prompt, ranks = serve_and_spawn(
        CASE, tmp_path_factory.mktemp("serve"), batch=B, seq=S, new=NEW,
        containers=CONTAINERS, jax_run=JAX_RUN, meshes=MESHES)
    cfg = _cfg(CASE)
    tparams = convert.from_jax(params, cfg)
    whole = {}
    with torch.inference_mode():
        for c in CONTAINERS:
            model = TModel(cfg, kv_container=c, device="cpu")
            _, cache = model.prefill(tparams, torch.from_numpy(prompt).long(),
                                     MAX_LEN)
            whole[c] = shd.tree_map(_numpy, cache)
    return runs, whole, ranks


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_prefill_logits(served, shape, layout, container):
    runs, _, ranks = served
    want = runs[JAX_RUN[container]]["prefill"]
    for r in ranks:
        close(r[(shape, layout, container)]["prefill"], want, TOL)
        np.testing.assert_array_equal(r[(shape, layout, container)][
            "gen_prefill"], r[(shape, layout, container)]["prefill"])


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_decode_logits_teacher_forced(served, shape, layout, container):
    """Every step's logits, both models fed JAX's tokens; every rank's the
    same."""
    runs, _, ranks = served
    want = runs[JAX_RUN[container]]["steps"]
    mine = ranks[0][(shape, layout, container)]["steps"]
    assert len(mine) == len(want) == NEW - 1
    for got, w in zip(mine, want):
        close(got, w, TOL)
    for r in ranks[1:]:
        for a, b in zip(r[(shape, layout, container)]["steps"], mine):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_greedy_tokens_by_margin(served, shape, layout, container):
    """``generate``'s tokens against JAX's up to a near tie; the step
    functions (``make_prefill_step`` + ``make_decode_loop``) give
    ``generate``'s tokens, on every rank."""
    runs, _, ranks = served
    run = runs[JAX_RUN[container]]
    got = ranks[0][(shape, layout, container)]
    by_margin(got["tokens"], run["tokens"], [run["prefill"]] + run["steps"],
              TOL)
    for r in ranks:
        np.testing.assert_array_equal(r[(shape, layout, container)]["tokens"],
                                      got["tokens"])
        np.testing.assert_array_equal(
            r[(shape, layout, container)]["loop_tokens"], got["tokens"])
    assert got["margins"].shape == (B, NEW)


def _packed_whole(raw, container):
    """A layer's gathered raw cache (``KVCache`` of bf16 values as f32
    numpy) packed whole by the unsharded codec, as numpy."""
    kv = attention.KVCache(*(torch.from_numpy(x).to(torch.bfloat16)
                             for x in raw))
    return shd.tree_map(_numpy, kvcache.pack_prefill_cache(kv, container))


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_cache_shards_equal_the_unsharded_cache(served, shape, layout,
                                               container):
    """The ranks' cache shards after the prefill, gathered. The packed
    parts, in every layer and slot, bit for bit the unsharded codec's
    pack of the same mesh's raw K/V gathered (the raw-cache case's, whose
    prefill computes the same K/V): a rank packs whole rows of its slots.
    Against the unsharded port's cache, the packed parts bit for bit in
    every (row, slot) whose bf16 K/V rows are equal on both sides (the
    raw caches'): every prompt row of the first layer, and at least
    MIN_SAME[0] of them in every layer of fsdp."""
    _, whole, ranks = served
    got = ranks[0][(shape, layout, container)]["cache"]
    raw_got = ranks[0][(shape, layout, None)]["cache"]
    for i, (a, b) in enumerate(zip(got["layers"], whole[container]["layers"])):
        ra, rb = raw_got["layers"][i], whole[None]["layers"][i]
        if container is not None:
            packed = _packed_whole(ra, container)
            for part in ("k", "v"):
                x, y = getattr(a, part), getattr(packed, part)
                assert x.data.keys() == y.data.keys()
                for name in x.data:
                    np.testing.assert_array_equal(x.data[name], y.data[name])
        for part in ("k", "v"):
            x, y = getattr(a, part), getattr(b, part)
            kv = getattr(ra, part)
            same = (kv == getattr(rb, part)).reshape(
                B, -1, kv.shape[2] * kv.shape[3]).all(-1)     # (B, L)
            share = same[:, :min(S, kv.shape[1])].mean()   # prompt rows
            if i == 0 or layout == "fsdp":
                assert share >= MIN_SAME[i == 0], (i, part, share)
            if container is None:
                continue
            for name in x.data:
                np.testing.assert_array_equal(x.data[name][same],
                                              y.data[name][same])


@pytest.mark.parametrize("shape,layout", [(m, lo) for m, los in MESHES
                                          for lo in los])
def test_cache_placements(served, shape, layout):
    """Where each cache lives (placements over (data, model)): in tp the
    batch rows over ``data`` and the KV sequence over ``model``; in fsdp
    the batch over both axes (4 rows on 4 ranks), the sequence whole on
    each rank."""
    _, _, ranks = served
    want = ("S(0)", "S(0)") if layout == "fsdp" else ("S(0)", "S(1)")
    for c in CONTAINERS:
        for p in ranks[0][(shape, layout, c)]["placements"]:
            assert p == want, p
