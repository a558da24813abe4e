"""Sharded serving where the mesh does not divide the cache or the batch,
on four CPU ranks against the JAX package's one-device serving: the
reduced gemma2-2b of ``tests/test_torch_dist_serve.py`` (bf16) at batch 2
from a 40-token prompt, 7 new tokens, so the global cache has 47 slots
and the local ring 32. On a (2, 2) mesh in tp the global layers' 47
slots do not split over ``model``: each rank keeps every slot (as JAX's
``refine_shardings`` leaves a dim the mesh does not divide), gathers its
KV heads from the other rank at the prefill and combines nothing, while
the ring still splits. In fsdp the 2 rows do not split over the 4 batch
ranks, so every rank serves both rows. Raw and sfp8 caches;
``tests/test_torch_slice.py``'s bf16 tolerances and near-tie rule.
"""
import pytest

import torch

from torch_dist_serve_ranks import check_served, serve_and_spawn

torch.set_num_threads(1)

B, S, NEW = 2, 40, 7
CASE = dict(arch="gemma2-2b", reduce=dict(n_layers=4, d_model=256),
            change=dict(n_heads=4, n_kv_heads=2, head_dim=192,
                        dtype="bfloat16"))
CONTAINERS = (None, "sfp8")
MESHES = (((2, 2), ("tp", "fsdp")),)
CASES = [(shape, layout, c) for shape, layouts in MESHES
         for layout in layouts for c in CONTAINERS]
TOL = dict(max=0.5, mean=0.06)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    runs, _, _, ranks = serve_and_spawn(
        CASE, tmp_path_factory.mktemp("serve_uneven"), batch=B, seq=S,
        new=NEW, containers=CONTAINERS, jax_run={c: c for c in CONTAINERS},
        meshes=MESHES)
    return runs, ranks


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_uneven_serving_matches_jax(served, shape, layout, container):
    runs, ranks = served
    check_served(runs, ranks, (shape, layout, container), container, TOL,
                 NEW)


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_uneven_cache_placements(served, shape, layout, container):
    """Per layer (local, global, local, global) over (data, model): tp
    splits the rows over ``data`` and the 32-slot ring over ``model`` but
    keeps the 47 global slots whole; fsdp keeps everything whole."""
    _, ranks = served
    want = ([("S(0)", "S(1)"), ("S(0)", "R")] * 2 if layout == "tp"
            else [("R", "R")] * 4)
    assert ranks[0][(shape, layout, container)]["placements"] == want
