"""Sharded MoE decode on four CPU ranks against the JAX package's
one-device serving: the reduced olmoe-1b-7b (2 layers, d_model 128, 4 q /
4 KV heads of 32, 4 experts, top 2; f32) at batch 4 from a 24-token
prompt, 8 new tokens, an sfp8 and a raw cache, on a (2, 2) mesh in both
layouts: the batch over ``data`` (tp) or over both axes (fsdp).

JAX's ``moe_decode`` routes the whole batch as one capacity group: 8
assignments to 4 experts at a capacity of max(int(4 * 2 / 4 * 1.25), 2)
= 2, so a step drops every assignment past an expert's second. On a mesh
the rows are gathered over the batch ranks, routed as that one group and
computed on each rank's experts; each decode step must drop exactly the
assignments JAX's drops (JAX run op by op here, to record them), and
some step must drop one. Prefill and step logits and greedy tokens at
``tests/test_torch_slice.py``'s f32 tolerances and near-tie rule.
"""
import pytest

import torch

from torch_dist_serve_ranks import check_served, serve_and_spawn

torch.set_num_threads(1)

B, S, NEW = 4, 24, 8
CASE = dict(arch="olmoe-1b-7b", reduce=dict(n_layers=2),
            change=dict(dtype="float32"))
CONTAINERS = (None, "sfp8")
MESHES = (((2, 2), ("tp", "fsdp")),)
CASES = [(shape, layout, c) for shape, layouts in MESHES
         for layout in layouts for c in CONTAINERS]
TOL = dict(max=2e-3, mean=2e-4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    runs, _, _, ranks = serve_and_spawn(
        CASE, tmp_path_factory.mktemp("serve_moe"), batch=B, seq=S, new=NEW,
        containers=CONTAINERS, jax_run={c: c for c in CONTAINERS},
        meshes=MESHES, eager=True)
    return runs, ranks


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_sharded_moe_serving_matches_jax(served, shape, layout, container):
    runs, ranks = served
    check_served(runs, ranks, (shape, layout, container), container, TOL,
                 NEW)


@pytest.mark.parametrize("shape,layout,container", CASES)
def test_moe_decode_drops_jax_tokens(served, shape, layout, container):
    """Each teacher-forced step's whole-batch group, layer by layer, drops
    as many assignments as JAX's, on every rank; some step drops one."""
    runs, ranks = served
    want = runs[container]["drops"]
    assert len(want) == (NEW - 1) * 2 and max(want) > 0, want
    for r in ranks:
        assert r[(shape, layout, container)]["drops"] == want
