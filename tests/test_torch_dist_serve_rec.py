"""Sharded serving of the recurrent families on four CPU ranks against the
JAX package's one-device serving: the reduced mamba2-370m (2 SSD layers,
d_model 128, 8 heads of 32) and recurrentgemma-9b (one (rglru, rglru,
local) period and a remainder RG-LRU layer; 4 q / 1 KV head of 32, window
32), f32, at batch 4 from a 40-token prompt (past recurrentgemma's
window), 8 new tokens, raw caches (their KV rows do not fill a 128-lane
group), on a (2, 2) mesh in the tp layout: each rank steps its own SSD
heads or RG-LRU channels, whose states and conv tails it holds, and
recurrentgemma's local layer serves its sequence shard of the ring.
Prefill and step logits and greedy tokens at ``tests/test_torch_slice.py``'s
f32 tolerances and near-tie rule.
"""
import pytest

import torch

from torch_dist_serve_ranks import check_served, serve_and_spawn

torch.set_num_threads(1)

B, S, NEW = 4, 40, 8
CASES = {"mamba2-370m": dict(arch="mamba2-370m", reduce=dict(n_layers=2),
                             change=dict(dtype="float32")),
         "recurrentgemma-9b": dict(arch="recurrentgemma-9b",
                                   reduce=dict(n_layers=4),
                                   change=dict(dtype="float32"))}
MESHES = (((2, 2), ("tp",)),)
TOL = dict(max=2e-3, mean=2e-4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = {}
    for arch, case in CASES.items():
        runs, _, _, ranks = serve_and_spawn(
            case, tmp_path_factory.mktemp(arch), batch=B, seq=S, new=NEW,
            containers=(None,), jax_run={None: None}, meshes=MESHES)
        out[arch] = (runs, ranks)
    return out


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_recurrent_serving_matches_jax(served, arch):
    runs, ranks = served[arch]
    check_served(runs, ranks, ((2, 2), "tp", None), None, TOL, NEW)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_recurrent_state_shards(served, arch):
    """The SSD state and conv_x, and the RG-LRU state and conv, split over
    ``model`` (dims 1 and 2); the batch over ``data``."""
    _, ranks = served[arch]
    for kind, p in zip(("ssd",) if arch == "mamba2-370m"
                       else ("rglru", "rglru", "local", "rglru"),
                       ranks[0][((2, 2), "tp", None)]["placements"]):
        want = {"ssd": ("S(0)", "S(2)"), "rglru": ("S(0)", "S(2)"),
                "local": ("S(0)", "S(1)")}[kind]
        assert p == want, (kind, p)
