"""The sharded train step of the reduced gemma2-2b (4 layers: two
local/global periods, tied table, softcaps; f32) on CPU ranks against the
JAX package's one-device step: 2 steps of 8 x 32 tokens in 2
microbatches, on a (2, 2) mesh in the tp and fsdp layouts under the
policies none, qm + sfp8 and qm+qe + sfp-m2e4. JAX's stash inputs are
recorded and each rank stashes its rows of them (ROADMAP §C, "truncation
flips"); the parity rules are ``torch_dist_harness.check_step_case``'s.
Also qm + sfp8 on a mesh of data ranks only. One spawn of four ranks runs
every case of the file.
"""
import pytest

from torch_dist_harness import check_step_case


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("policy", ["none", "qm-sfp8", "qm+qe-sfp-m2e4"])
def test_sharded_step_matches_jax(policy, layout, tmp_path_factory):
    check_step_case("gemma2-2b", policy, layout, tmp_path_factory)


def test_sharded_step_on_a_data_only_mesh(tmp_path_factory):
    """A (4, 1) mesh in the tp layout: four batch shards, TP of one."""
    check_step_case("gemma2-2b", "qm-sfp8", "tp", tmp_path_factory,
                    shape=(4, 1))
