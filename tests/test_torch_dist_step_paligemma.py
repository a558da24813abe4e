"""The sharded train step of the reduced paligemma-3b (4 layers; one KV
head for 4 query heads, so every TP rank computes the KV head and reads
it; random conditioning embeddings as a bidirectional prefix; f32) on CPU
ranks against the JAX package's one-device step, as
``tests/test_torch_dist_step_gemma.py`` holds gemma2-2b's.
"""
import pytest

from torch_dist_harness import check_step_case


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("policy", ["none", "qm-sfp8", "qm+qe-sfp-m2e4"])
def test_sharded_step_matches_jax(policy, layout, tmp_path_factory):
    check_step_case("paligemma-3b", policy, layout, tmp_path_factory)
