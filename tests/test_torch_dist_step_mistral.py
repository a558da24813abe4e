"""The sharded train step of the reduced mistral-large-123b (4 global
layers, an untied head; f32) on CPU ranks against the JAX package's
one-device step, as ``tests/test_torch_dist_step_gemma.py`` holds
gemma2-2b's: the head is vocab-sharded over model in the tp layout.
"""
import pytest

from torch_dist_harness import check_step_case


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("policy", ["none", "qm-sfp8", "qm+qe-sfp-m2e4"])
def test_sharded_step_matches_jax(policy, layout, tmp_path_factory):
    check_step_case("mistral-large-123b", policy, layout, tmp_path_factory)
