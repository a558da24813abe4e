"""The sharded train step of the reduced recurrentgemma-9b (4 layers: one
(rglru, rglru, local) period and a remainder RG-LRU layer; 4 query heads
over one KV head; f32) on CPU ranks against the JAX package's one-device
step, as ``tests/test_torch_dist_step_gemma.py`` holds gemma2-2b's: tp and
fsdp on a (2, 2) mesh under none, qm + sfp8 and qm+qe + sfp-m2e4. In tp
each rank computes its own ``lru`` channels. Also the replicated heads:
6 query heads over 2 KV heads of 32 (gemma2-2b's reduced config, the same
change in both packages) on a (1, 4) tp mesh, where no head count splits
over the TP degree, so every rank computes every head from the whole
weights, gathered with a backward that keeps its slice of the same
gradient, and fake-quantized before that gather.
"""
import pytest

from torch_dist_harness import REPLICATED, check_step_case


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("policy", ["none", "qm-sfp8", "qm+qe-sfp-m2e4"])
def test_sharded_step_matches_jax(policy, layout, tmp_path_factory):
    check_step_case("recurrentgemma-9b", policy, layout, tmp_path_factory)


@pytest.mark.parametrize("policy", ["none", "qm-sfp8", "qm+qe-sfp-m2e4"])
def test_replicated_heads_step_matches_jax(policy, tmp_path_factory):
    check_step_case(REPLICATED, policy, "tp", tmp_path_factory,
                    shape=(1, 4))
