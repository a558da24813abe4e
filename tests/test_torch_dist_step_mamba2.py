"""The sharded train step of the reduced mamba2-370m (4 SSD layers, 8
heads of 32, state 16, chunk 16; f32) on CPU ranks against the JAX
package's one-device step, as ``tests/test_torch_dist_step_gemma.py``
holds gemma2-2b's: tp and fsdp on a (2, 2) mesh under none, qm + sfp8 and
qm+qe + sfp-m2e4. In tp each rank computes its own SSD heads, with the
whole ``w_B`` / ``w_C`` and their convs (their gradients summed over
``model``), and the gated RMSNorm's mean square spans both ranks' channels;
its gradient (the norm's scale, and every leaf upstream of it) is held
with every other, at 1e-5 of each leaf's largest
(``torch_dist_harness.check_step_case``).
"""
import pytest

from torch_dist_harness import check_step_case


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("policy", ["none", "qm-sfp8", "qm+qe-sfp-m2e4"])
def test_sharded_step_matches_jax(policy, layout, tmp_path_factory):
    check_step_case("mamba2-370m", policy, layout, tmp_path_factory)
