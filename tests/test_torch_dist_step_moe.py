"""The sharded train step of the reduced olmoe-1b-7b (4 layers, 4 experts,
top 2, capacity per batch row; f32) on CPU ranks against the JAX
package's one-device step, as ``tests/test_torch_dist_step_gemma.py``
holds gemma2-2b's: tp and fsdp on a (2, 2) mesh under none, qm + sfp8 and
qm+qe + sfp-m2e4. The experts split over ``model`` in both layouts: in tp
each rank scatters its rows into its own experts only and the combine
sums over ``model``; in fsdp the expert slices go to their owners by an
all-to-all and back. ``moe_lb_loss`` and ``moe_drop_frac`` are held at
rtol 1e-5 every step, the router's gradient with every other (AdamW's
first moment at 1e-5 of its largest), and without a policy the forward's
``moe_z_loss``, ``moe_lb_loss``, ``moe_drop_frac`` and ``moe_aux_loss`` at
rtol 1e-5 too (``torch_dist_harness.check_step_case``).
"""
import pytest

from torch_dist_harness import check_step_case


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("policy", ["none", "qm-sfp8", "qm+qe-sfp-m2e4"])
def test_sharded_step_matches_jax(policy, layout, tmp_path_factory):
    check_step_case("olmoe-1b-7b", policy, layout, tmp_path_factory)
