"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against
the JAX package's ``repro.models.moe``, on the CPU, in f32, at the
reduced olmoe-1b-7b and phi3.5-moe-42b-a6.6b (d_model 128, 4 experts of
256, top-2), with weights and inputs from numpy.

``moe_forward`` at capacity factors 0.5 (tokens drop), 1.25 (the configs'
own) and 8.0 (nothing drops); ``moe_decode`` over a batch whose one-group
capacity drops a token. The drop set (which (token, slot) assignments
keep their place) is held equal to JAX's, re-derived with JAX's own
routing expressions. Outputs and the aux values to rtol 1e-5; gradients
of the inputs and of every weight (the router's through the renormalized
gates, the load-balance term's mean probabilities and the z-loss) to
``jax.vjp`` at rtol 1e-5 / atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
B, S = 2, 24
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(arch, cf):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype="float32",
                                   capacity_factor=cf)
    return (cut(jconfigs.get(arch), jreduced),
            cut(tconfigs.get(arch), treduced))


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    p = {"router": w((d, E), d), "w_in": w((E, d, f), d),
         "w_out": w((E, f, d), f)}
    if cfg.glu:
        p["w_gate"] = w((E, d, f), d)
    return p


def _jax_keep(params, h, cfg):
    """JAX's keep mask (B, S, K), by the expressions of its moe_forward."""
    Bh, Sh, _ = h.shape
    E, K = cfg.n_experts, cfg.top_k
    C = jmoe.capacity_for(cfg, Sh)
    probs = jax.nn.softmax(h.astype(jnp.float32) @ params["router"], -1)
    _, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = onehot.reshape(Bh, Sh * K, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos.reshape(Bh, Sh, K, E) * onehot, axis=-1)
    return np.asarray(pos < C)


def _t(tree, grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in tree.items()}


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, cf):
    jc, tc = _cfgs(arch, cf)
    assert (tc.n_experts, tc.top_k) == (4, 2) and tc.glu
    params = _params(jc, 0)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(params, jnp.asarray(h), jc)
    tp, th = _t(params, True), torch.from_numpy(h).requires_grad_(True)
    tout, taux = tmoe.moe_forward(tp, th, tc)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    keep = tmoe.route(tp, th, tc)[-1].numpy()
    np.testing.assert_array_equal(keep, _jax_keep(params, jnp.asarray(h),
                                                  jc))
    dropped = int((~keep).sum())
    if cf == 0.5:
        assert dropped > 0
    if cf == 8.0:
        assert dropped == 0
    # Gradients: a random cotangent of the output, scaled as a mean over
    # the tokens (a loss's), and the loss weights the model gives the two
    # aux losses (drop_frac has no gradient).
    g = (rng.standard_normal(h.shape) / (B * S)).astype(np.float32)
    lb_w, z_w = 0.01, 1e-3

    def f(p, x):
        out, aux = jmoe.moe_forward(p, x, jc)
        return (jnp.sum(out * g) + lb_w * aux["moe_lb_loss"]
                + z_w * aux["moe_z_loss"])
    jgp, jgh = jax.grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(h))
    obj = ((tout * torch.from_numpy(g)).sum() + lb_w * taux["moe_lb_loss"]
           + z_w * taux["moe_z_loss"])
    grads = torch.autograd.grad(obj, [th] + list(tp.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgh),
                               err_msg="h", **GRAD_TOL)
    for (k, _), gt in zip(tp.items(), grads[1:]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(jgp[k]),
                                   err_msg=k, **GRAD_TOL)
    assert float(grads[1].abs().max()) > 0      # the router learns


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_gradients_reach_the_router_as_jax(arch):
    """The load-balance and z losses alone (no output cotangent): their
    router gradient, through the mean probabilities and the logits'
    log-sum-exp, against ``jax.vjp``."""
    jc, tc = _cfgs(arch, 1.25)
    params = _params(jc, 3)
    h = np.random.default_rng(4).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    (_, jaux), vjp = jax.vjp(lambda p: jmoe.moe_forward(p, jnp.asarray(h),
                                                        jc), jparams)
    cot = (jnp.zeros((B, S, jc.d_model), jnp.float32),
           {"moe_lb_loss": jnp.float32(1.0), "moe_z_loss": jnp.float32(0.5),
            "moe_drop_frac": jnp.float32(0.0)})
    (jg,) = vjp(cot)
    tp = _t(params, True)
    _, taux = tmoe.moe_forward(tp, torch.from_numpy(h), tc)
    (gr,) = torch.autograd.grad(taux["moe_lb_loss"]
                                + 0.5 * taux["moe_z_loss"], [tp["router"]])
    np.testing.assert_allclose(gr.numpy(), np.asarray(jg["router"]),
                               **GRAD_TOL)
    assert float(gr.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_drops_as_jax(arch):
    """One token a row, the whole batch one group: capacity max(int(B * K
    / E * cf), K) = 3 for 6 rows drops an assignment on this draw, and
    the port drops the same one as JAX."""
    jc, tc = _cfgs(arch, 1.25)
    rows = 6
    assert tmoe.capacity_for(tc, rows) == jmoe.capacity_for(jc, rows) == 3
    params = _params(jc, 5)
    h = np.random.default_rng(6).standard_normal(
        (rows, 1, jc.d_model)).astype(np.float32)
    tp = _t(params)
    keep = tmoe.route(tp, torch.from_numpy(h).reshape(1, rows, -1), tc)[-1]
    assert int((~keep).sum()) > 0
    np.testing.assert_array_equal(keep.numpy(), _jax_keep(
        params, jnp.asarray(h).reshape(1, rows, -1), jc))
    jout = jmoe.moe_decode(params, jnp.asarray(h), jc)
    tout = tmoe.moe_decode(tp, torch.from_numpy(h), tc)
    assert tout.shape == (rows, 1, tc.d_model)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    # A dropped row's both assignments gone: its output is zero.
    gone = (~keep[0]).all(-1)
    if bool(gone.any()):
        assert float(tout[gone.numpy()].abs().max()) == 0.0
    with pytest.raises(ValueError):
        tmoe.moe_decode(tp, torch.from_numpy(h).reshape(2, 3, -1), tc)


def test_configs_and_capacity_match_jax():
    for arch in ARCHS:
        j, t = jconfigs.get(arch), tconfigs.get(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for n in (1, 4, 6, 2048, 4096):
            assert tmoe.capacity_for(t, n) == jmoe.capacity_for(j, n)
    # phi3.5's decode batch of 4: capacity 2, so decode can drop.
    assert tmoe.capacity_for(tconfigs.get("phi3.5-moe-42b-a6.6b"), 4) == 2
