"""BitChop and BitWave controllers, the controller and static policies and
the policy registry of the port against the JAX package, on the CPU.

The controllers are held register for register to JAX's over loss
sequences made with numpy (and drawn by hypothesis): the integer
registers (n, n_man, n_exp, turn, step, hold_until) equal, the f32 EMAs
(mavg, err_ema) to rtol 1e-6 (the same f32 operations in the same order).
The policies' methods are held to JAX's on the same states and inputs:
decisions and metrics equal, quantizers bit-equal forward with an
identity gradient. ``static``'s weight fake-quant departs from JAX's (a
straight-through gradient where JAX's has none, ROADMAP §C); its forward
is held to JAX's bits and its gradient to a JAX subclass that uses
``repro.policies.apply_decision_ste``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import policies as jpolicies
from repro.core import bitchop as jbc
from repro_torch import NotYetPorted
from repro_torch import policies as tpolicies
from repro_torch.core import bitchop as tbc
from repro_torch.core import containers as tcontainers

torch.set_num_threads(1)

JDIMS = jpolicies.ScopeDims(n_periods=3, n_rem=2, man_bits=7, exp_bits=8)
TDIMS = tpolicies.ScopeDims(n_periods=3, n_rem=2, man_bits=7, exp_bits=8)
EMA_RTOL = 1e-6


def _losses(n=40):
    """Improving for 15 steps, flat inside the noise for 10, then
    regressing for 15; f32."""
    rng = np.random.default_rng(0)
    down = 5.0 - 0.2 * np.arange(15) + 0.01 * rng.standard_normal(15)
    flat = down[-1] + 1e-4 * rng.standard_normal(10)
    up = flat[-1] + 0.3 * np.arange(1, 16) + 0.01 * rng.standard_normal(15)
    return np.concatenate([down, flat, up])[:n].astype(np.float32)


def _assert_state(t, j, fields):
    for f in fields:
        got, want = getattr(t, f), np.asarray(getattr(j, f))
        assert got.dtype == (torch.float32 if f in ("mavg", "err_ema")
                             else torch.int32), f
        if f in ("mavg", "err_ema"):
            np.testing.assert_allclose(got.numpy(), want, rtol=EMA_RTOL,
                                       err_msg=f)
        else:
            assert int(got) == int(want), f


BC_FIELDS = ("mavg", "err_ema", "n", "step", "hold_until")
BW_FIELDS = ("mavg", "err_ema", "n_man", "n_exp", "turn", "step",
             "hold_until")


def _run_bitchop(losses, changed, **kw):
    jcfg, tcfg = jbc.BitChopConfig(**kw), tbc.BitChopConfig(**kw)
    js, ts = jbc.init(jcfg), tbc.init(tcfg)
    _assert_state(ts, js, BC_FIELDS)
    update = jax.jit(jbc.update, static_argnums=2)
    seen = set()
    for loss, lr_changed in zip(losses, changed):
        js = update(js, jnp.float32(loss), jcfg, jnp.asarray(lr_changed))
        ts = tbc.update(ts, torch.tensor(loss), tcfg, lr_changed=lr_changed)
        _assert_state(ts, js, BC_FIELDS)
        eff = tbc.effective_bits(ts, tcfg)
        assert int(eff) == int(jbc.effective_bits(js, jcfg))
        seen.add(int(eff))
    return seen


def _run_bitwave(losses, changed, **kw):
    jcfg, tcfg = jbc.BitWaveConfig(**kw), tbc.BitWaveConfig(**kw)
    js, ts = jbc.bitwave_init(jcfg), tbc.bitwave_init(tcfg)
    _assert_state(ts, js, BW_FIELDS)
    update = jax.jit(jbc.bitwave_update, static_argnums=2)
    seen = set()
    for loss, lr_changed in zip(losses, changed):
        js = update(js, jnp.float32(loss), jcfg, jnp.asarray(lr_changed))
        ts = tbc.bitwave_update(ts, torch.tensor(loss), tcfg,
                                lr_changed=lr_changed)
        _assert_state(ts, js, BW_FIELDS)
        man, exp = tbc.bitwave_effective(ts, tcfg)
        jman, jexp = jbc.bitwave_effective(js, jcfg)
        assert (int(man), int(exp)) == (int(jman), int(jexp))
        seen.add((int(man), int(exp)))
    return seen


def test_bitchop_controller_matches_jax():
    """40 steps (warm-up 3, a decision every second step, a learning-rate
    change at step 30 that holds full precision for 5 steps): n shrinks
    while the loss improves, holds, grows, and returns to 7 in the hold."""
    changed = [i == 30 for i in range(40)]
    seen = _run_bitchop(_losses(), changed, warmup_steps=3, period=2,
                        lr_change_hold=5)
    assert min(seen) <= 2 and 7 in seen


def test_bitwave_controller_matches_jax():
    changed = [i == 30 for i in range(40)]
    seen = _run_bitwave(_losses(), changed, warmup_steps=3, period=2,
                        lr_change_hold=5)
    assert min(m for m, _ in seen) < 7 and min(e for _, e in seen) < 8
    assert (7, 8) in seen


def test_controllers_hypothesis():
    """Drawn loss sequences, learning-rate changes and controller knobs."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(
        losses=st.lists(st.floats(0.0625, 20.0, width=32), min_size=1,
                        max_size=24),
        changes=st.lists(st.booleans(), min_size=24, max_size=24),
        warmup=st.integers(0, 4), period=st.integers(1, 3),
        hold=st.integers(0, 6), alpha=st.sampled_from([0.1, 0.5, 0.9]))
    def check(losses, changes, warmup, period, hold, alpha):
        losses = np.asarray(losses, np.float32)
        kw = dict(warmup_steps=warmup, period=period, lr_change_hold=hold,
                  alpha=alpha)
        _run_bitchop(losses, changes, **kw)
        _run_bitwave(losses, changes, **kw)

    check()


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.detach().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _inputs(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((8, 64))
         * np.exp2(rng.integers(-70, 70, (8, 64)))).astype(np.float32)
    g = rng.standard_normal((8, 64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    tx = torch.from_numpy(x).to(dtype)
    tg = torch.from_numpy(g).to(dtype)
    assert (_bits(tx) == _bits(jx)).all() and (_bits(tg) == _bits(jg)).all()
    return (jx, jg), (tx, tg)


def _quantizer_matches(jfn, tfn, dtype):
    """Forward bit-equal to JAX's; the port's gradient is the identity."""
    (jx, jg), (tx, tg) = _inputs(dtype)
    want = jfn(jx)
    x = tx.clone().requires_grad_(True)
    out = tfn(x)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    assert not torch.equal(out.detach(), tx), "the quantizer changed nothing"
    (dx,) = torch.autograd.grad(out, x, tg)
    assert torch.equal(dx, tg)
    return jg


def _controller_states(jpol, tpol, losses):
    """Both policies' states after observing ``losses`` (warm-up 0)."""
    js, ts = jpol.init_state(JDIMS), tpol.init_state(TDIMS)
    for loss in losses:
        js = js._replace(ctrl=jpol.observe(js.ctrl, jnp.float32(loss),
                                           jnp.asarray(False), JDIMS))
        ts = ts._replace(ctrl=tpol.observe(ts.ctrl, torch.tensor(loss),
                                           False, TDIMS))
    return js, ts


LOSSES = np.asarray([5.0, 4.0, 3.0, 2.5, 2.0], np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitchop_policy_matches_jax(dtype):
    jpol = jpolicies.get("bitchop", warmup_steps=0)
    tpol = tpolicies.get("bitchop", warmup_steps=0)
    assert (tpol.name, tpol.enabled, tpol.adapts_exponent,
            tpol.has_stash_grad, tpol.requires_act_bits,
            tpol.quantizes_weights) == (
        jpol.name, jpol.enabled, jpol.adapts_exponent, jpol.has_stash_grad,
        jpol.requires_act_bits, jpol.quantizes_weights)
    js, ts = _controller_states(jpol, tpol, LOSSES)
    assert int(ts.ctrl.n) == int(js.ctrl.n) < 7
    jv = jpol.control_view(js.ctrl, JDIMS)
    tv = tpol.control_view(ts.ctrl, TDIMS)
    assert int(tv["act"]) == int(jv["act"])
    jf, tf = (jpol.forward_view({}, jv, JDIMS),
              tpol.forward_view({}, tv, TDIMS))
    jsl, tsl = jpol.scan_slices(jf, JDIMS), tpol.scan_slices(tf, TDIMS)
    np.testing.assert_array_equal(tsl["act"].numpy(), np.asarray(jsl["act"]))
    assert int(tpol.rem_slice(tf, 1, TDIMS)["act"]) == int(
        jpol.rem_slice(jf, 1, JDIMS)["act"])
    for p in range(TDIMS.n_periods):
        jd = jpol.act_decision({"act": jsl["act"][p]}, jax.random.PRNGKey(0),
                               JDIMS)
        td = tpol.act_decision({"act": tsl["act"][p]}, None, TDIMS)
        assert (int(td.man_bits), int(td.exp_bits)) == (int(jd.man_bits),
                                                        int(jd.exp_bits))
    sl = {"act": tsl["act"][0]}
    _quantizer_matches(
        lambda x: jpol.quantize_act(x, {"act": jsl["act"][0]},
                                    jax.random.PRNGKey(0), JDIMS),
        lambda x: tpol.quantize_act(x, sl, None, TDIMS), dtype)
    assert {k: float(v) for k, v in tpol.metrics(ts, TDIMS).items()} == {
        k: float(v) for k, v in jpol.metrics(js, JDIMS).items()}
    assert {k: int(v) for k, v in tpol.snapshot(ts).items()} == {
        k: int(v) for k, v in jpol.snapshot(js).items()}
    assert tpol.decision_summary(ts, TDIMS) == jpol.decision_summary(js,
                                                                    JDIMS)
    assert tpol.layer_decisions(ts, TDIMS) == jpol.layer_decisions(js, JDIMS)
    assert tpol.weight_draws(sl, None, 4, TDIMS) is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitwave_policy_matches_jax(dtype):
    jpol = jpolicies.get("bitwave", warmup_steps=0)
    tpol = tpolicies.get("bitwave", warmup_steps=0)
    assert (tpol.adapts_exponent, tpol.requires_act_bits,
            tpol.quantizes_weights) == (True, True, False)
    js, ts = _controller_states(jpol, tpol, LOSSES)
    assert int(ts.ctrl.n_exp) == int(js.ctrl.n_exp) < 8
    jv = jpol.control_view(js.ctrl, JDIMS)
    tv = tpol.control_view(ts.ctrl, TDIMS)
    assert {k: int(v) for k, v in tv.items()} == {k: int(v)
                                                  for k, v in jv.items()}
    jsl = jpol.scan_slices(jpol.forward_view({}, jv, JDIMS), JDIMS)
    tsl = tpol.scan_slices(tpol.forward_view({}, tv, TDIMS), TDIMS)
    for k in ("act", "act_e"):
        np.testing.assert_array_equal(tsl[k].numpy(), np.asarray(jsl[k]))
    assert {k: int(v) for k, v in tpol.rem_slice(tv, 0, TDIMS).items()} == \
        {k: int(v) for k, v in jpol.rem_slice(jv, 0, JDIMS).items()}
    jd = jpol.act_decision(jv, jax.random.PRNGKey(0), JDIMS)
    td = tpol.act_decision(tv, None, TDIMS)
    assert (int(td.man_bits), int(td.exp_bits)) == (int(jd.man_bits),
                                                    int(jd.exp_bits))
    # Without the exponent leaf the decision keeps the full exponent.
    td1 = tpol.act_decision({"act": tv["act"]}, None, TDIMS)
    jd1 = jpol.act_decision({"act": jv["act"]}, jax.random.PRNGKey(0), JDIMS)
    assert int(td1.exp_bits) == int(jd1.exp_bits) == 8
    # A narrower exponent, so the quantizer also flushes and saturates.
    jn = {"act": jnp.int32(3), "act_e": jnp.int32(4)}
    tn = {"act": torch.tensor(3, dtype=torch.int32),
          "act_e": torch.tensor(4, dtype=torch.int32)}
    for jsl_, tsl_ in ((jv, tv), (jn, tn)):
        _quantizer_matches(
            lambda x: jpol.quantize_act(x, jsl_, jax.random.PRNGKey(0),
                                        JDIMS),
            lambda x: tpol.quantize_act(x, tsl_, None, TDIMS), dtype)
    assert {k: float(v) for k, v in tpol.metrics(ts, TDIMS).items()} == {
        k: float(v) for k, v in jpol.metrics(js, JDIMS).items()}
    assert {k: int(v) for k, v in tpol.snapshot(ts).items()} == {
        k: int(v) for k, v in jpol.snapshot(js).items()}
    assert tpol.decision_summary(ts, TDIMS) == jpol.decision_summary(js,
                                                                    JDIMS)
    assert tpol.layer_decisions(ts, TDIMS) == jpol.layer_decisions(js, JDIMS)


@dataclasses.dataclass(frozen=True)
class JStaticSTE(jpolicies.StaticPolicy):
    """JAX's static policy with the port's straight-through weight
    fake-quant (the departure of ROADMAP §C)."""

    def quantize_weight(self, w, pslice, key, dims):
        d = jpolicies.PrecisionDecision(
            man_bits=jnp.asarray(self.static_weight_bits, jnp.int32),
            exp_bits=self._exp(dims))
        return jpolicies.apply_decision_ste(
            w, d, dims, adapts_exponent=self.adapts_exponent)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("exp_bits", [None, 5])
def test_static_policy_matches_jax(dtype, exp_bits):
    kw = dict(static_act_bits=2, static_weight_bits=4,
              static_exp_bits=exp_bits)
    jpol, tpol = jpolicies.get("static", **kw), tpolicies.get("static", **kw)
    jste = JStaticSTE(**kw)
    assert (tpol.adapts_exponent, tpol.quantizes_weights) == (
        jpol.adapts_exponent, jpol.quantizes_weights)
    js, ts = jpol.init_state(JDIMS), tpol.init_state(TDIMS)
    assert tpol.forward_view(ts.learn, tpol.control_view(ts.ctrl, TDIMS),
                             TDIMS) == {}
    jd = jpol.act_decision({}, jax.random.PRNGKey(0), JDIMS)
    td = tpol.act_decision({}, torch.Generator(), TDIMS)
    assert (int(td.man_bits), int(td.exp_bits)) == (int(jd.man_bits),
                                                    int(jd.exp_bits))
    assert td.man_bits.device.type == "cpu"
    _quantizer_matches(
        lambda x: jpol.quantize_act(x, {}, jax.random.PRNGKey(0), JDIMS),
        lambda x: tpol.quantize_act(x, {}, None, TDIMS), dtype)
    # Weights: the forward equals JAX's own (non-differentiable) quantizer
    # bit for bit; the gradient is JAX's straight-through subclass's.
    jg = _quantizer_matches(
        lambda x: jpol.quantize_weight(x, {}, jax.random.PRNGKey(0), JDIMS),
        lambda x: tpol.quantize_weight(x, {}, None, TDIMS), dtype)
    (jx, _), _ = _inputs(dtype)
    _, vjp = jax.vjp(lambda x: jste.quantize_weight(x, {}, None, JDIMS), jx)
    np.testing.assert_array_equal(_bits(vjp(jg)[0]), _bits(jg))
    assert tpol.decision_summary(ts, TDIMS) == jpol.decision_summary(js,
                                                                    JDIMS)
    assert tpol.layer_decisions(ts, TDIMS) == jpol.layer_decisions(js, JDIMS)
    assert tpol.metrics(ts, TDIMS) == {} and tpol.snapshot(ts) == {}


def test_ste_helpers_match_jax():
    """``ste_truncate`` and ``apply_decision_ste`` (with and without the
    exponent) bit-equal to JAX's forward, identity gradient."""
    d_j = jpolicies.PrecisionDecision(man_bits=jnp.int32(2),
                                      exp_bits=jnp.int32(3))
    d_t = tpolicies.PrecisionDecision(
        man_bits=torch.tensor(2, dtype=torch.int32),
        exp_bits=torch.tensor(3, dtype=torch.int32))
    for dtype in (torch.bfloat16, torch.float32):
        _quantizer_matches(lambda x: jpolicies.ste_truncate(x, 2),
                           lambda x: tpolicies.ste_truncate(x, 2), dtype)
        for adapts in (False, True):
            _quantizer_matches(
                lambda x: jpolicies.apply_decision_ste(
                    x, d_j, JDIMS, adapts_exponent=adapts),
                lambda x: tpolicies.apply_decision_ste(
                    x, d_t, TDIMS, adapts_exponent=adapts), dtype)


# ---------------------------------------------------------------------------
# Registry and composition
# ---------------------------------------------------------------------------


def test_registry_names_and_validation():
    assert tpolicies.names() == jpolicies.names()
    for name in tpolicies.names():
        assert tpolicies.get(name).name == name
    for name in ("qm+bitchop", "qm+qe", "static", "bitwave", "qm+afloat"):
        assert tpolicies.validate_name(name) == jpolicies.validate_name(name)
    # afloat is ported: it resolves, and no policy name is left to raise
    # NotYetPorted.
    assert isinstance(tpolicies.get("afloat"), tpolicies.AFloatPolicy)
    assert tpolicies.get("qm+afloat").name == "qm+afloat"
    assert tpolicies.base.NOT_YET_PORTED == ()
    assert issubclass(NotYetPorted, NotImplementedError)
    with pytest.raises(ValueError, match="did you mean 'bitchop'"):
        tpolicies.validate_name("bitchip")
    with pytest.raises(TypeError):
        tpolicies.get("bitchop", gamma=0.5)     # not a bitchop knob
    with pytest.raises(KeyError):
        tpolicies.get("bitchop+bitchop")


def test_qm_bitchop_composes_as_jax():
    """Overrides reach the sub-policy that declares them; the composite's
    flags, decision (field-wise min), metrics and snapshot follow JAX's;
    only qm draws for and fake-quantizes weights."""
    kw = dict(gamma=0.7, warmup_steps=0, container="sfp8")
    jp, tp = jpolicies.get("qm+bitchop", **kw), tpolicies.get("qm+bitchop",
                                                              **kw)
    by = {s.name: s for s in tp.policies}
    assert by["qm"].gamma == 0.7 and by["bitchop"].warmup_steps == 0
    assert all(s.container == "sfp8" for s in tp.policies)
    for attr in ("name", "enabled", "adapts_exponent", "has_stash_grad",
                 "requires_act_bits", "quantizes_weights"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    js, ts = jp.init_state(JDIMS), tp.init_state(TDIMS)
    for loss in LOSSES:
        js = js._replace(ctrl=jp.observe(js.ctrl, jnp.float32(loss),
                                         jnp.asarray(False), JDIMS))
        ts = ts._replace(ctrl=tp.observe(ts.ctrl, torch.tensor(loss), False,
                                         TDIMS))
    learn_t = {**ts.learn, "qm": {k: v.detach() for k, v in
                                  ts.learn["qm"].items()}}
    jv = jp.forward_view(js.learn, jp.control_view(js.ctrl, JDIMS), JDIMS)
    tv = tp.forward_view(learn_t, tp.control_view(ts.ctrl, TDIMS), TDIMS)
    jsl = jax.tree.map(lambda a: a[1], jp.scan_slices(jv, JDIMS))
    tsl = {k: {kk: vv[1] for kk, vv in v.items()}
           for k, v in tp.scan_slices(tv, TDIMS).items()}
    jd = jp.act_decision(jsl, jax.random.PRNGKey(0), JDIMS)
    td = tp.act_decision(tsl, torch.Generator(), TDIMS)
    assert int(td.man_bits) == int(jd.man_bits) == int(ts.ctrl["bitchop"].n)
    assert int(td.exp_bits) == int(jd.exp_bits) == 8
    draws = tp.weight_draws(tsl, torch.Generator(), 3, TDIMS)
    assert set(draws) == {"qm"} and draws["qm"].shape == (3,)
    tm, jm = tp.metrics(ts, TDIMS), jp.metrics(js, JDIMS)
    assert set(tm) == set(jm) == {"qm_act_mean", "qm_w_mean", "bc_bits"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    tsnap, jsnap = tp.snapshot(ts), jp.snapshot(js)
    assert set(tsnap) == set(jsnap) == {"act", "w", "bc_bits"}
    for k in jsnap:
        np.testing.assert_array_equal(np.asarray(tsnap[k].detach()),
                                      np.asarray(jsnap[k]))
    assert tp.decision_summary(ts, TDIMS) == jp.decision_summary(js, JDIMS)
    assert tp.layer_decisions(ts, TDIMS) == jp.layer_decisions(js, JDIMS)
    rs = tp.rem_slice(tv, 0, TDIMS)
    assert set(rs) == {"qm", "bitchop"} and rs["qm"]["act"].shape == ()


@pytest.mark.parametrize("name,bits", [("qm", 3.0), ("qe", 5.0)])
def test_learned_policies_quantize_act_match_jax(name, bits):
    """QM's and QE's activation quantizer (the CNN path's): at an integer
    bitlength the draw is that integer on both sides, the forward is
    bit-equal, dx is straight-through and the bitlength's gradient (a sum
    of g * (T(floor + 1) - T(floor)) over the tensor, in another order)
    agrees to 1e-5 of the sum of its terms' magnitudes."""
    jpol, tpol = jpolicies.get(name), tpolicies.get(name)
    (jx, jg), (tx, tg) = _inputs(torch.float32)
    jn = jnp.float32(bits)
    out, vjp = jax.vjp(lambda x, n: jpol.quantize_act(
        x, {"act": n}, jax.random.PRNGKey(0), JDIMS), jx, jn)
    jdx, jdn = vjp(jg)
    x = tx.clone().requires_grad_(True)
    n = torch.tensor(bits, requires_grad=True)
    got = tpol.quantize_act(x, {"act": n}, torch.Generator(), TDIMS)
    np.testing.assert_array_equal(_bits(got), _bits(out))
    dx, dn = torch.autograd.grad(got, (x, n), tg)
    assert torch.equal(dx, tg)
    trunc = (tcontainers.truncate_mantissa if name == "qm"
             else tcontainers.truncate_exponent)
    terms = tg.double() * (trunc(tx, int(bits) + 1) - trunc(tx, int(bits))
                           ).double()
    scale = float(terms.abs().sum())
    assert scale > 0
    assert abs(float(dn) - float(jdn)) <= 1e-5 * scale
