"""AdaptivFloat (``afloat``, ``truncate_exponent(bias_offset=)``): the port
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks bit
for bit; the JAX side runs its default ``ref`` backend. Where a test
trains or quantizes through the policy, the stochastic bitlengths are
injected as the ceiling of the clipped parameter on both sides (the two
packages draw from different generators).

Tolerances. ``truncate_exponent`` and the bias shift's forward are bit
machines: equal. The shift's dx is straight-through (equal); its db is an
f32 sum of the same terms in another order, held to 1e-6 of the sum of
the terms' magnitudes, as QE's de is (``tests/test_torch_qe.py``). The
training steps follow ``tests/test_torch_qe.py``: f32 loss, grad norm and
penalty to rtol 1e-5, the learned bitlengths and biases after their SGD
step to 1e-6.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro import policies as jpolicies
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import reduced as jreduced
from repro.core import containers as jcontainers
from repro.data import synthetic as jsyn
from repro.models.model import DecoderModel as JModel
from repro.optim import adamw as jadamw
from repro.optim.schedule import Schedule as JSchedule
from repro.policies import afloat as jafloat
from repro.serve import precision as jprecision
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import containers as tcontainers
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.policies import afloat as tafloat
from repro_torch.serve import precision as tprecision
from repro_torch.train import step as tstep

torch.set_num_threads(2)

DTYPES = {torch.bfloat16: (jnp.bfloat16, np.uint16, torch.int16),
          torch.float32: (jnp.float32, np.uint32, torch.int32)}


def _edge_values(rng, dtype, n=512):
    """Bit patterns over the whole exponent field: normals of every
    binade, zeros, subnormals, the largest finite values, inf and nan."""
    jdt, ubits, _ = DTYPES[dtype]
    if dtype == torch.bfloat16:
        u = rng.integers(0, 1 << 16, n).astype(np.uint16)
        u[:8] = [0x0000, 0x8000, 0x0001, 0x807F, 0x7F7F, 0xFF7F, 0x7F80,
                 0xFFC1]
    else:
        u = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        u[:8] = [0, 0x80000000, 1, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                 0x7F800000, 0xFFC00001]
    t = torch.from_numpy(u.view(np.int16 if ubits == np.uint16
                                else np.int32).copy()).view(dtype)
    return t, jax.lax.bitcast_convert_type(jnp.asarray(u), jdt)


def _tbits(t):
    t = t.detach()
    return t.view(DTYPES[t.dtype][2]).numpy().view(DTYPES[t.dtype][1])


def _j_draw(n_float, key, max_bits, min_bits=0):
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    return jnp.ceil(nf).astype(jnp.int32)


def _t_draw(n_float, generator, max_bits, min_bits=0, shape=None):
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


@pytest.fixture
def ceil_draws(monkeypatch):
    monkeypatch.setattr(jcontainers, "stochastic_bitlength", _j_draw)
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", _t_draw)


# ---------------------------------------------------------------------------
# truncate_exponent(bias_offset=) and the bias shift
# ---------------------------------------------------------------------------

OFFSETS = list(range(-70, 71))   # past the clip to the source's range


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e", range(2, 9))
def test_truncate_exponent_bias_offset_bit_exact(dtype, e):
    t, j = _edge_values(np.random.default_rng(e), dtype)
    shifted = jax.jit(lambda x, b: jcontainers.truncate_exponent(
        x, e, bias_offset=b))
    for b in OFFSETS:
        want = np.asarray(shifted(j, jnp.int32(b))).view(_tbits(t).dtype)
        np.testing.assert_array_equal(
            _tbits(tcontainers.truncate_exponent(t, e, bias_offset=b)),
            want, err_msg=f"int offset {b}")
        got = tcontainers.truncate_exponent(
            t, torch.tensor(e, dtype=torch.int32),
            bias_offset=torch.tensor(b, dtype=torch.int32))
        np.testing.assert_array_equal(_tbits(got), want,
                                      err_msg=f"tensor offset {b}")
    # An int 0 is the unshifted path, and equals JAX's.
    np.testing.assert_array_equal(
        _tbits(tcontainers.truncate_exponent(t, e, bias_offset=0)),
        np.asarray(jcontainers.truncate_exponent(j, e)).view(
            _tbits(t).dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e", [2, 3, 5, 8])
@pytest.mark.parametrize("b", [-70.0, -3.5, -0.5, 0.0, 0.5, 1.5, 2.5, 17.2,
                               70.0])
def test_af_bias_shift_forward_and_vjp(dtype, e, b):
    """Forward T(x, e, round(b)) (half to even on both sides), dx
    straight-through, db = 0.5 sum(g (T(b+1) - T(b-1))) against
    ``jax.vjp``."""
    rng = np.random.default_rng(int(e * 10 + b * 4) % 2 ** 31)
    x = (rng.standard_normal((16, 64))
         * np.exp2(rng.integers(-60, 60, (16, 64)))).astype(np.float32)
    g = rng.standard_normal((16, 64)).astype(np.float32)
    jdt = DTYPES[dtype][0]
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    jout, vjp = jax.vjp(lambda a, bb: jafloat.af_bias_shift(
        a, jnp.int32(e), bb), jx, jnp.float32(b))
    jdx, jdb = vjp(jg)
    tx = convert.to_tensor(np.asarray(jx)).requires_grad_()
    tb = torch.tensor(b, requires_grad=True)
    out = tafloat.af_bias_shift(tx, torch.tensor(e, dtype=torch.int32), tb)
    np.testing.assert_array_equal(_tbits(out),
                                  np.asarray(jout).view(_tbits(out).dtype))
    dx, db = torch.autograd.grad(out, (tx, tb),
                                 convert.to_tensor(np.asarray(jg)))
    np.testing.assert_array_equal(_tbits(dx),
                                  np.asarray(jdx).view(_tbits(dx).dtype))
    bi = int(np.round(np.float32(b)))
    diff = (np.asarray(jcontainers.truncate_exponent(jx, e, bias_offset=bi
                                                     + 1), np.float64)
            - np.asarray(jcontainers.truncate_exponent(jx, e, bias_offset=bi
                                                       - 1), np.float64))
    mag = 0.5 * np.abs(np.asarray(jg, np.float64) * diff).sum()
    np.testing.assert_allclose(db.item(), float(jdb), rtol=0,
                               atol=1e-6 * mag + 1e-30)
    assert db.dtype == torch.float32 and db.shape == ()


# ---------------------------------------------------------------------------
# The policy's methods
# ---------------------------------------------------------------------------

DIMS = dict(n_periods=3, n_rem=1, man_bits=7, exp_bits=8)


def _pair(**kw):
    return tpolicies.get("afloat", **kw), jpolicies.get("afloat", **kw)


def _state_pair(tp, jp, values):
    """Both packages' states with every learn leaf set from ``values``
    (key -> list); the port's leaves require grad."""
    jd = jpolicies.ScopeDims(**DIMS)
    js = jp.init_state(jd)
    learn = {k: (jnp.asarray(values[k], jnp.float32) if k in values else v)
             for k, v in js.learn.items()}
    js = js._replace(learn=learn)
    ts = tpolicies.PolicyState(
        learn={k: torch.tensor(np.asarray(v)).requires_grad_()
               for k, v in learn.items()}, ctrl={})
    return ts, js


VALUES = {"act": [2.5, 4.0, 7.5], "w": [3.25, 8.0, 1.0], "act_rem": [5.5],
          "w_rem": [6.75], "act_b": [-2.0, 0.4, 63.0],
          "w_b": [1.5, -70.0, 3.0], "act_rem_b": [-1.0], "w_rem_b": [0.5]}


def test_policy_fields_state_and_slices_match_jax():
    tp, jp = _pair(container="sfp-m2e4", bias_lr=0.2, init_bias=1.5)
    for f in ("bias_lr", "init_bias", "max_bias", "gamma", "lr",
              "container"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert (tp.name, tp.adapts_exponent, tp.has_stash_grad,
            tp.requires_act_bits, tp.quantizes_weights) == (
        jp.name, jp.adapts_exponent, jp.has_stash_grad,
        jp.requires_act_bits, jp.quantizes_weights)
    td, jd = tpolicies.ScopeDims(**DIMS), jpolicies.ScopeDims(**DIMS)
    ts, js = tp.init_state(td), jp.init_state(jd)
    assert set(ts.learn) == set(js.learn)
    for k, v in js.learn.items():
        np.testing.assert_array_equal(ts.learn[k].detach().numpy(),
                                      np.asarray(v), err_msg=k)
        assert ts.learn[k].requires_grad and ts.learn[k].dtype == \
            torch.float32
    ts, js = _state_pair(tp, jp, VALUES)
    tv = tp.forward_view(ts.learn, tp.control_view(ts.ctrl, td), td)
    jv = jp.forward_view(js.learn, jp.control_view(js.ctrl, jd), jd)
    tsl, jsl = tp.scan_slices(tv, td), jp.scan_slices(jv, jd)
    assert set(tsl) == set(jsl) == {"act", "w", "act_b", "w_b"}
    for k in jsl:
        np.testing.assert_array_equal(tsl[k].detach().numpy(),
                                      np.asarray(jsl[k]))
    tr, jr = tp.rem_slice(tv, 0, td), jp.rem_slice(jv, 0, jd)
    assert {k: float(v.detach()) for k, v in tr.items()} == \
        {k: float(v) for k, v in jr.items()}


def test_penalty_update_metrics_snapshot_match_jax():
    tp, jp = _pair(lr=0.3, bias_lr=0.7, max_bias=40.0)
    td, jd = tpolicies.ScopeDims(**DIMS), jpolicies.ScopeDims(**DIMS)
    ts, js = _state_pair(tp, jp, VALUES)
    lam = {k: np.full(len(VALUES[k]), 0.25 + i, np.float32)
           for i, k in enumerate(("act", "w", "act_rem", "w_rem"))}
    jpen, jgrad = jax.value_and_grad(
        lambda learn: jp.penalty(learn, {k: jnp.asarray(v)
                                         for k, v in lam.items()},
                                 jnp.asarray(0), jd))(js.learn)
    tpen = tp.penalty(ts.learn, {k: torch.from_numpy(v)
                                 for k, v in lam.items()}, td)
    np.testing.assert_allclose(float(tpen.detach()), float(jpen), rtol=1e-6)
    keys = sorted(ts.learn)
    tgrad = torch.autograd.grad(tpen, [ts.learn[k] for k in keys],
                                allow_unused=True)
    for k, g in zip(keys, tgrad):
        want = np.asarray(jgrad[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=k)
        if k.endswith("_b"):
            assert not want.any()
    grads = {k: np.linspace(-90.0, 90.0, len(v)).astype(np.float32)
             for k, v in VALUES.items()}
    jnew = jp.update_learn(js.learn, {k: jnp.asarray(v)
                                      for k, v in grads.items()}, jd)
    tnew = tp.update_learn(ts.learn, {k: torch.from_numpy(v)
                                      for k, v in grads.items()}, td)
    for k in jnew:
        np.testing.assert_allclose(tnew[k].detach().numpy(),
                                   np.asarray(jnew[k]), rtol=1e-7,
                                   err_msg=k)
        assert tnew[k].requires_grad
    # Biases clip to +-max_bias, bitlengths to [2, 8].
    assert float(tnew["w_b"][1].detach()) == -40.0
    assert float(tnew["act"][0].detach()) == 8.0
    tm = tp.metrics(ts, td)
    jm = jp.metrics(js, jd)
    assert set(tm) == set(jm) == {"af_act_e_mean", "af_w_e_mean",
                                  "af_act_bias_mean", "af_w_bias_mean"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    tsnap, jsnap = tp.snapshot(ts), jp.snapshot(js)
    assert set(tsnap) == set(jsnap) == {"act_e", "w_e", "act_bias",
                                        "w_bias"}
    for k in jsnap:
        np.testing.assert_array_equal(tsnap[k].detach().numpy(),
                                      np.asarray(jsnap[k]))
    # Decisions are QE's (dense sfp-m{K}e{E}), as in JAX.
    assert tp.decision_summary(ts, td) == jp.decision_summary(js, jd)
    assert tp.layer_decisions(ts, td) == jp.layer_decisions(js, jd)


def test_stash_grad_adds_zero_bias_cotangents():
    tp, jp = _pair()
    td, jd = tpolicies.ScopeDims(**DIMS), jpolicies.ScopeDims(**DIMS)
    rng = np.random.default_rng(1)
    h = (rng.standard_normal((4, 128)) * np.exp2(
        rng.integers(-12, 12, (4, 128)))).astype(np.float32)
    dh = rng.standard_normal((4, 128)).astype(np.float32)
    sl = {"act": 3.5, "w": 5.0, "act_b": 1.0, "w_b": -2.0}
    hq = tcontainers.truncate_exponent(torch.from_numpy(h), 4)
    want = jp.stash_grad(jnp.asarray(dh), jnp.asarray(hq.numpy()),
                         {k: jnp.float32(v) for k, v in sl.items()}, jd)
    got = tp.stash_grad(torch.from_numpy(dh), hq,
                        {k: torch.tensor(v) for k, v in sl.items()}, td)
    assert set(got) == set(want) == set(sl)
    np.testing.assert_allclose(float(got["act"]), float(want["act"]),
                               rtol=1e-5)
    for k in ("w", "act_b", "w_b"):
        assert float(got[k]) == float(want[k]) == 0.0


def test_afloat_policy_learns_bias():
    """The twin of JAX's ``test_afloat_policy_learns_bias``: a tensor far
    above the e-4 window pushes the bias up."""
    dims = tpolicies.ScopeDims.for_dtype(torch.float32, n_periods=2,
                                         n_rem=0)
    pol = tpolicies.get("afloat", container="sfp-m3e4")
    st = pol.init_state(dims)
    assert set(st.learn) >= {"act", "w", "act_b", "w_b"}
    gen = torch.Generator().manual_seed(0)
    w = torch.full((4, 128), 1e4)
    learn = dict(st.learn, w=torch.full((2,), 4.0, requires_grad=True))
    view = pol.forward_view(learn, pol.control_view(st.ctrl, dims), dims)
    sl = {k: v[0] for k, v in pol.scan_slices(view, dims).items()}
    draws = pol.weight_draws(sl, gen, 1, dims)
    assert draws.shape == (1, 2) and draws.dtype == torch.int32
    assert draws.tolist() == [[4, 4]]   # e = 4 exactly: no randomness
    wq = pol.quantize_weight(w, sl, draws[0], dims)
    loss = torch.sum((wq - w) ** 2)
    g = dict(zip(("w", "w_b"), torch.autograd.grad(
        loss, (learn["w"], learn["w_b"]))))
    assert float(g["w_b"][0]) < 0  # descent increases the bias
    grads = {k: g.get(k, torch.zeros_like(v)) for k, v in learn.items()}
    new = pol.update_learn(learn, grads, dims)
    assert float(new["w_b"][0].detach()) > float(learn["w_b"][0].detach())
    lam = {k: torch.ones_like(v) for k, v in st.learn.items()
           if not k.endswith("_b")}
    assert np.isfinite(float(pol.penalty(learn, lam, dims).detach()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cnn_quantize_act_with_a_bias(dtype, ceil_draws):
    """The CNN path's ``quantize_act``: QE's truncation at the act
    bitlength, then the window shifted by round(act_b); forward and the
    gradients in x, act and act_b against JAX's (salt 9 draw, injected)."""
    tp, jp = _pair()
    dims_kw = dict(n_periods=0, n_rem=0, man_bits=7 if dtype ==
                   torch.bfloat16 else 23, exp_bits=8)
    td, jd = tpolicies.ScopeDims(**dims_kw), jpolicies.ScopeDims(**dims_kw)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 8, 8, 128)) * np.exp2(
        rng.integers(-20, 20, (2, 8, 8, 128)))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt = DTYPES[dtype][0]
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    act, act_b = 3.25, 2.6  # e = 4, window shifted by 3 binades

    def jfn(a, e, b):
        return jp.quantize_act(a, {"act": e, "act_b": b},
                               jax.random.PRNGKey(0), jd)
    jout, vjp = jax.vjp(jfn, jx, jnp.float32(act), jnp.float32(act_b))
    jdx, jde, jdb = vjp(jg)
    tx = convert.to_tensor(np.asarray(jx)).requires_grad_()
    te = torch.tensor(act, requires_grad=True)
    tb = torch.tensor(act_b, requires_grad=True)
    out = tp.quantize_act(tx, {"act": te, "act_b": tb},
                          torch.Generator().manual_seed(0), td)
    np.testing.assert_array_equal(_tbits(out),
                                  np.asarray(jout).view(_tbits(out).dtype))
    assert not torch.equal(out, tx)
    dx, de, db = torch.autograd.grad(out, (tx, te, tb),
                                     convert.to_tensor(np.asarray(jg)))
    np.testing.assert_array_equal(_tbits(dx),
                                  np.asarray(jdx).view(_tbits(dx).dtype))
    for got, want in ((de, jde), (db, jdb)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert float(want) != 0.0


# ---------------------------------------------------------------------------
# Registry and composition
# ---------------------------------------------------------------------------


def test_registry_resolves_afloat_and_its_composite():
    assert tpolicies.names() == jpolicies.names()
    assert tpolicies.validate_name("qm+afloat") == \
        jpolicies.validate_name("qm+afloat") == ("qm", "afloat")
    comp = tpolicies.get("qm+afloat", container="sfp-m2e4", bias_lr=0.1)
    assert isinstance(comp, tpolicies.CompositePolicy)
    assert comp.name == "qm+afloat" and comp.container == "sfp-m2e4"
    assert comp.policies[1].bias_lr == 0.1 and comp.adapts_exponent
    assert isinstance(tpolicies.get("afloat"), tpolicies.AFloatPolicy)


# ---------------------------------------------------------------------------
# Two training steps against JAX, draws injected
# ---------------------------------------------------------------------------

B, S, LR = 4, 64, 3e-3
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
# Learned bits: qm act 2.5 (n 3), afloat/QE act 3.5 (e 4; the stash's
# exponents clamped to [-6, 7]) and w 4.5 (e 5 for both weight draws).
BITS = {"qm": {"act": 2.5, "w": 4.5}, "afloat": {"act": 3.5, "w": 4.5}}
TRAIN_CASES = [("afloat", "bit_exact"), ("afloat", "sfp-m2e4"),
               ("qm+afloat", "sfp-m2e4")]


def _set_bits(learn, sub):
    return {k: (v if k.endswith("_b") else jnp.full_like(
        v, BITS[sub]["act" if k.startswith("act") else "w"]))
        for k, v in learn.items()}


def _train_setup(policy, container):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=4), n_kv_heads=2,
                                   dtype="float32")
    jc = cut(jconfigs.get("gemma2-2b"), jreduced)
    tc = cut(tconfigs.get("gemma2-2b"), treduced)
    parts = policy.split("+")
    jsubs = tuple(jpolicies.get(p, container=container) for p in parts)
    # JAX's composite is built with the container set on itself (ROADMAP
    # §C: its get() leaves the composite's own container at sfp8).
    jp = jsubs[0] if len(parts) == 1 else jpolicies.CompositePolicy(
        policies=jsubs, container=container)
    tp = tpolicies.get(policy, container=container)
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED))
    jm, tm = JModel(jc, jp), TModel(tc, tp, device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    learn = js.pstate.learn
    learn = ({s: _set_bits(learn[s], s) for s in learn} if len(parts) > 1
             else _set_bits(learn, "afloat"))
    js = js._replace(pstate=js.pstate._replace(learn=learn),
                     step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    return (jm, jtc, js), (tm, ttc, ts), corpus


@pytest.mark.parametrize("policy,container", TRAIN_CASES)
def test_two_afloat_steps_match_jax(policy, container, ceil_draws):
    (jm, jtc, js), (tm, ttc, ts), corpus = _train_setup(policy, container)
    jfn = jax.jit(jstep.make_train_step(jm, jtc))
    tfn = tstep.make_train_step(tm, ttc)
    composite = "+" in policy
    for i in range(2):
        b = corpus.batch(i)
        js, jmet = jfn(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tfn(ts, {k: torch.from_numpy(v).long()
                            for k, v in b.items()})
        for k in ("loss", "xent", "grad_norm", "policy_penalty"):
            np.testing.assert_allclose(float(tmet[k]),
                                       float(np.asarray(jmet[k])),
                                       rtol=1e-5, err_msg=f"{i} {k}")
        assert {k for k in tmet if k.startswith("af_")} == {
            "af_act_e_mean", "af_w_e_mean", "af_act_bias_mean",
            "af_w_bias_mean"}
        for k in tmet:
            if k.startswith(("af_", "qm_")):
                np.testing.assert_allclose(float(tmet[k]),
                                           float(np.asarray(jmet[k])),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{i} {k}")
        jl = js.pstate.learn["afloat"] if composite else js.pstate.learn
        tl = ts.pstate.learn["afloat"] if composite else ts.pstate.learn
        for k, v in jl.items():
            np.testing.assert_allclose(tl[k].detach().numpy(),
                                       np.asarray(v), rtol=0, atol=1e-6,
                                       err_msg=f"{i} {k}")
        # JAX's decoder stash goes through QE's act_decision: act_b
        # never reaches the forward and stays at init_bias (0).
        for learn in (tl, jl):
            assert not np.asarray(learn["act_b"].detach() if isinstance(
                learn["act_b"], torch.Tensor) else learn["act_b"]).any()
        # w_b learns (through the weights' bias shift).
        assert np.all(tl["w_b"].detach().numpy() != 0.0)


def test_afloat_draws_two_bitlengths_per_weight_leaf():
    """``weight_draws`` gives a (count, 2) tensor: QE's bitlength and the
    window's, leaf after leaf, from the step's generator."""
    pol = tpolicies.get("afloat")
    dims = tpolicies.ScopeDims(**DIMS)
    sl = {"w": torch.tensor(4.5), "w_b": torch.tensor(0.0)}
    d = pol.weight_draws(sl, torch.Generator().manual_seed(3), 9, dims)
    assert d.shape == (9, 2) and d.dtype == torch.int32
    assert set(d.reshape(-1).tolist()) == {4, 5}
    comp = tpolicies.get("qm+afloat")
    cd = comp.weight_draws({"qm": {"w": torch.tensor(5.5)}, "afloat": sl},
                           torch.Generator().manual_seed(3), 9, dims)
    assert cd["qm"].shape == (9,) and cd["afloat"].shape == (9, 2)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,container", [("afloat", "sfp-m2e4"),
                                              ("qm+afloat", "sfp8")])
def test_cpu_launcher_trains_afloat(policy, container, capsys):
    res = tlaunch.main(["--arch", "gemma2-2b", "--preset", "tiny",
                        "--policy", policy, "--container", container,
                        "--steps", "2", "--device", "cpu"])
    capsys.readouterr()
    last = res["history"][-1]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    # From the full 8-bit field the window covers every finite weight, so
    # neither bias has a gradient yet; the penalty moves the bitlengths.
    assert last["af_act_bias_mean"] == last["af_w_bias_mean"] == 0.0
    assert last["af_w_e_mean"] < 8.0
    learn = res["state"].pstate.learn
    learn = learn["afloat"] if "+" in policy else learn
    assert {"act_b", "w_b"} <= set(learn)


def test_serve_policy_ckpt_from_an_afloat_checkpoint(tmp_path, capsys):
    """An afloat run's checkpoint stamps QE's decision; both packages'
    ``container_from_checkpoint`` derive the same container from it, and
    ``launch.serve --policy-ckpt`` serves from it."""
    ck = tmp_path / "ck"
    tlaunch.main(["--arch", "gemma2-2b", "--preset", "tiny", "--policy",
                  "afloat", "--container", "sfp-m2e4", "--steps", "2",
                  "--ckpt-dir", str(ck), "--ckpt-every", "1",
                  "--device", "cpu"])
    extra = JManager(str(ck)).read_extra(2)
    assert extra["policy"] == "afloat" and extra["container"] == "sfp-m2e4"
    assert extra["decision"]["man_bits"] == 7.0
    name = tprecision.container_from_checkpoint(str(ck))
    assert name == jprecision.container_from_checkpoint(str(ck))
    capsys.readouterr()
    tserve.main(["--arch", "gemma2-2b", "--preset", "tiny", "--batch", "2",
                 "--prompt-len", "8", "--max-new", "3", "--device", "cpu",
                 "--policy-ckpt", str(ck)])
    out = capsys.readouterr().out
    assert f"policy-aware container from {ck}: {name}" in out
    assert name.startswith("sfp-m7e")
