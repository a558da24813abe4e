"""Quantum Exponent and the qm+qe composite of the port against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks bit
for bit; the JAX side runs its default ``ref`` backend.

Tolerances. ``truncate_exponent`` and ``qe_quantize``'s forward are bit
machines and must be equal; ``qe_quantize``'s dx is straight-through
(equal) and its de an f32 sum of identical terms in another order, whose
saturated terms (x up to 2^80 clamped to 2^15) cancel: held to 1e-6 of
the sum of the terms' magnitudes. The training step follows ``tests/test_torch_train.py``: f32 loss,
grad norm and penalty to rtol 1e-5, both sub-policies' learned bitlengths
after their SGD step to 1e-6, gradients (read from AdamW's first moment)
to 1e-5 of each tensor's largest. The JAX composite is built with the
container set on itself (ROADMAP §C: ``repro.policies.get("qm+qe",
container=...)`` leaves the composite's own container at sfp8).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro import configs as jconfigs
from repro import policies as jpolicies
from repro.configs.base import reduced as jreduced
from repro.core import containers as jcontainers
from repro.core import quantum_exponent as jqe
from repro.data import synthetic as jsyn
from repro.models import common as jcommon
from repro.models.model import DecoderModel as JModel
from repro.optim import adamw as jadamw
from repro.optim.schedule import Schedule as JSchedule
from repro.train import step as jstep
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import containers as tcontainers
from repro_torch.core import quantum_exponent as tqe
from repro_torch.core.stash import float_leaves
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.train import step as tstep

torch.set_num_threads(2)

DTYPES = {torch.bfloat16: (jnp.bfloat16, np.uint16, torch.int16),
          torch.float32: (jnp.float32, np.uint32, torch.int32)}


def _edge_values(rng, dtype, n=512):
    """Bit patterns over the whole exponent field: normals of every
    binade, zeros, subnormals, the largest finite values, inf and nan."""
    jdt, ubits, ints = DTYPES[dtype]
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
    j = jax.lax.bitcast_convert_type(jnp.asarray(u), jdt)
    return t, j


def _tbits(t):
    return t.view(DTYPES[t.dtype][2]).numpy().view(DTYPES[t.dtype][1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e", range(2, 9))
def test_truncate_exponent_bit_exact(dtype, e):
    rng = np.random.default_rng(e)
    t, j = _edge_values(rng, dtype)
    want = np.asarray(jcontainers.truncate_exponent(j, e))
    got = tcontainers.truncate_exponent(t, e)
    np.testing.assert_array_equal(_tbits(got), want.view(_tbits(t).dtype))
    # A 0-d int32 tensor (a draw kept on the device) gives the same bits.
    got_t = tcontainers.truncate_exponent(t, torch.tensor(e, dtype=torch.int32))
    assert torch.equal(got_t.view(DTYPES[dtype][2]),
                       got.view(DTYPES[dtype][2]))


def test_exponent_range_matches_jax():
    spec_t, spec_j = tcontainers.BF16, jcontainers.BF16
    for e in range(0, 10):  # clipped to [2, 8]
        lo, hi = tcontainers.exponent_range(e, spec_t)
        jlo, jhi = jcontainers.exponent_range(e, spec_j)
        assert (int(lo), int(hi)) == (int(jlo), int(jhi)), e


def _j_draw(n_float, key, max_bits, min_bits=0):
    """Injected draw: ceil of the clipped bitlength, on both sides."""
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    return jnp.ceil(nf).astype(jnp.int32)


def _t_draw(n_float, generator, max_bits, min_bits=0, shape=None):
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e", [2.0, 3.5, 5.0, 7.25, 8.0])
def test_qe_quantize_vs_jax_vjp(dtype, e, monkeypatch):
    """Forward T(x, ceil e) and backward (dx straight-through, de =
    sum(g * (T(x, floor+1) - T(x, floor)))) with the draw injected."""
    monkeypatch.setattr(jcontainers, "stochastic_bitlength", _j_draw)
    rng = np.random.default_rng(int(e * 4))
    x = (rng.standard_normal((16, 64))
         * np.exp2(rng.integers(-80, 80, (16, 64)))).astype(np.float32)
    g = rng.standard_normal((16, 64)).astype(np.float32)
    jdt = DTYPES[dtype][0]
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    jout, vjp = jax.vjp(lambda a, m: jqe.qe_quantize(
        a, m, jax.random.PRNGKey(0)), jx, jnp.float32(e))
    jdx, jde = vjp(jg)
    tx = convert.to_tensor(np.asarray(jx)).requires_grad_()
    te = torch.tensor(e, requires_grad=True)
    e_int = _t_draw(te, None, 8, min_bits=tcontainers.MIN_EXP_BITS)
    out = tqe.qe_quantize(tx, te, e_int)
    np.testing.assert_array_equal(_tbits(out.detach()),
                                  np.asarray(jout).view(_tbits(tx.detach())
                                                        .dtype))
    dx, de = torch.autograd.grad(out, (tx, te),
                                 convert.to_tensor(np.asarray(jg)))
    np.testing.assert_array_equal(_tbits(dx), np.asarray(jdx).view(
        _tbits(dx).dtype))
    fl = int(np.floor(min(max(e, 2.0), 8.0)))
    diff = (np.asarray(jcontainers.truncate_exponent(jx, min(fl + 1, 8)),
                       np.float64)
            - np.asarray(jcontainers.truncate_exponent(jx, fl), np.float64))
    mag = np.abs(np.asarray(jg, np.float64) * diff).sum()
    np.testing.assert_allclose(de.item(), float(jde), rtol=0,
                               atol=1e-6 * mag + 1e-30)
    if e < 8.0:
        assert abs(de.item()) > 0


@pytest.mark.parametrize("e", [2.2, 4.0, 6.5])
def test_qe_quantize_deterministic_matches_jax(e):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(256) * np.exp2(rng.integers(-30, 30, 256))
         ).astype(np.float32)
    want = np.asarray(jqe.qe_quantize_deterministic(jnp.asarray(x),
                                                    jnp.float32(e)))
    got = tqe.qe_quantize_deterministic(torch.from_numpy(x), e)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_stochastic_bitlength_min_bits():
    """QE's draws clip to [MIN_EXP_BITS, 8]: a bitlength below 2 draws 2,
    one above 8 draws 8, a fractional one floor or floor + 1."""
    gen = torch.Generator().manual_seed(0)
    lo = tcontainers.MIN_EXP_BITS
    for n, want in ((0.5, {2}), (9.0, {8}), (4.5, {4, 5})):
        d = tcontainers.stochastic_bitlength(torch.tensor(n), gen, 8,
                                             min_bits=lo, shape=(400,))
        assert set(d.tolist()) == want, n


def _set_learn(learn, values):
    """JAX composite learn with every leaf of sub-policy s, field f set to
    values[s][f]."""
    return {s: {k: jnp.full_like(v, values[s]["act" if k.startswith("act")
                                              else "w"])
                for k, v in sub.items()} for s, sub in learn.items()}


def test_qe_policy_fields_and_reports_match_jax():
    tp, jp = tpolicies.get("qe"), jpolicies.get("qe")
    dims_kw = dict(n_periods=3, n_rem=0, man_bits=7, exp_bits=8)
    tdims, jdims = (tpolicies.ScopeDims(**dims_kw),
                    jpolicies.ScopeDims(**dims_kw))
    assert (tp.gamma, tp._min_bits(tdims), tp.lr, tp.adapts_exponent) == \
        (jp.gamma, jp._min_bits(jdims), jp.lr, jp.adapts_exponent)
    assert (tpolicies.get("qm")._min_bits(tdims)
            == jpolicies.get("qm")._min_bits(jdims))
    tc = tpolicies.get("qm+qe", container="sfp-m2e4")
    jc = jpolicies.get("qm+qe", container="sfp-m2e4")
    assert isinstance(tc, tpolicies.CompositePolicy) and tc.name == "qm+qe"
    assert tc.container == "sfp-m2e4" and tc.adapts_exponent
    jstate = jc.init_state(jdims)
    vals = {"qm": [1.2, 2.5, 3.0], "qe": [1.5, 4.25, 7.9]}
    learn = {s: dict(jstate.learn[s], act=jnp.asarray(vals[s], jnp.float32))
             for s in ("qm", "qe")}
    jstate = jstate._replace(learn=learn)
    tstate = tpolicies.PolicyState(
        learn={s: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
               for s, d in learn.items()},
        ctrl={"qm": {}, "qe": {}})
    assert tc.layer_decisions(tstate, tdims) == jc.layer_decisions(jstate,
                                                                   jdims)
    assert tc.decision_summary(tstate, tdims) == jc.decision_summary(jstate,
                                                                     jdims)
    tm, jm = tc.metrics(tstate, tdims), jc.metrics(jstate, jdims)
    assert set(tm) == set(jm) == {"qm_act_mean", "qm_w_mean", "qe_act_mean",
                                  "qe_w_mean"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_update_learn_uses_min_bits_and_penalty_keeps_zero():
    """QE's SGD step clips to [2, 8] (the JAX ``_min_bits`` hook), while
    its penalty clips to [0, 8] with jnp.clip's half gradient on a
    bound."""
    dims = tpolicies.ScopeDims(n_periods=2, n_rem=0, man_bits=7, exp_bits=8)
    pol = tpolicies.get("qe", lr=1.0)
    st = pol.init_state(dims)
    learn = {k: torch.tensor([2.1, 8.0][:v.numel()], requires_grad=True)
             for k, v in st.learn.items()}
    grads = {k: torch.full_like(v, 5.0) for k, v in learn.items()}
    new = pol.update_learn(learn, grads, dims)
    assert new["act"].tolist() == [2.0, 3.0]
    lam = {k: torch.ones_like(v) for k, v in learn.items()}
    (g,) = torch.autograd.grad(pol.penalty(learn, lam, dims), learn["act"])
    np.testing.assert_allclose(g.numpy(), [0.05, 0.025])


# ---------------------------------------------------------------------------
# One qm+qe training step over an sfp-m2e4 stash
# ---------------------------------------------------------------------------

B, S, LR, CONTAINER = 4, 64, 3e-3, "sfp-m2e4"
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
# Learned bits: qm act 1.5 -> n 2 (floor 1; sfp-m2e4 keeps 2 mantissa
# bits), qe act 3.5 -> e 4 (floor 3), so both stash estimators see a
# one-bit-tighter budget that changes the stash; weights qm 4.5 -> 5, qe
# 4.5 -> 5.
BITS = {"qm": {"act": 1.5, "w": 4.5}, "qe": {"act": 3.5, "w": 4.5}}


def _setup(dtype):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=4), n_kv_heads=2,
                                   dtype=dtype)
    jc = cut(jconfigs.get("gemma2-2b"), jreduced)
    tc = cut(tconfigs.get("gemma2-2b"), treduced)
    kw = dict(container=CONTAINER)
    subs = (jpolicies.get("qm", gamma=0.05, lr=0.05, **kw),
            jpolicies.get("qe", gamma=0.05, lr=0.05, **kw))
    jp = jpolicies.CompositePolicy(policies=subs, container=CONTAINER)
    tp = tpolicies.CompositePolicy(policies=(
        tpolicies.get("qm", gamma=0.05, lr=0.05, **kw),
        tpolicies.get("qe", gamma=0.05, lr=0.05, **kw)), container=CONTAINER)
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED))
    jm, tm = JModel(jc, jp), TModel(tc, tp, device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    js = js._replace(pstate=js.pstate._replace(
        learn=_set_learn(js.pstate.learn, BITS)),
        step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    return (jm, jtc, js), (tm, ttc, ts), corpus


@pytest.fixture(scope="module")
def qmqe_step():
    """The JAX step once (draws injected as ceil), with the period-0
    stash it packs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcontainers, "stochastic_bitlength", _j_draw)
    try:
        (jm, jtc, js), port, corpus = _setup("float32")
        b = corpus.batch(0)
        batch = {k: jnp.asarray(v) for k, v in b.items()}
        new, met = jax.jit(jstep.make_train_step(jm, jtc))(js, batch)
        h0 = jcommon.embed(js.params["embed"], batch["tokens"],
                           jm.cfg.d_model ** 0.5)
        h0 = jcontainers.truncate_exponent(h0, 4)
        stash0 = jcodecs.get(CONTAINER).pack(h0, bits=2)
        return {"metrics": {k: float(np.asarray(v)) for k, v in met.items()},
                "state": jax.tree.map(np.asarray, new), "batch": b,
                "port": port, "stash0": {k: np.asarray(v) for k, v in
                                         stash0.data.items()},
                "h0": np.asarray(h0)}
    finally:
        mp.undo()


def test_qmqe_step_matches_jax(qmqe_step, monkeypatch):
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", _t_draw)
    run = qmqe_step
    tm, ttc, ts = run["port"]
    codec = tcodecs.get(CONTAINER)
    packed = []
    pack = codec.pack

    def recording_pack(x, bits=None):
        p = pack(x, bits=bits)
        packed.append((x, p))
        return p
    monkeypatch.setattr(codec, "pack", recording_pack)
    new, met = tstep.make_train_step(tm, ttc)(
        ts, {k: torch.from_numpy(v).long() for k, v in run["batch"].items()})
    want = run["metrics"]
    for k in ("loss", "xent", "grad_norm", "policy_penalty", "lr"):
        np.testing.assert_allclose(float(met[k]), want[k], rtol=1e-5,
                                   err_msg=k)
    for k in ("qm_act_mean", "qm_w_mean", "qe_act_mean", "qe_w_mean"):
        np.testing.assert_allclose(float(met[k]), want[k], atol=1e-6,
                                   err_msg=k)
    jst = run["state"]
    for s in ("qm", "qe"):
        for k, v in jst.pstate.learn[s].items():
            got = new.pstate.learn[s][k].detach().numpy()
            np.testing.assert_allclose(got, v, atol=1e-6, err_msg=(s, k))
        # The penalty moves both periods alike: only the estimators part
        # them.
        for k in ("act", "w"):
            assert np.ptp(new.pstate.learn[s][k].detach().numpy()) > 1e-5, \
                (s, k)
    jm_ = convert.from_jax(jst.opt.m, tm.cfg)
    for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                   float_leaves(new.opt.m)):
        a, b = m.numpy(), tm_.numpy()
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(a).max(), 1e-30), \
            path
    # The period-0 stash: the embedding's exponents truncated at e = 4,
    # then packed into sfp-m2e4 planes at n = 2.
    assert len(packed) == tm.cfg.n_periods
    x0, p0 = packed[0]
    assert p0.data["payload"].shape == (B, S, (tm.cfg.d_model // 128) * 112)
    for k, v in run["stash0"].items():
        np.testing.assert_array_equal(p0.data[k].numpy(), v, err_msg=k)
    flushed = (x0 == 0).float().mean().item()
    assert flushed > 0, "the exponent truncation flushed nothing"


def test_stash_truncation_count():
    """The model's debug counter adds exactly the values the stash's
    exponent truncation flushed and saturated: one period, QE's bits at 2,
    so every draw is e = 2, on the embedding output."""
    cfg = dataclasses.replace(treduced(tconfigs.get("gemma2-2b"),
                                       n_layers=2), n_kv_heads=2,
                              dtype="float32")
    pol = tpolicies.CompositePolicy(policies=(
        tpolicies.get("qm", container=CONTAINER),
        tpolicies.get("qe", init_bits=2.0, container=CONTAINER)),
        container=CONTAINER)
    model = TModel(cfg, pol, device="cpu")
    assert cfg.n_periods == 1 and model.truncation_count is None
    tc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                           schedule=TSchedule(**SCHED))
    state = tstep.init_state(model, 0, tc)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16))).long()
    h = tcommon.embed(state.params["embed"], tokens, cfg.d_model ** 0.5)
    t = tcontainers.truncate_exponent(h, 2)
    want = {"flushed": int(((t == 0) & (h != 0)).sum()),
            "saturated": int(((t != h) & (t != 0)).sum())}
    assert sum(want.values()) > 0
    model.truncation_count = {}
    tstep.make_train_step(model, tc)(state, {"tokens": tokens,
                                             "labels": tokens})
    assert {k: int(v) for k, v in model.truncation_count.items()} == want


def test_cpu_launcher_reports_both_sub_policies(capsys):
    res = tlaunch.main(["--arch", "gemma2-2b", "--preset", "tiny",
                        "--policy", "qm+qe", "--container", CONTAINER,
                        "--qe-gamma", "0.2", "--qe-lr", "0.1",
                        "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    for k in ("qm_act_mean", "qe_act_mean", "qe_w_mean"):
        assert f'"{k}"' in out, k
    pol = res["state"].pstate
    assert set(pol.learn) == {"qm", "qe"}
    assert res["history"][-1]["qe_act_mean"] < 8.0
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    args = tlaunch.build_parser().parse_args(
        ["--arch", "gemma2-2b", "--policy", "qm+qe", "--container",
         CONTAINER, "--qe-gamma", "0.2", "--qe-lr", "0.1"])
    p = tlaunch.build_policy(args)
    assert p.container == CONTAINER
    assert (p.policies[1].gamma, p.policies[1].lr) == (0.2, 0.1)
    assert (p.policies[0].gamma, p.policies[0].init_bits) == (0.05, 7.0)
