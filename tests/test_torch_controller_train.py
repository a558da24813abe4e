"""Training steps under BitChop, BitWave, qm+bitchop and static against
the JAX package, on the CPU.

Model: the JAX ``reduced(gemma2-2b, n_layers=4)`` in f32 (2 periods, d
128, window 32 < the 64-token sequence, 2 KV heads for 4 query heads),
B 4 / S 64, as ``tests/test_torch_train.py``. JAX initialises the state
(at step 1, so the warm-up learning rate is not 0) and
``repro_torch.convert.state_from_jax`` hands it over, the controllers'
registers included. Each case runs its steps free on both sides.

Tolerances (ROADMAP §C): f32 loss, xent and grad norm to rtol 1e-5 at
every step; the controllers' registers (n, n_man, n_exp, turn, step,
hold_until) equal and their f32 EMAs to rtol 1e-5 (they average the
losses); the gradients of a step, read back from AdamW's first moment,
to 1e-5 of each tensor's largest after the first step (later steps
start from parameters AdamW moved apart where a gradient is below ~1e-6,
ROADMAP §C). The cases:

- bitchop + sfp8, warm-up 2, cosine schedule, n injected at 4: n
  shrinks from the third step on, and the stash's fused pack gets each
  period n;
- bitwave + sfp-m2e4, warm-up 0, ``Schedule(kind="step",
  boundaries=(3,))``, n_man injected at 4: a shrink, then the
  learning-rate change at step 3 opens the hold window (full precision
  again);
- bitwave + sfp8, warm-up 0, cosine, n_man injected at 4: mantissa and
  exponent shrink in turn;
- qm+bitchop + sfp8 (2 steps; learned bits act 3 / w 5, so every draw is
  deterministic): qm fake-quantizes the weights, bitchop does not;
- static + sfp8 (2 steps; act 3 bits, weights 5): against a JAX
  ``StaticPolicy`` subclass whose weight fake-quant is straight-through
  (``repro.policies.apply_decision_ste``), the port's departure from
  JAX's own (ROADMAP §C), which a last test shows: JAX's ``static`` gives
  every layer matrix a zero gradient, the port's does not.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro import policies as jpolicies
from repro.configs.base import reduced as jreduced
from repro.data import synthetic as jsyn
from repro.models.model import DecoderModel as JModel
from repro.optim import adamw as jadamw
from repro.optim.schedule import Schedule as JSchedule
from repro.train import step as jstep
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import bitchop as tbc
from repro_torch.core.stash import float_leaves
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.train import step as tstep

torch.set_num_threads(2)

B, S, LR = 4, 64, 3e-3
RTOL = 1e-5
COSINE = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
STEP3 = dict(kind="step", base_lr=LR, warmup_steps=1, boundaries=(3,))


@dataclasses.dataclass(frozen=True)
class JStaticSTE(jpolicies.StaticPolicy):
    """JAX's static policy with a straight-through weight fake-quant."""

    def quantize_weight(self, w, pslice, key, dims):
        d = jpolicies.PrecisionDecision(
            man_bits=jnp.asarray(self.static_weight_bits, jnp.int32),
            exp_bits=self._exp(dims))
        return jpolicies.apply_decision_ste(
            w, d, dims, adapts_exponent=self.adapts_exponent)


STATIC = dict(static_act_bits=3, static_weight_bits=5)
# Injected controller registers: an f32 controller starts at 23 mantissa
# bits, which sfp8's 3 kept bits never see; from 4, a shrink reaches the
# stash's fused pack (n 3, then 2).
CTRL0 = {"bitchop": {"n": 4}, "bitwave": {"n_man": 4}}
# name: (JAX policy, port policy, container, schedule, steps)
CASES = {
    "bitchop-sfp8": ("bitchop", dict(warmup_steps=2), "sfp8", COSINE, 5),
    "bitwave-sfp-m2e4": ("bitwave", dict(warmup_steps=0), "sfp-m2e4", STEP3,
                         5),
    "bitwave-sfp8": ("bitwave", dict(warmup_steps=0), "sfp8", COSINE, 5),
    "qm+bitchop-sfp8": ("qm+bitchop", dict(warmup_steps=0, gamma=0.05,
                                            lr=0.05), "sfp8", COSINE, 2),
    "static-sfp8": ("static", STATIC, "sfp8", COSINE, 2),
}


def _cfgs():
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=4), n_kv_heads=2,
                                   dtype="float32")
    return (cut(jconfigs.get("gemma2-2b"), jreduced),
            cut(tconfigs.get("gemma2-2b"), treduced))


def _policies(name, kw, container):
    if name == "static":
        return (JStaticSTE(container=container, **kw),
                tpolicies.get("static", container=container, **kw))
    jp = jpolicies.get(name, container=container, **kw)
    if name == "qm+bitchop":   # the JAX composite keeps its own container
        jp = dataclasses.replace(jp, container=container)
    return jp, tpolicies.get(name, container=container, **kw)


def _setup(case, jpol=None):
    name, kw, container, sched, _ = CASES[case]
    jc, tc = _cfgs()
    jp, tp = _policies(name, kw, container)
    jp = jpol or jp
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**sched))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**sched))
    jm, tm = JModel(jc, jp), TModel(tc, tp, device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    if "qm" in js.pstate.learn:
        learn = {k: jnp.full_like(v, 3.0 if k.startswith("act") else 5.0)
                 for k, v in js.pstate.learn["qm"].items()}
        js = js._replace(pstate=js.pstate._replace(
            learn={**js.pstate.learn, "qm": learn}))
    if name in CTRL0:
        js = js._replace(pstate=js.pstate._replace(
            ctrl=js.pstate.ctrl._replace(**{
                k: jnp.asarray(v, jnp.int32)
                for k, v in CTRL0[name].items()})))
    js = js._replace(step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    return (jm, jtc, js), (tm, ttc, ts), corpus


def _ctrls(ctrl):
    """A policy's ctrl by sub-policy name (a composite's nests them)."""
    return ctrl if isinstance(ctrl, dict) else {"": ctrl}


def _assert_ctrl(t, j, where):
    tc, jc = _ctrls(t), _ctrls(j)
    assert set(tc) == set(jc), where
    for name in jc:
        if isinstance(jc[name], dict):
            assert jc[name] == {} and tc[name] == {}, where
            continue
        assert type(tc[name]).__name__ == type(jc[name]).__name__, where
        for f in jc[name]._fields:
            got, want = getattr(tc[name], f), np.asarray(getattr(jc[name], f))
            if f in ("mavg", "err_ema"):
                np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                           err_msg=f"{where} {f}")
            else:
                assert int(got) == int(want), (where, f)


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _run(case, monkeypatch):
    """Both sides' steps; per step the metrics and controller registers
    compared, and the bitlengths each period's stash pack got."""
    (jm, jtc, js), (tm, ttc, ts), corpus = _setup(case)
    steps = CASES[case][4]
    codec = tcodecs.get(CASES[case][2])
    pack = codec.pack
    seen = []

    def recording_pack(x, bits=None):
        seen.append(int(bits))
        return pack(x, bits=bits)
    monkeypatch.setattr(codec, "pack", recording_pack)
    jf = jax.jit(jstep.make_train_step(jm, jtc))
    tf = tstep.make_train_step(tm, ttc)
    trace = []
    cfg = tm.cfg
    for i in range(steps):
        b = corpus.batch(i)
        js_prev = js
        js, jmet = jf(js, {k: jnp.asarray(v) for k, v in b.items()})
        seen.clear()
        ts, tmet = tf(ts, {k: torch.from_numpy(v).long()
                           for k, v in b.items()})
        # Every metric of the port's step (JAX's adds MoE zeros).
        assert set(tmet) <= set(jmet), i
        for k, v in tmet.items():
            np.testing.assert_allclose(float(v), float(np.asarray(jmet[k])),
                                       rtol=RTOL, err_msg=f"step {i} {k}")
        _assert_ctrl(ts.pstate.ctrl, js.pstate.ctrl, f"step {i}")
        trace.append({"bits": list(seen), "ctrl_before": js_prev.pstate.ctrl})
        if i == 0:
            # The first step's gradients, read back from AdamW's first
            # moment (both sides start from one state).
            jm_ = convert.from_jax(jax.tree.map(np.asarray, js.opt.m), cfg)
            for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                           float_leaves(ts.opt.m)):
                assert _rel_to_max(m.numpy(), tm_.numpy()) <= RTOL, path
    return (jm, js), (tm, ts), trace


def _effective(pol, ctrl, dims):
    """(man, exp) the policy's stash decision takes from ``ctrl``."""
    v = pol.control_view(ctrl, dims)
    if pol.name == "bitwave":
        return int(v["act"]), int(v["act_e"])
    return int(v["act"]), None


@pytest.mark.parametrize("case", ["bitchop-sfp8", "bitwave-sfp-m2e4",
                                  "bitwave-sfp8"])
def test_controller_steps_match_jax(case, monkeypatch):
    (jm, js), (tm, ts), trace = _run(case, monkeypatch)
    effective = []
    for rec in trace:
        ctrl = convert._ctrl(jax.tree.map(np.asarray, rec["ctrl_before"]),
                             "cpu")
        man, exp = _effective(tm.policy, ctrl, tm.dims)
        effective.append((man, exp))
        # Every period's fused pack got the controller's mantissa bits.
        assert rec["bits"] == [man] * tm.cfg.n_periods
    mans = [m for m, _ in effective]
    assert min(mans) < 4, effective          # shrank from the injected 4
    if case.endswith("sfp8"):
        assert min(mans) < 3, effective      # below sfp8's 3 kept bits
    if case == "bitwave-sfp-m2e4":
        # The change at step 3 (the third step here) reopens full
        # precision for the rest of the run.
        assert int(ts.pstate.ctrl.hold_until) > int(ts.pstate.ctrl.step)
        assert effective[-1] == (23, 8) and effective[2] != (23, 8)
    if case == "bitwave-sfp8":
        assert min(e for _, e in effective) < 8
        assert int(ts.pstate.ctrl.turn) >= 2


def test_qm_bitchop_steps_match_jax(monkeypatch):
    (jm, js), (tm, ts), trace = _run("qm+bitchop-sfp8", monkeypatch)
    assert tm.policy.quantizes_weights
    for k, v in js.pstate.learn["qm"].items():
        np.testing.assert_allclose(ts.pstate.learn["qm"][k].detach().numpy(),
                                   np.asarray(v), atol=1e-6, err_msg=k)
    assert ts.pstate.learn["bitchop"] == {}
    # min(qm's draw 3, bitchop's n 23) reaches the stash.
    assert trace[0]["bits"] == [3] * tm.cfg.n_periods


def test_static_steps_match_jax_ste(monkeypatch):
    (jm, js), (tm, ts), trace = _run("static-sfp8", monkeypatch)
    assert trace[0]["bits"] == [3] * tm.cfg.n_periods


def test_static_departure_from_jax():
    """JAX's own ``static`` gives every layer matrix a zero gradient (its
    weight fake-quant is not differentiable); the port's straight-through
    fake-quant trains them, with the same forward."""
    _, kw, container, _, _ = CASES["static-sfp8"]
    jown = jpolicies.get("static", container=container, **kw)
    (jm, jtc, js), (tm, ttc, ts), corpus = _setup("static-sfp8", jpol=jown)
    b = corpus.batch(0)
    jnew, jmet = jax.jit(jstep.make_train_step(jm, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tmet = tstep.make_train_step(tm, ttc)(
        ts, {k: torch.from_numpy(v).long() for k, v in b.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=RTOL)
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tm.cfg)
    matrices = 0
    for (path, jmo), (_, tmo) in zip(float_leaves(jm_["layers"]),
                                     float_leaves(tnew.opt.m["layers"])):
        if jmo.dim() < 2:
            continue
        matrices += 1
        assert not jmo.any(), path                  # JAX: zero gradient
        assert tmo.abs().max() > 0, path            # the port: trained
    assert matrices == 7 * tm.cfg.n_layers    # q, k, v, o, gate, up, down
    assert float(tmet["grad_norm"]) > float(jmet["grad_norm"])


def test_convert_carries_controller_states():
    """``state_from_jax`` turns JAX's BitChop / BitWave NamedTuples (also
    nested in a composite's ctrl) into the port's, register for
    register."""
    dims = jpolicies.ScopeDims(n_periods=2, n_rem=0, man_bits=7, exp_bits=8)
    for name in ("bitchop", "bitwave", "qm+bitchop"):
        pol = jpolicies.get(name)
        st = pol.init_state(dims)
        st = st._replace(ctrl=pol.observe(st.ctrl, jnp.float32(3.0),
                                          jnp.asarray(True), dims))
        got = convert._ctrl(jax.tree.map(np.asarray, st.ctrl), "cpu")
        _assert_ctrl(got, st.ctrl, name)
        for c in _ctrls(got).values():
            if not isinstance(c, dict):
                assert isinstance(c, (tbc.BitChopState, tbc.BitWaveState))
