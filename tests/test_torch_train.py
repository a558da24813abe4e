"""The port's training slice against the JAX package, on the CPU.

Model: the JAX ``reduced(gemma2-2b, n_layers=4)`` (2 local/global
periods, d_model 128, window 32 < the 64-token sequence) with 2 KV heads
for 4 query heads (GQA), B 4 / S 64. JAX initialises the state; the
learned bitlengths are set to integers (act 3, w 5), so every Bernoulli
draw is 0 on both sides and the draws agree without sharing a generator.
The JAX side runs its default ``ref`` backend (its Pallas flash kernel
cannot be differentiated); ``repro_torch.convert`` hands the state over.

Tolerances. f32: loss, xent and grad norm agree to rtol 1e-5 (summation
order only), the learned bitlengths after their SGD step to 1e-4, and the
gradients, read back from AdamW's first moment (m = 0.1 * clipped g), to
1e-5 of each tensor's largest. Adam's first step is g / (|g| + 1e-8), so a
gradient that two summation orders cannot agree on (|g| below ~1e-6,
measured: the mismatches all sit at |g| < 1e-7) may move its parameter
anywhere within 2 lr: parameters are held to rtol 1e-4 / atol 1e-6 where
|g| > 1e-6, and to 2 lr + 1e-6 everywhere. bf16: the two frameworks'
matmuls round outputs to bf16 at different places (2^-8 relative each);
measured on the CPU loss and grad-norm gaps of ~6e-5 relative, held to
1e-3. The bf16 gradients themselves pass through a dozen such roundings
per layer: measured gaps of 1e-2 (median) to 2.7e-2 of each tensor's
largest, held to 5e-2.
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
from repro_torch.core.stash import float_leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.train import step as tstep

torch.set_num_threads(2)

B, S, LR = 4, 64, 3e-3
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
CASES = ["float32-sfp8", "float32-bit_exact", "bfloat16-sfp8",
         "bfloat16-bit_exact", "float32-none"]


def _cfgs(dtype):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=4), n_kv_heads=2,
                                   dtype=dtype)
    return (cut(jconfigs.get("gemma2-2b"), jreduced),
            cut(tconfigs.get("gemma2-2b"), treduced))


def _setup(case, qm_lr=0.05):
    """JAX model + state (learned bits act 3 / w 5, at step 1 so the
    warm-up LR is not 0) and the port's model + converted state."""
    dtype, container = case.split("-")
    jc, tc = _cfgs(dtype)
    if container == "none":
        jp, tp = jpolicies.get("none"), tpolicies.get("none")
    else:
        kw = dict(gamma=0.05, lr=qm_lr, init_bits=3.0, container=container)
        jp, tp = jpolicies.get("qm", **kw), tpolicies.get("qm", **kw)
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED))
    jm, tm = JModel(jc, jp), TModel(tc, tp, device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    learn = {k: jnp.full_like(v, 3.0 if k.startswith("act") else 5.0)
             for k, v in js.pstate.learn.items()}
    js = js._replace(pstate=js.pstate._replace(learn=learn),
                     step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    return (jm, jtc, js), (tm, ttc, ts), corpus


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.fixture(scope="module")
def one_step():
    """Each case's JAX step once, with what the tests compare."""
    out = {}
    for case in CASES:
        (jm, jtc, js), port, corpus = _setup(case)
        b = corpus.batch(0)
        new, met = jax.jit(jstep.make_train_step(jm, jtc))(js, _jbatch(b))
        res = {"metrics": {k: float(np.asarray(v)) for k, v in met.items()},
               "state": jax.tree.map(np.asarray, new), "batch": b,
               "port": port}
        if case.endswith("sfp8"):
            h0 = jcommon.embed(js.params["embed"], jnp.asarray(b["tokens"]),
                               jm.cfg.d_model ** 0.5)
            res["stash0"] = np.asarray(
                jcodecs.get("sfp8").pack(h0, bits=3).data["payload"])
        out[case] = res
    return out


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("case", CASES)
def test_one_step_matches_jax(one_step, case, monkeypatch):
    run = one_step[case]
    tm, ttc, ts = run["port"]
    f32 = case.startswith("float32")
    packed = []
    if case.endswith("sfp8"):
        codec = tcodecs.get("sfp8")
        pack = codec.pack

        def recording_pack(x, bits=None):
            p = pack(x, bits=bits)
            packed.append(p)
            return p
        monkeypatch.setattr(codec, "pack", recording_pack)
    new, met = tstep.make_train_step(tm, ttc)(ts, _tbatch(run["batch"]))
    want = run["metrics"]
    rtol = 1e-5 if f32 else 1e-3
    for k in ("loss", "xent", "grad_norm", "policy_penalty", "lr"):
        np.testing.assert_allclose(float(met[k]), want[k], rtol=rtol,
                                   err_msg=k)
    jst = run["state"]
    for k, v in jst.pstate.learn.items():
        np.testing.assert_allclose(new.pstate.learn[k].detach().numpy(), v,
                                   atol=1e-4, err_msg=k)
    cfg = tm.cfg
    jm_ = convert.from_jax(jst.opt.m, cfg)
    jp_ = convert.from_jax(jst.params, cfg)
    for (path, m), (_, tm_), (_, p), (_, tp) in zip(
            float_leaves(jm_), float_leaves(new.opt.m), float_leaves(jp_),
            float_leaves(new.params)):
        assert _rel_to_max(m.numpy(), tm_.numpy()) <= (1e-5 if f32 else
                                                       5e-2), path
        if not f32:
            continue
        p, tp = p.numpy(), tp.detach().numpy()
        d = np.abs(p - tp)
        sure = np.abs(m.numpy()) > 1e-7
        assert (d[sure] <= 1e-6 + 1e-4 * np.abs(p[sure])).all(), path
        assert d.max() <= 2 * LR + 1e-6, path
    if packed:
        # The period-0 stash: the embedding packed at 3 mantissa bits.
        np.testing.assert_array_equal(
            packed[0].data["payload"].numpy(), run["stash0"])
        assert len(packed) == cfg.n_periods


def _set_learn(js, act, w):
    learn = {k: jnp.full_like(v, act if k.startswith("act") else w)
             for k, v in js.pstate.learn.items()}
    return js._replace(pstate=js.pstate._replace(learn=learn))


def test_one_step_fractional_bits_matches_jax(monkeypatch):
    """Learned bits act 2.5 / w 4.5 with the Bernoulli draw injected as 1
    on both sides (n = 3 and 5): the stash keeps 3 mantissa bits where the
    estimator re-truncates at 2, and the weight estimator compares 5 with
    4, so both estimators give nonzero bitlength gradients. f32, sfp8:
    loss and grad norm to rtol 1e-5, as the integer-bits case; the learned
    bits after their SGD step to 1e-6 (measured: equal)."""
    from repro.core import containers as jcontainers
    from repro_torch.core import containers as tcontainers

    def j_draw(n_float, key, max_bits, min_bits=0):
        nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                      float(max_bits))
        return jnp.ceil(nf).astype(jnp.int32)

    def t_draw(n_float, generator, max_bits, shape=None):
        nf = torch.clamp(n_float.detach().float(), 0.0, float(max_bits))
        n = torch.ceil(nf).to(torch.int32)
        return n if shape is None else n.expand(tuple(shape)).clone()

    monkeypatch.setattr(jcontainers, "stochastic_bitlength", j_draw)
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", t_draw)
    (jm, jtc, js), (tm, ttc, _), corpus = _setup("float32-sfp8")
    js = _set_learn(js, 2.5, 4.5)
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tm.cfg)
    b = corpus.batch(0)
    jnew, jmet = jax.jit(jstep.make_train_step(jm, jtc))(js, _jbatch(b))
    tnew, tmet = tstep.make_train_step(tm, ttc)(ts, _tbatch(b))
    for k in ("loss", "grad_norm", "policy_penalty"):
        np.testing.assert_allclose(float(tmet[k]), float(np.asarray(jmet[k])),
                                   rtol=1e-5, err_msg=k)
    for k, v in jnew.pstate.learn.items():
        np.testing.assert_allclose(tnew.pstate.learn[k].detach().numpy(),
                                   np.asarray(v), atol=1e-6, err_msg=k)
    # The penalty moves both periods alike: only the estimators part them
    # (measured: act 1.3e-2 apart, w 1.8e-4), by far more than 1e-6.
    for k in ("act", "w"):
        assert np.ptp(tnew.pstate.learn[k].detach().numpy()) > 1e-4, k


def test_three_steps_with_frozen_bits_match_jax():
    """--qm-lr 0 keeps the bits integer, so three steps stay comparable."""
    (jm, jtc, js), (tm, ttc, ts), corpus = _setup("float32-sfp8", qm_lr=0.0)
    jf = jax.jit(jstep.make_train_step(jm, jtc))
    tf = tstep.make_train_step(tm, ttc)
    for i in range(3):
        b = corpus.batch(i)
        js, jmet = jf(js, _jbatch(b))
        ts, tmet = tf(ts, _tbatch(b))
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]),
                                       float(np.asarray(jmet[k])),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert ts.step == 4 and ts.opt.count == 3


def test_adamw_update_matches_jax():
    """Two updates from identical f32 gradients (one clipped, one not):
    parameters and moments to rtol 1e-6."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal(16).astype(np.float32),
              "h": rng.standard_normal((4, 8)).astype(np.float32)}
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadamw.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tadamw.init(tp)
    for scale in (3.0, 0.01):
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        jp, js, jn = jadamw.update({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp, jadamw.AdamWConfig(**cfg),
                                   jnp.float32(2e-3))
        tp, ts, tn = tadamw.update(
            [torch.from_numpy(g[k]) for k in tp], ts, tp,
            tadamw.AdamWConfig(**cfg), float(np.float32(2e-3)))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                              (ts.v[k], js.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9, err_msg=k)
    assert ts.count == int(js.count) == 2


@pytest.mark.parametrize("kind", ["cosine", "step", "constant"])
def test_schedule_matches_jax(kind):
    kw = dict(kind=kind, base_lr=3e-3, warmup_steps=5, total_steps=40,
              boundaries=(10, 30))
    js, ts = JSchedule(**kw), TSchedule(**kw)
    for step in range(45):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))),
                                   rtol=1e-6)
        assert ts.lr_changed(step) == bool(js.lr_changed(jnp.int32(step)))


def test_synthetic_batches_equal():
    kw = dict(vocab=256000, seq_len=33, global_batch=3, seed=7)
    jc = jsyn.MarkovCorpus(jsyn.SyntheticConfig(**kw))
    tc = tsyn.MarkovCorpus(tsyn.SyntheticConfig(**kw))
    for step in (0, 5):
        jb, tb = jc.batch(step), tc.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("n_layers", [4, 26])
def test_scope_lambdas_match_jax(n_layers):
    jc = jreduced(jconfigs.get("gemma2-2b"), n_layers=n_layers)
    tc = treduced(tconfigs.get("gemma2-2b"), n_layers=n_layers)
    want = jstep._scope_lambdas(JModel(jc, "qm"), (4, 64))
    got = tstep._scope_lambdas(TModel(tc, "qm", device="cpu"), (4, 64))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_convert_train_state_keeps_bits():
    jc, tc = _cfgs("bfloat16")
    jm = JModel(jc, "qm")
    jtc = jstep.TrainConfig()
    js = jstep.init_state(jm, jax.random.PRNGKey(3), jtc)
    js = js._replace(opt=js.opt._replace(
        m=jax.tree.map(lambda a: a + 0.25, js.opt.m),
        count=jnp.asarray(7, jnp.int32)))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    want = convert.from_jax(jax.tree.map(np.asarray, js.params), tc)
    for (_, a), (_, b) in zip(float_leaves(want), float_leaves(ts.params)):
        assert b.dtype == torch.bfloat16 and b.requires_grad
        assert torch.equal(a.view(torch.int16), b.detach().view(torch.int16))
    jm_ = jax.tree.map(np.asarray, js.opt.m)
    got_m = float_leaves(ts.opt.m)
    assert all(float(t.min()) == 0.25 for _, t in got_m)
    assert sum(t.numel() for _, t in got_m) == sum(
        a.size for a in jax.tree.leaves(jm_))
    assert ts.opt.count == 7 and ts.step == 0
    for k, v in js.pstate.learn.items():
        np.testing.assert_array_equal(ts.pstate.learn[k].detach().numpy(),
                                      np.asarray(v))
        assert ts.pstate.learn[k].requires_grad


def test_estimator_probe_on_cpu():
    """On the CPU every route is the plain one, so all four agree exactly;
    each period's estimate is bounded by the magnitudes it sums."""
    from repro_torch.launch import probe_estimator
    recs = probe_estimator.main([
        "--arch", "gemma2-2b", "--preset", "tiny", "--container", "sfp8",
        "--qm-init-bits", "2.5", "--layers", "8", "--device", "cpu"])
    assert [r["route"] for r in recs] == list(probe_estimator.ROUTES)
    for r in recs[1:]:
        assert r["dn"] == recs[0]["dn"] and r["loss"] == recs[0]["loss"]
    dn, mag = np.array(recs[0]["dn"]), np.array(recs[0]["abs_sum"])
    assert len(dn) == 4 and (np.abs(dn) <= mag).all() and (dn != 0).any()


def test_cpu_launcher_runs_and_reports(capsys):
    res = tlaunch.main(["--arch", "gemma2-2b", "--preset", "tiny",
                        "--policy", "qm", "--container", "sfp8",
                        "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"qm_act_mean"' in out and "footprint {" in out
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert res["footprint"]["exp_bits"] == 8.0
