"""Per-layer stash containers (``--per-layer-stash``) of the port against
the JAX package, on the CPU.

- ``DecoderModel.stash_plan`` of a QM+QE state with per-period bits
  spread over the periods (converted by ``repro_torch.convert``) equals
  JAX's: the same dense and fixed-lane names.
- One training step of a model built with that plan (``stash_containers``)
  against JAX's (its twin: ``tests/test_dense_codecs.py``'s
  ``test_per_layer_stash_plan_and_forward``): f32, the reduced gemma2-2b
  of ``tests/test_torch_train.py`` at 8 layers (4 periods), integer
  learned bits so every draw is deterministic. Loss, xent and grad norm
  to rtol 1e-5; the gradients, read back from AdamW's first moment, to
  1e-5 of each tensor's largest; each period's stash packed in its own
  container, period 0's bytes equal to JAX's pack of the same input.
- The wrong-count error.
(The launchers' per-layer loops: ``tests/test_torch_per_layer_launch.py``.)
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
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.train import step as tstep

torch.set_num_threads(2)

B, S, LR, CONTAINER = 4, 64, 3e-3, "sfp-m2e4"
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
# Learned act bits per period (qm, qe): payload-8 words (m3e4, m2e5) and
# dense planes (m7e7, m1e3).
QM_ACT, QE_ACT = [3.0, 2.0, 7.0, 1.0], [4.0, 5.0, 8.0, 3.0]
PLAN = ("sfp-m3e4", "sfp-m2e5", "sfp-m7e7", "sfp-m1e3")


def _setup():
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=8), n_kv_heads=2,
                                   dtype="float32")
    jc = cut(jconfigs.get("gemma2-2b"), jreduced)
    tc = cut(tconfigs.get("gemma2-2b"), treduced)
    kw = dict(gamma=0.05, lr=0.05, container=CONTAINER)
    jp = jpolicies.CompositePolicy(policies=(
        jpolicies.get("qm", **kw), jpolicies.get("qe", **kw)),
        container=CONTAINER)
    tp = tpolicies.get("qm+qe", **kw)
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED))
    jm = JModel(jc, jp)
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    learn = dict(js.pstate.learn)
    learn["qm"] = {**learn["qm"], "act": jnp.asarray(QM_ACT, jnp.float32),
                   "w": jnp.full((4,), 5.0, jnp.float32)}
    learn["qe"] = {**learn["qe"], "act": jnp.asarray(QE_ACT, jnp.float32),
                   "w": jnp.full((4,), 6.0, jnp.float32)}
    js = js._replace(pstate=js.pstate._replace(learn=learn),
                     step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    return (jc, jm, jtc, js), (tc, TModel(tc, tp, device="cpu"), ttc, ts)


def test_stash_plan_matches_jax():
    (jc, jm, _, js), (tc, tm, _, ts) = _setup()
    assert jm.stash_plan(js.pstate) == PLAN
    assert tm.stash_plan(ts.pstate) == PLAN
    # A fresh state: full width everywhere (7 mantissa bits, the delta
    # field clamped to 7), as JAX's.
    assert tm.stash_plan() == jm.stash_plan() == ("sfp-m8e7",) * 4
    geoms = [tcodecs.fields_for(n, torch.float32) for n in PLAN]
    assert [f.dense for f in geoms] == [False, False, True, True]


def test_per_layer_step_matches_jax(monkeypatch):
    (jc, jm, jtc, js), (tc, tm, ttc, ts) = _setup()
    jmp = JModel(jc, jm.policy, stash_containers=PLAN)
    tmp = TModel(tc, tm.policy, device="cpu", stash_containers=PLAN)
    packs = []
    for name in PLAN:
        codec = tcodecs.get(name)

        def recording_pack(x, bits=None, codec=codec, pack=codec.pack):
            p = pack(x, bits=bits)
            packs.append((codec.name, int(bits), p))
            return p
        monkeypatch.setattr(codec, "pack", recording_pack)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    b = corpus.batch(0)
    jnew, jmet = jax.jit(jstep.make_train_step(jmp, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tmet = tstep.make_train_step(tmp, ttc)(
        ts, {k: torch.from_numpy(v).long() for k, v in b.items()})
    for k, v in tmet.items():
        np.testing.assert_allclose(float(v), float(np.asarray(jmet[k])),
                                   rtol=1e-5, err_msg=k)
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tc)
    for (path, a), (_, t) in zip(float_leaves(jm_), float_leaves(tnew.opt.m)):
        a, t = a.numpy(), t.numpy()
        assert np.abs(a - t).max() <= 1e-5 * max(np.abs(a).max(), 1e-30), \
            path
    for s in ("qm", "qe"):
        for k, v in jnew.pstate.learn[s].items():
            np.testing.assert_allclose(
                tnew.pstate.learn[s][k].detach().numpy(), np.asarray(v),
                atol=1e-6, err_msg=(s, k))
    # One pack a period, in its own container, at the period's mantissa
    # bits (min of qm's 3, 2, 7, 1 and qe's full 23).
    assert [(n, bits) for n, bits, _ in packs] == list(
        zip(PLAN, [3, 2, 7, 1]))
    for (name, _, p) in packs:
        f = tcodecs.fields_for(name, torch.float32)
        assert p.data["payload"].shape == (B, S, (tc.d_model // 128)
                                           * f.group_payload_bytes)
    # Period 0: the embedding's exponents truncated at e 4, packed in
    # sfp-m3e4 words at n 3, byte for byte JAX's.
    h0 = jcommon.embed(js.params["embed"], jnp.asarray(b["tokens"]),
                       jc.d_model ** 0.5)
    want = jcodecs.get(PLAN[0]).pack(jcontainers.truncate_exponent(h0, 4),
                                     bits=3)
    for k, v in want.data.items():
        np.testing.assert_array_equal(packs[0][2].data[k].numpy(),
                                      np.asarray(v), err_msg=k)


def test_stash_containers_wrong_count():
    _, (tc, tm, _, _) = _setup()
    with pytest.raises(ValueError, match="one codec per period"):
        TModel(tc, tm.policy, device="cpu", stash_containers=("sfp8",))
