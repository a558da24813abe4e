"""One training step of the port's mistral-large-123b against the JAX
package's, on the CPU, at the rep-12 cut of ``tests/test_torch_mistral.py``
(24 q / 2 KV heads of 64, d_model 128, 2 layers, an untied head), from
the same state (``convert.state_from_jax``) and batch: qm over an sfp8
stash and qm+qe over sfp-m2e4 planes.

Tolerances (ROADMAP §C): loss, xent and grad norm to rtol 1e-5, the
learned bitlengths after their SGD step to 1e-4 (integer bits, draws 0)
or 1e-6 (ceil-injected draws), the gradients, read from AdamW's first
moment, to 1e-5 of each tensor's largest, and the head after AdamW where
its gradient is not tiny. JAX's step runs op by op; see
``test_train_step_matches_jax``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import policies as jpolicies
from repro.core import containers as jcontainers
from repro.data import synthetic as jsyn
from repro.models.model import DecoderModel as JModel
from repro.optim import adamw as jadamw
from repro.optim.schedule import Schedule as JSchedule
from repro.train import step as jstep
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.core import containers as tcontainers
from repro_torch.core.stash import float_leaves
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.train import step as tstep

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced

torch.set_num_threads(2)

B, S, LR = 2, 64, 1e-3
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
HEADS = dict(n_heads=24, n_kv_heads=2, head_dim=64, d_model=128)


def _cfgs():
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype="float32", **HEADS)
    return (cut(jconfigs.get("mistral-large-123b"), jreduced),
            cut(tconfigs.get("mistral-large-123b"), treduced))


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs()
    return JModel(jc).init(jax.random.PRNGKey(0)), jc, tc


def _j_ceil(n_float, key, max_bits, min_bits=0):
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    return jnp.ceil(nf).astype(jnp.int32)


def _t_ceil(n_float, generator, max_bits, min_bits=0, shape=None):
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


def _policies(case):
    """(JAX policy, port policy, learned bits to start from) of a case."""
    if case == "qm-sfp8":
        kw = dict(gamma=0.05, lr=0.05, container="sfp8")
        return (jpolicies.get("qm", **kw), tpolicies.get("qm", **kw),
                {"act": 3.0, "w": 5.0})
    kw = dict(gamma=0.05, lr=0.05, container="sfp-m2e4")
    jp = jpolicies.CompositePolicy(policies=(
        jpolicies.get("qm", **kw), jpolicies.get("qe", **kw)),
        container="sfp-m2e4")
    tp = tpolicies.CompositePolicy(policies=(
        tpolicies.get("qm", **kw), tpolicies.get("qe", **kw)),
        container="sfp-m2e4")
    return jp, tp, {"qm": {"act": 1.5, "w": 4.5},
                    "qe": {"act": 3.5, "w": 4.5}}


def _set_learn(learn, bits):
    if "qm" in bits:
        return {s: _set_learn(learn[s], bits[s]) for s in learn}
    return {k: jnp.full_like(v, bits["act" if k.startswith("act") else "w"])
            for k, v in learn.items()}


@pytest.mark.parametrize("case", ["qm-sfp8", "qm+qe-sfp-m2e4"])
def test_train_step_matches_jax(params, case, monkeypatch):
    """One step from the same state and batch: qm over an sfp8 stash from
    integer bits (every draw 0), and qm+qe over sfp-m2e4 planes from
    fractional bits with the draws injected as their ceiling on both
    sides. No policy quantizes the head (it lies outside the periods):
    its AdamW moments are held like every other leaf's.

    JAX's step runs op by op (``jax.disable_jit``). Jitted, XLA's fusions
    reassociate f32 sums: on this batch the jitted qm step's first
    moments lie up to 6.4e-5 of their largest (layer 1, the head) from
    the same step run op by op, and the port's under 1e-6."""
    jparams, jc, tc = params
    jpol, tpol, bits = _policies(case)
    composite = case.startswith("qm+qe")
    b = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)).batch(0)
    if composite:
        monkeypatch.setattr(jcontainers, "stochastic_bitlength", _j_ceil)
        monkeypatch.setattr(tcontainers, "stochastic_bitlength", _t_ceil)
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED))
    jm, tm = JModel(jc, jpol), TModel(tc, tpol, device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    js = js._replace(params=jax.tree.map(jnp.asarray, jparams),
                     pstate=js.pstate._replace(
                         learn=_set_learn(js.pstate.learn, bits)),
                     step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    assert ts.opt.m["head"].shape == ts.params["head"].shape
    with jax.disable_jit():
        jnew, jmet = jstep.make_train_step(jm, jtc)(
            js, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tmet = tstep.make_train_step(tm, ttc)(
        ts, {k: torch.from_numpy(v).long() for k, v in b.items()})
    for k in ("loss", "xent", "grad_norm", "policy_penalty"):
        np.testing.assert_allclose(float(tmet[k]), float(np.asarray(jmet[k])),
                                   rtol=1e-5, err_msg=k)
    jlearn = jax.tree.map(np.asarray, jnew.pstate.learn)
    for s in (("qm", "qe") if composite else (None,)):
        jl = jlearn[s] if s else jlearn
        tl = tnew.pstate.learn[s] if s else tnew.pstate.learn
        for k, v in jl.items():
            np.testing.assert_allclose(tl[k].detach().numpy(), v,
                                       atol=1e-6 if composite else 1e-4,
                                       err_msg=(s, k))
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tc)
    names = []
    for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                   float_leaves(tnew.opt.m)):
        names.append(path)
        assert _rel_to_max(m.numpy(), tm_.numpy()) <= 1e-5, path
    assert names[-1] == ("head",)
    assert float(tnew.opt.m["head"].abs().max()) > 0
    # The head is updated, and only where its gradient is not tiny may
    # the two packages' AdamW steps be compared (ROADMAP §C).
    jhead = np.asarray(jnew.params["head"])
    g = np.abs(np.asarray(jnew.opt.m["head"]))
    mask = g > 1e-6
    assert mask.any()
    np.testing.assert_allclose(tnew.params["head"].detach().numpy()[mask],
                               jhead[mask], rtol=1e-5, atol=1e-7)


