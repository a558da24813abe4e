"""One training step of the port's prefix-LMs against the JAX package's,
on the CPU, at the cuts of ``tests/test_torch_prefix_lm.py`` (paligemma:
8 q / 1 KV head of 128; musicgen: 4 / 4 of 32, no GLU, an untied head;
d_model 128, 2 layers, P 8), from the same state
(``convert.state_from_jax``) and batch, with random conditioning
embeddings from numpy: qm over an sfp8 stash and qm+qe over sfp-m2e4
planes. The stash holds all P + S positions, and the footprint weights
count them.

Tolerances (ROADMAP §C): loss, xent and grad norm to rtol 1e-5, the
learned bitlengths after their SGD step to 1e-4 (integer bits, draws 0)
or 1e-6 (ceil-injected draws), the gradients, read from AdamW's first
moment, to 1e-5 of each tensor's largest.

The stash truncates mantissas (and, under qe, exponents), so a one-ulp
gap between the two packages' f32 activations can flip a stashed value by
a whole truncation step where it straddles a step: on this batch one of
18,432 values flips in paligemma's qm + sfp8 step (2^-5 less an ulp in
the port, 2^-5 in JAX: 0.02734 against 0.03125) and one in musicgen's
qm+qe step, and the flip then moves every gradient downstream of its
channel by up to 5.6e-4 of the largest. So the test records JAX's stash
inputs, holds the port's to them within f32 rounding (1e-5 of the
largest) and its packed values to JAX's up to isolated flips (under 1e-3
of the values, each one truncation step), and then stashes JAX's inputs
on the port's side too, so that the rest of the step is compared from
one stash (ROADMAP §C, "truncation flips").
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
from repro_torch.core.stash import float_leaves
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.train import step as tstep

torch.set_num_threads(2)

B, S, LR = 2, 64, 1e-3
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
HEADS = {"paligemma-3b": dict(n_heads=8, n_kv_heads=1, head_dim=128),
         "musicgen-large": {}}


def _cfgs(arch):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype="float32",
                                   **HEADS[arch])
    return (cut(jconfigs.get(arch), jreduced),
            cut(tconfigs.get(arch), treduced))


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


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


def _record_jax_stash(monkeypatch, name):
    """Patch JAX's codec ``name`` to record each stash input it packs (in
    the order the periods run). Returns the record."""
    cls = type(jcodecs.get(name))
    pack, record = cls.pack, []

    def recording(self, x, bits=None):
        jax.debug.callback(lambda a: record.append(np.array(a)), x,
                           ordered=True)
        return pack(self, x, bits)
    monkeypatch.setattr(cls, "pack", recording)
    return record


def _stash_jax_inputs(monkeypatch, name, record, flips):
    """Patch the port's codec ``name`` to hold each stash input to JAX's
    (within 1e-5 of the largest), count the packed values that differ
    (``flips``, each checked to be one truncation step) and pack JAX's
    input instead of its own."""
    cls = type(tcodecs.get(name))
    pack, inputs = cls.pack, iter(record)

    def substituted(self, x, bits=None):
        theirs = torch.from_numpy(next(inputs))
        assert _rel_to_max(theirs.numpy(), x.detach().numpy()) <= 1e-5
        a = self.unpack(pack(self, x, bits))
        b = self.unpack(pack(self, theirs, bits))
        differ = a != b
        # One truncation step: the kept mantissa's last bit, at most 2^-1
        # of the value (a 1-bit mantissa).
        step = (a - b).abs()[differ]
        assert bool((step <= 0.5 * b.abs()[differ] + 1e-30).all())
        flips.append((int(differ.sum()), differ.numel()))
        return pack(self, theirs, bits)
    monkeypatch.setattr(cls, "pack", substituted)


def _set_learn(learn, bits):
    if "qm" in bits:
        return {s: _set_learn(learn[s], bits[s]) for s in learn}
    return {k: jnp.full_like(v, bits["act" if k.startswith("act") else "w"])
            for k, v in learn.items()}


@pytest.mark.parametrize("case", ["qm-sfp8", "qm+qe-sfp-m2e4"])
@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_train_step_matches_jax(arch, case, monkeypatch):
    """One step from the same state and batch, conditioning embeddings
    included: qm over an sfp8 stash from integer bits (every draw 0), and
    qm+qe over sfp-m2e4 planes from fractional bits with the draws
    injected as their ceiling on both sides; both from JAX's stash
    inputs, held to the port's own first (see the module's note)."""
    jc, tc = _cfgs(arch)
    jparams = JModel(jc).init(jax.random.PRNGKey(0))
    jpol, tpol, bits = _policies(case)
    composite = case.startswith("qm+qe")
    b = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)).batch(0)
    b["cond_embeddings"] = np.random.default_rng(1).standard_normal(
        (B, jc.prefix_tokens, jc.d_model)).astype(np.float32)
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
    record = _record_jax_stash(monkeypatch, jpol.container)
    jnew, jmet = jax.jit(jstep.make_train_step(jm, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    jax.effects_barrier()
    assert len(record) == jc.n_periods
    assert record[0].shape == (B, jc.prefix_tokens + S, jc.d_model)
    flips = []
    _stash_jax_inputs(monkeypatch, tpol.container, record, flips)
    tb = {k: torch.from_numpy(v) if k == "cond_embeddings"
          else torch.from_numpy(v).long() for k, v in b.items()}
    tnew, tmet = tstep.make_train_step(tm, ttc)(ts, tb)
    assert len(flips) == jc.n_periods
    assert all(n <= 1e-3 * size for n, size in flips), flips
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
    for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                   float_leaves(tnew.opt.m)):
        assert _rel_to_max(m.numpy(), tm_.numpy()) <= 1e-5, path
