"""One training step of the port's recurrent families against the JAX
package's, on the CPU, at the widths of ``tests/test_torch_recurrent_lm.py``
(mamba2-370m: 2 SSD layers, two one-layer periods; recurrentgemma-9b:
one (rglru, rglru, local) period and a remainder of two RG-LRU layers;
d_model 128, f32), from the same state (``convert.state_from_jax``) and
batch: qm over an sfp8 stash and qm+qe over sfp-m2e4 planes. The
remainder layers take their own straight-through stash decision and
weight fake-quant (``act_rem`` / ``w_rem``), whose learned bits move as
JAX's. Also: the eq. 7 footprint weights (``_scope_lambdas``) equal JAX's
at the full-size configs and the cuts, each kind counted by its own
leaves.

Tolerances (ROADMAP §C): loss, xent, grad norm and penalty to rtol 1e-5,
the learned bitlengths after their SGD step to 1e-4 (integer bits, draws
0) or 1e-6 (ceil-injected draws), the gradients, read from AdamW's first
moment, to 1e-5 of each tensor's largest. JAX's stash inputs are
recorded, the port's held to them (1e-5 of the largest) and its packed
values up to isolated truncation flips, and then JAX's inputs are
stashed on both sides (instance patches of the registry codecs' ``pack``).
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
ARCHS = {"mamba2-370m": 2, "recurrentgemma-9b": 5}


def _cfgs(arch):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=ARCHS[arch]),
                                   dtype="float32")
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
    """Record each stash input JAX's registry codec ``name`` packs (an
    instance patch). Returns the record."""
    codec = jcodecs.get(name)
    pack, record = codec.pack, []

    def recording(x, bits=None):
        jax.debug.callback(lambda a: record.append(np.array(a)), x,
                           ordered=True)
        return pack(x, bits)
    monkeypatch.setattr(codec, "pack", recording)
    return record


def _stash_jax_inputs(monkeypatch, name, record, flips):
    """Hold each of the port's stash inputs to JAX's (1e-5 of the
    largest), count the packed values that differ (``flips``, each one
    truncation step) and pack JAX's input instead (an instance patch)."""
    codec = tcodecs.get(name)
    pack, inputs = codec.pack, iter(record)

    def substituted(x, bits=None):
        theirs = torch.from_numpy(next(inputs))
        assert _rel_to_max(theirs.numpy(), x.detach().numpy()) <= 1e-5
        a = codec.unpack(pack(x, bits))
        b = codec.unpack(pack(theirs, bits))
        differ = a != b
        step = (a - b).abs()[differ]
        assert bool((step <= 0.5 * b.abs()[differ] + 1e-30).all())
        flips.append((int(differ.sum()), differ.numel()))
        return pack(theirs, bits)
    monkeypatch.setattr(codec, "pack", substituted)


def _set_learn(learn, bits):
    if "qm" in bits:
        return {s: _set_learn(learn[s], bits[s]) for s in learn}
    return {k: jnp.full_like(v, bits["act" if k.startswith("act") else "w"])
            for k, v in learn.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_scope_lambdas_match_jax(arch):
    """Each scope's footprint weight, at full size and cut: a period's
    weights are the sum of its layers' leaves (an RG-LRU and a LOCAL
    layer differ), the remainder's their mean."""
    for full in (True, False):
        if full:
            jc, tc = jconfigs.get(arch), tconfigs.get(arch)
        else:
            jc, tc = _cfgs(arch)
        jl = jstep._scope_lambdas(JModel(jc, "qm"), (4, 2048))
        tl = tstep._scope_lambdas(TModel(tc, "qm", device="cpu"), (4, 2048))
        assert set(jl) == set(tl)
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-6, err_msg=k)
        assert tl["act_rem"].numel() == len(tc.remainder)


@pytest.mark.parametrize("case", ["qm-sfp8", "qm+qe-sfp-m2e4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, case, monkeypatch):
    """One step from the same state and batch: qm over an sfp8 stash from
    integer bits (every draw 0), qm+qe over sfp-m2e4 planes from
    fractional bits with the draws injected as their ceiling on both
    sides; both from JAX's stash inputs. The remainder's act bits
    truncate its input straight-through; its weight bits move the
    remainder's ``w_rem`` through the fake-quant."""
    jc, tc = _cfgs(arch)
    jparams = JModel(jc).init(jax.random.PRNGKey(0))
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
    record = _record_jax_stash(monkeypatch, jpol.container)
    jnew, jmet = jax.jit(jstep.make_train_step(jm, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    jax.effects_barrier()
    assert len(record) == jc.n_periods
    flips = []
    _stash_jax_inputs(monkeypatch, tpol.container, record, flips)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tnew, tmet = tstep.make_train_step(tm, ttc)(ts, tb)
    assert len(flips) == jc.n_periods
    assert all(n <= 1e-3 * size for n, size in flips), flips
    for k in ("loss", "xent", "grad_norm", "policy_penalty"):
        np.testing.assert_allclose(float(tmet[k]), float(np.asarray(jmet[k])),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    jlearn = jax.tree.map(np.asarray, jnew.pstate.learn)
    for s in (("qm", "qe") if composite else (None,)):
        jl = jlearn[s] if s else jlearn
        tl = tnew.pstate.learn[s] if s else tnew.pstate.learn
        for k, v in jl.items():
            np.testing.assert_allclose(tl[k].detach().numpy(), v,
                                       atol=1e-6 if composite else 1e-4,
                                       err_msg=(s, k))
        if tc.remainder:
            start = bits["qm"]["w"] if composite else bits["w"]
            if s != "qe":
                assert (tl["w_rem"].detach().numpy() != start).all()
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tc)
    paths = []
    for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                   float_leaves(tnew.opt.m)):
        paths.append(path)
        assert _rel_to_max(m.numpy(), tm_.numpy()) <= 1e-5, path
    last = len(tc.layer_kinds()) - 1
    block = "ssd" if arch == "mamba2-370m" else "rglru"
    assert ("layers", last, block, "w_x") in paths
