"""One training step of the port's MoE decoders against the JAX package's,
on the CPU, at the cuts of ``tests/test_torch_moe_lm.py`` (olmoe: 4 q /
4 KV heads of 32; phi3.5-moe: 8 / 2 of 64, an untied head; d_model 128,
2 layers, 4 experts of 256, top-2, f32), from the same state
(``convert.state_from_jax``) and batch: qm over an sfp8 stash and qm+qe
over sfp-m2e4 planes. The loss adds the MoE auxiliary loss, which rides
the stash scan's ``extras`` carry; the weight fake-quant covers the f32
router and the 3-D expert tensors. Also: ``convert`` and the checkpoint
managers carry the ``moe`` subtree with its f32 router, either way.

Tolerances (ROADMAP §C): loss, xent, grad norm and the MoE metrics to
rtol 1e-5, the learned bitlengths after their SGD step to 1e-4 (integer
bits, draws 0) or 1e-6 (ceil-injected draws), the gradients, read from
AdamW's first moment, to 1e-5 of each tensor's largest. As in
``tests/test_torch_prefix_lm_train.py``, JAX's stash inputs are
recorded, the port's held to them (1e-5 of the largest) and its packed
values up to isolated truncation flips, and then JAX's inputs are
stashed on both sides; both patches are on the registry codec instances.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro import configs as jconfigs
from repro import policies as jpolicies
from repro.checkpoint.manager import CheckpointManager as JManager
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
from repro_torch.checkpoint.manager import CheckpointManager
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
ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
HEADS = {"olmoe-1b-7b": {},
         "phi3.5-moe-42b-a6.6b": dict(n_heads=8, n_kv_heads=2, head_dim=64)}


def _cfgs(arch, dtype="float32"):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype=dtype, **HEADS[arch])
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


@pytest.mark.parametrize("case", ["qm-sfp8", "qm+qe-sfp-m2e4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, case, monkeypatch):
    """One step from the same state and batch: qm over an sfp8 stash from
    integer bits (every draw 0), qm+qe over sfp-m2e4 planes from
    fractional bits with the draws injected as their ceiling on both
    sides; both from JAX's stash inputs."""
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
    for k in ("loss", "xent", "grad_norm", "policy_penalty", "moe_lb_loss",
              "moe_drop_frac"):
        np.testing.assert_allclose(float(tmet[k]), float(np.asarray(jmet[k])),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(tmet["loss"]) > float(tmet["xent"])   # the aux loss
    assert float(tmet["moe_lb_loss"]) > 0
    jlearn = jax.tree.map(np.asarray, jnew.pstate.learn)
    for s in (("qm", "qe") if composite else (None,)):
        jl = jlearn[s] if s else jlearn
        tl = tnew.pstate.learn[s] if s else tnew.pstate.learn
        for k, v in jl.items():
            np.testing.assert_allclose(tl[k].detach().numpy(), v,
                                       atol=1e-6 if composite else 1e-4,
                                       err_msg=(s, k))
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tc)
    paths = []
    for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                   float_leaves(tnew.opt.m)):
        paths.append(path)
        assert _rel_to_max(m.numpy(), tm_.numpy()) <= 1e-5, path
    assert ("layers", 1, "moe", "router") in paths


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same_bits(a, t) -> bool:
    a, b = np.asarray(a), _np(t.detach())
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes())


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_and_state_keep_the_moe_subtree(arch):
    """A bf16 model's JAX params and TrainState (with compressed
    gradients' residual) convert leaf for leaf, bit for bit: the router
    f32, the experts bf16, AdamW's moments f32."""
    jc, tc = _cfgs(arch, "bfloat16")
    jm = JModel(jc, jpolicies.get("qm", container="sfp8"))
    jtc = jstep.TrainConfig(grad_compress_bits=5)
    js = jax.tree.map(np.asarray, jstep.init_state(
        jm, jax.random.PRNGKey(0), jtc))
    ts = convert.state_from_jax(js, tc)
    for p in range(jc.n_periods):
        jl = js.params["periods"]["slot0"]["moe"]
        tl = ts.params["layers"][p]["moe"]
        assert set(tl) == set(jl) == {"router", "w_in", "w_out", "w_gate"}
        for k in tl:
            assert _same_bits(jl[k][p], tl[k]), (p, k)
        assert tl["router"].dtype == torch.float32
        assert tl["w_in"].dtype == torch.bfloat16
        assert ts.opt.m["layers"][p]["moe"]["router"].dtype == torch.float32
        assert ts.grad_residual["layers"][p]["moe"]["w_out"].shape == \
            tl["w_out"].shape
    own = tstep.init_state(TModel(tc, "qm", device="cpu"), 0,
                           tstep.TrainConfig(grad_compress_bits=5))
    assert {p: (t.shape, t.dtype) for p, t in float_leaves(own.params)} == {
        p: (t.shape, t.dtype) for p, t in float_leaves(ts.params)}


def test_checkpoints_of_a_reduced_olmoe_restore_in_either_package(tmp_path):
    """JAX's manager saves its reduced bf16 olmoe params (stacked periods)
    and the port's restores them onto a like-tree of that layout, which
    ``convert.from_jax`` turns into the port's; the port's manager saves
    its own per-layer params and JAX's restores them onto a numpy
    like-tree of that layout. Every leaf bit for bit, the router f32."""
    jc, tc = _cfgs("olmoe-1b-7b", "bfloat16")
    jp = JModel(jc).init(jax.random.PRNGKey(0))
    JManager(str(tmp_path / "jax")).save(1, jp)
    like = jax.tree.map(lambda a: convert.to_tensor(np.zeros_like(
        np.asarray(a))), jp)
    got = CheckpointManager(str(tmp_path / "jax")).restore(1, like)
    want = convert.from_jax(jax.tree.map(np.asarray, jp), tc)
    back = convert.from_jax(jax.tree.map(_np, got,
                                         is_leaf=lambda x: isinstance(
                                             x, torch.Tensor)), tc)
    pairs = list(zip(float_leaves(want), float_leaves(back)))
    assert pairs
    for (path, a), (_, b) in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert back["layers"][0]["moe"]["router"].dtype == torch.float32

    tp = TModel(tc, device="cpu").init(3)
    CheckpointManager(str(tmp_path / "port")).save(1, tp)
    jlike = jax.tree.map(lambda t: np.zeros_like(_np(t)), tp,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    jgot = JManager(str(tmp_path / "port")).restore(1, jlike)
    flat_t = dict(float_leaves(tp))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jgot)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        assert _same_bits(leaf, flat_t[key]), key
        n += 1
    assert n == len(flat_t)
    assert np.asarray(jgot["layers"][1]["moe"]["router"]).dtype == np.float32
