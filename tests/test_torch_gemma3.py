"""The port's gemma3-12b against the JAX package, on the CPU, at a reduced
size: one 5:1 local:global period (6 layers), d_model 128, 16 q / 8 KV
heads of head dim 48, QK norm, no softcaps, vocab 512, window 32 under the
sequence. Head dim 48 = 16 (mod 32), as gemma3-12b's 240: every odd KV
head starts 16 lanes into a 32-lane chunk of the cache's flattened
8 x 48 = 384-lane axis (three 128-lane groups), which the decode's chunk
plan (``ref.head_chunks``) has to handle.

JAX initialises the parameters (its norms start at zero, so the q/k norm
scales are set to seeded values here, or QK norm would be the bare
normalisation); ``convert.from_jax`` hands them to the port, which has to
carry ``q_norm`` / ``k_norm``. The JAX side runs its default ``ref``
backend (it trains through its dense attention oracle).

Tolerances, as the other parity tests of the port: f32 forward logits to
2e-4 (summation order over 6 layers and a 128-wide unembedding); serving
in f32, prefill and teacher-forced step logits to 2e-3 and the greedy
tokens equal (``tests/test_torch_dense.py``); one train step: loss, xent
and grad norm to rtol 1e-5, the learned bitlengths after their SGD step
to 1e-4 (integer bits, draws 0) or 1e-6 (ceil-injected draws), the
gradients, read from AdamW's first moment, to 1e-5 of each tensor's
largest (ROADMAP §C); checkpoints bit for bit.
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
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import containers as tcontainers
from repro_torch.core.stash import float_leaves
from repro_torch.kernels import ref as tref
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.models.model import RunState
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.serve import engine
from repro_torch.train import step as tstep

torch.set_num_threads(2)

B, S, NEW, LR = 2, 64, 6, 1e-3
PROMPT = 40          # past the window: prefill masks it, the rings wrap
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)
HEADS = dict(n_heads=16, n_kv_heads=8, head_dim=48)


def _cfgs():
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=6, d_model=128,
                                           seq=S), dtype="float32", **HEADS)
    return (cut(jconfigs.get("gemma3-12b"), jreduced),
            cut(tconfigs.get("gemma3-12b"), treduced))


def _seeded_norms(params, seed=3):
    """Every norm scale (stacked by period in JAX's tree) set to seeded
    values in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k if k.endswith("norm") else name)
                    for k, v in tree.items()}
        a = np.asarray(tree)
        if name.endswith("norm"):
            return (rng.random(a.shape, np.float32) - 0.5).astype(a.dtype)
        return a
    return walk(params)


def test_config_matches_jax():
    j, t = jconfigs.get("gemma3-12b"), tconfigs.get("gemma3-12b")
    assert dataclasses.asdict(j) == {
        k: v for k, v in dataclasses.asdict(t).items()}
    assert t.head_dim_ == 240 and t.head_dim_ % 32 == 16
    assert t.qk_norm and t.attn_softcap is None and t.final_softcap is None
    assert t.n_periods == 8 and not t.remainder and t.window == 1024
    jc, tc = _cfgs()
    assert tc.layer_kinds() == jc.period * jc.n_periods == ("local",) * 5 + (
        "global",)
    assert tc.window < PROMPT < S
    # One period of the reduced model: the parameter count JAX's scope
    # lambdas take (q_norm and k_norm included).
    assert TModel(tc, device="cpu").layer_param_count() * 6 == sum(
        int(np.prod(s.shape[1:])) for s in jax.tree.leaves(
            JModel(jc).param_shapes()["periods"]))


def test_head_offsets_straddle_chunks():
    """The reduced KV heads start at lanes 0, 48, 96, ...: odd heads 16
    lanes into a chunk, head 2 inside group 0 and head 3 across groups 0
    and 1, as gemma3-12b's heads of 240 over 15 groups."""
    offsets = [(h * 48) % 32 for h in range(8)]
    assert offsets == [0, 16] * 4
    groups = {h: {(h * 48 + f) // 128 for f in range(48)} for h in range(8)}
    assert groups[2] == {0, 1} and groups[5] == {1, 2}
    for h in range(8):
        chunks = tref.head_chunks(h, 48)
        assert len(chunks) == 2
        assert [(c.lo, c.hi) for c in chunks] == (
            [(0, 32), (32, 48)] if h % 2 == 0 else [(0, 16), (16, 48)])


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs()
    jm = JModel(jc)
    return _seeded_norms(jm.init(jax.random.PRNGKey(0))), jc, tc


def test_from_jax_carries_the_qk_norms(params):
    jp, jc, tc = params
    tp = convert.from_jax(jp, tc)
    for i, layer in enumerate(tp["layers"]):
        p, s = divmod(i, 6)
        for k in ("q_norm", "k_norm"):
            want = jp["periods"][f"slot{s}"]["attn"][k]["scale"][p]
            np.testing.assert_array_equal(layer["attn"][k]["scale"].numpy(),
                                          want)
            assert layer["attn"][k]["scale"].shape == (48,)
    fresh = TModel(tc, device="cpu").init(0)
    assert fresh["layers"][0]["attn"].keys() == tp["layers"][0]["attn"].keys()


def test_forward_logits_match_jax(params):
    jp, jc, tc = params
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (B, S))
    jm = JModel(jc)
    jl, _ = jax.jit(lambda p, t: jm.forward(p, t, jm.run_state(
        jax.random.PRNGKey(1))))(jp, jnp.asarray(tokens, jnp.int32))
    tm = TModel(tc, device="cpu")
    tl, _ = tm.forward(convert.from_jax(jp, tc), torch.from_numpy(tokens),
                       RunState(gen=None, pol=None))
    np.testing.assert_allclose(tl.detach().numpy()[..., :jc.vocab],
                               np.asarray(jl)[..., :jc.vocab], atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
def test_serving_matches_jax(params, container):
    """JAX prefill + stepwise greedy decode over a packed cache against the
    port's prefill, teacher-forced steps and ``engine.generate``: the
    40-token prompt wraps the 32-slot local rings."""
    jp, jc, tc = params
    max_len = PROMPT + NEW
    jm = JModel(jc, kv_container=container)
    prompt = np.random.default_rng(2).integers(
        0, jc.vocab, (B, PROMPT)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(
        jp, jnp.asarray(prompt))
    step = jax.jit(jm.decode_step)
    lg, toks, steps = logits, [], []
    for i in range(NEW):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i == NEW - 1:
            break
        lg, cache = step(jp, cache, tok, jnp.asarray(PROMPT + i, jnp.int32))
        steps.append(np.asarray(lg)[:, -1])
    tokens = np.concatenate(toks, 1)

    tm = TModel(tc, kv_container=container, device="cpu")
    tp = convert.from_jax(jp, tc)
    tprompt = torch.from_numpy(prompt).long()
    tl, tcache = tm.prefill(tp, tprompt, max_len)
    local = tcache["layers"][0].k.data["bases"]
    assert local.shape[1] == jc.window < PROMPT        # a wrapped ring
    np.testing.assert_allclose(tl[:, -1].numpy(), np.asarray(logits)[:, -1],
                               atol=2e-3, rtol=0)
    for i, want in enumerate(steps):
        tok = torch.from_numpy(tokens[:, i:i + 1]).long()
        tl, tcache = tm.decode_step(tp, tcache, tok, PROMPT + i)
        np.testing.assert_allclose(tl[:, -1].numpy(), want, atol=2e-3,
                                   rtol=0, err_msg=f"step {i}")
    res = engine.generate(tm, tp, tprompt, NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), tokens)


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


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("case", ["qm-sfp8", "qm+qe-sfp-m2e4"])
def test_train_step_matches_jax(params, case, monkeypatch):
    """One step from the same state and batch: qm over an sfp8 stash from
    integer bits (every draw 0), and qm+qe over sfp-m2e4 planes from
    fractional bits with the draws injected as their ceiling on both
    sides (QE's exponent truncation and both estimators act)."""
    jparams, jc, tc = params
    jpol, tpol, bits = _policies(case)
    composite = case.startswith("qm+qe")
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
    b = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)).batch(0)
    jnew, jmet = jax.jit(jstep.make_train_step(jm, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tmet = tstep.make_train_step(tm, ttc)(
        ts, {k: torch.from_numpy(v).long() for k, v in b.items()})
    for k in ("loss", "xent", "grad_norm", "policy_penalty"):
        np.testing.assert_allclose(float(tmet[k]), float(np.asarray(jmet[k])),
                                   rtol=1e-5, err_msg=k)
    jlearn = jax.tree.map(np.asarray, jnew.pstate.learn)
    subs = ("qm", "qe") if composite else (None,)
    for s in subs:
        jl = jlearn[s] if s else jlearn
        tl = tnew.pstate.learn[s] if s else tnew.pstate.learn
        for k, v in jl.items():
            np.testing.assert_allclose(tl[k].detach().numpy(), v,
                                       atol=1e-6 if composite else 1e-4,
                                       err_msg=(s, k))
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tc)
    names = set()
    for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                   float_leaves(tnew.opt.m)):
        names.add(path)
        assert _rel_to_max(m.numpy(), tm_.numpy()) <= 1e-5, path
    assert any("q_norm" in str(p) for p in names)
    # The QK norms learn: their gradients are not zero.
    qn = tnew.opt.m["layers"][0]["attn"]["q_norm"]["scale"]
    assert float(qn.abs().max()) > 0


def test_checkpoint_crosses_packages(params, tmp_path):
    """JAX's parameter tree (q_norm and k_norm in every period's attention)
    saved by one package's CheckpointManager and restored by the other's,
    bit for bit, both ways; the port's restore converts to its layers."""
    jp, jc, tc = params
    jt = jax.tree.map(jnp.asarray, jp)
    tt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    JManager(str(tmp_path / "jax")).save(1, jt)
    CheckpointManager(str(tmp_path / "port")).save(1, tt)
    zeros_t = jax.tree.map(torch.zeros_like, tt)
    t_of_j = CheckpointManager(str(tmp_path / "jax")).restore(1, zeros_t)
    j_of_t = JManager(str(tmp_path / "port")).restore(
        1, jax.tree.map(jnp.zeros_like, jt))
    for a, b, c in zip(jax.tree.leaves(jt), jax.tree.leaves(t_of_j),
                       jax.tree.leaves(j_of_t)):
        assert np.asarray(a).tobytes() == b.detach().numpy().tobytes()
        assert np.asarray(a).tobytes() == np.asarray(c).tobytes()
    layers = convert.from_jax(jax.tree.map(lambda t: t.numpy(), t_of_j),
                              tc)["layers"]
    np.testing.assert_array_equal(
        layers[1]["attn"]["k_norm"]["scale"].numpy(),
        jp["periods"]["slot1"]["attn"]["k_norm"]["scale"][0])
