"""The port's gemma2-27b against the JAX package, on the CPU, at a reduced
size that keeps what sets it apart from gemma2-2b: head dim 144 (16 mod
32, as the JAX config derives 4608 / 32) with both softcaps (attention 50,
final 30). One LOCAL/GLOBAL period, d_model 128, 16 q / 8 KV heads of 144
(GQA rep 2, as the full model's 32 / 16), so KH * hd = 1152 lanes, nine
128-lane groups, and every odd KV head starts 16 lanes into a 32-lane
chunk; vocab 512, window 32 under the 40-token prompt.

Tolerances, as ``tests/test_torch_gemma3.py``: f32 forward logits to 2e-4;
serving in f32, prefill and teacher-forced step logits to 2e-3 and the
greedy tokens equal; one qm + sfp8 train step (every draw 0): loss, xent
and grad norm to rtol 1e-5, the learned bitlengths to 1e-4, the
gradients, read from AdamW's first moment, to 1e-5 of each tensor's
largest (ROADMAP §C).
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
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.configs.base import reduced as treduced
from repro_torch.core.stash import float_leaves
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
HEADS = dict(n_heads=16, n_kv_heads=8, head_dim=144)


def _cfgs():
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, d_model=128, seq=S),
                                   dtype="float32", **HEADS)
    return (cut(jconfigs.get("gemma2-27b"), jreduced),
            cut(tconfigs.get("gemma2-27b"), treduced))


def test_config_matches_jax():
    j, t = jconfigs.get("gemma2-27b"), tconfigs.get("gemma2-27b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.head_dim_ == 144 and t.head_dim_ % 32 == 16
    assert (t.attn_softcap, t.final_softcap) == (50.0, 30.0)
    assert t.tie_embeddings and t.window == 4096
    assert t.n_periods == 23 and not t.remainder
    jc, tc = _cfgs()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.layer_kinds() == ("local", "global")
    assert tc.window < PROMPT < S
    assert tc.n_kv_heads * tc.head_dim_ % 128 == 0


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs()
    return JModel(jc).init(jax.random.PRNGKey(0)), jc, tc


def test_forward_logits_match_jax(params):
    """Both softcaps act: every logit lies under the final cap of 30."""
    jp, jc, tc = params
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (B, S))
    jm = JModel(jc)
    jl, _ = jax.jit(lambda p, t: jm.forward(p, t, jm.run_state(
        jax.random.PRNGKey(1))))(jp, jnp.asarray(tokens, jnp.int32))
    tl = TModel(tc, device="cpu").forward(
        convert.from_jax(jp, tc), torch.from_numpy(tokens),
        RunState(gen=None, pol=None))[0].detach().numpy()[..., :jc.vocab]
    np.testing.assert_allclose(tl, np.asarray(jl)[..., :jc.vocab],
                               atol=2e-4, rtol=0)
    assert np.abs(tl).max() < 30.0


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
def test_serving_matches_jax(params, container):
    """JAX prefill + stepwise greedy decode over a packed cache against the
    port's prefill, teacher-forced steps and ``engine.generate``: the
    40-token prompt wraps the 32-slot local ring."""
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
    assert tcache["layers"][0].k.data["bases"].shape[1] == jc.window
    np.testing.assert_allclose(tl[:, -1].numpy(), np.asarray(logits)[:, -1],
                               atol=2e-3, rtol=0)
    for i, want in enumerate(steps):
        tok = torch.from_numpy(tokens[:, i:i + 1]).long()
        tl, tcache = tm.decode_step(tp, tcache, tok, PROMPT + i)
        np.testing.assert_allclose(tl[:, -1].numpy(), want, atol=2e-3,
                                   rtol=0, err_msg=f"step {i}")
    res = engine.generate(tm, tp, tprompt, NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), tokens)


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def test_train_step_matches_jax(params):
    """One qm + sfp8 step from the same state and batch, from integer bits
    (every draw 0), against JAX's step run op by op (jitted, XLA's fusions
    reassociate f32 sums: ``tests/test_torch_mistral_train.py``)."""
    jparams, jc, tc = params
    kw = dict(gamma=0.05, lr=0.05, container="sfp8")
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED))
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED))
    jm = JModel(jc, jpolicies.get("qm", **kw))
    tm = TModel(tc, tpolicies.get("qm", **kw), device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    learn = {k: jnp.full_like(v, 3.0 if k.startswith("act") else 5.0)
             for k, v in js.pstate.learn.items()}
    js = js._replace(params=jax.tree.map(jnp.asarray, jparams),
                     pstate=js.pstate._replace(learn=learn),
                     step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    b = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)).batch(0)
    with jax.disable_jit():
        jnew, jmet = jstep.make_train_step(jm, jtc)(
            js, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tmet = tstep.make_train_step(tm, ttc)(
        ts, {k: torch.from_numpy(v).long() for k, v in b.items()})
    for k in ("loss", "xent", "grad_norm", "policy_penalty"):
        np.testing.assert_allclose(float(tmet[k]), float(np.asarray(jmet[k])),
                                   rtol=1e-5, err_msg=k)
    for k, v in jax.tree.map(np.asarray, jnew.pstate.learn).items():
        np.testing.assert_allclose(tnew.pstate.learn[k].detach().numpy(), v,
                                   atol=1e-4, err_msg=k)
    jm_ = convert.from_jax(jax.tree.map(np.asarray, jnew.opt.m), tc)
    for (path, m), (_, tm_) in zip(float_leaves(jm_),
                                   float_leaves(tnew.opt.m)):
        assert _rel_to_max(m.numpy(), tm_.numpy()) <= 1e-5, path
