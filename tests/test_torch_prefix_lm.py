"""The port's prefix-LMs, paligemma-3b and musicgen-large, against the JAX
package on the CPU.

Both models read precomputed conditioning embeddings (``cond_embeddings``,
(B, P, d_model)) as a prefix every position sees; the frontends that make
them are stubs in both packages. The cuts keep each model's attention
layout: paligemma 8 q / 1 KV head of 128 (GQA rep 8, one KV head, as the
real one's heads of 256), d_model 128, tied and scaled embeddings;
musicgen JAX's ``reduced()`` (4 q / 4 KV heads of 32, rep 1), a GELU MLP
without GLU and an untied head. Both with P 8 (``reduced()``) and
P + S <= 1024, where JAX's ``attention_train`` takes its oracle (above
it JAX drops the prefix mask: ``tests/test_torch_prefix_attention.py``).
The conditioning embeddings are random, from numpy: zeros stay zero
through every layer, so with them the mask would change no output (the
launchers feed zeros, as JAX's do).

Tolerances, as the other parity tests of the port: the f32 forward's
logits, ``loss`` and gradients to 1e-5 of each tensor's largest element
(the loss to rtol 1e-5); serving in f32, prefill and teacher-forced step
logits to 2e-3 and the greedy tokens equal; conversions bit for bit. The
training steps are in ``tests/test_torch_prefix_lm_train.py``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.data import synthetic as jsyn
from repro.models.model import DecoderModel as JModel
from repro.serve import engine as jengine
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import reduced as treduced
from repro_torch.core.stash import float_leaves
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.models.model import RunState
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine
from repro_torch.train import step as tstep

torch.set_num_threads(2)

ARCHS = ("paligemma-3b", "musicgen-large")
B, S, PROMPT, NEW = 2, 64, 40, 6
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


def _cond(cfg, batch, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jc, tc = _cfgs(request.param)
    jp = JModel(jc).init(jax.random.PRNGKey(0))
    return request.param, jp, jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_parameter_count_match_jax(arch):
    """Field for field JAX's config (full and as the launchers' presets cut
    it); the full model's parameters, counted from the port's layer
    arithmetic, equal JAX's ``param_count()`` (which leaves out the final
    norm), and a cut model's tensors hold that many plus the final norm."""
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for cut in (dict(), dict(n_layers=4, d_model=256)):
        assert dataclasses.asdict(jreduced(j, **cut)) == dataclasses.asdict(
            treduced(t, **cut))
    assert t.period == ("global",) and not t.remainder
    assert t.attn_softcap is None and t.final_softcap is None

    def count(cfg):
        emb = cfg.padded_vocab * cfg.d_model
        return (emb * (1 if cfg.tie_embeddings else 2)
                + cfg.n_layers * TModel(cfg, device="cpu").layer_param_count())
    assert count(t) == j.param_count()
    jc, tc = _cfgs(arch)
    params = TModel(tc, device="cpu").init(0)
    assert sum(p.numel() for p in tadamw.leaves(params)) == (
        count(tc) + tc.d_model)
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        JModel(jc).param_shapes())) == count(tc) + tc.d_model


def test_from_jax(setup):
    """``convert.from_jax`` carries every leaf bit for bit, under the
    port's names: musicgen's MLP has no ``w_gate`` and its head is
    ``params["head"]``; paligemma is tied."""
    arch, jp, jc, tc = setup
    tp = convert.from_jax(jp, tc)
    fresh = TModel(tc, device="cpu").init(0)
    mine, theirs = dict(float_leaves(fresh)), dict(float_leaves(tp))
    assert mine.keys() == theirs.keys()
    for path, a in mine.items():
        b = theirs[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
    mlp = tp["layers"][0]["mlp"]
    assert ("w_gate" in mlp) == tc.glu
    assert ("head" in tp) == (not tc.tie_embeddings)
    if "head" in tp:
        np.testing.assert_array_equal(tp["head"].numpy(),
                                      np.asarray(jp["head"]))
    np.testing.assert_array_equal(
        mlp["w_in"].numpy(),
        np.asarray(jp["periods"]["slot0"]["mlp"]["w_in"][0]))


def _batch(jc, seed=0):
    return jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=seed)).batch(0)


def test_forward_loss_and_gradients_match_jax(setup):
    """Logits over the token positions, the loss and every gradient of the
    f32 forward with random conditioning embeddings, policy off."""
    arch, jp, jc, tc = setup
    b = _batch(jc)
    cond = _cond(jc, B)
    jm = JModel(jc)
    run = jm.run_state(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["cond_embeddings"] = jnp.asarray(cond)
    jl, _ = jax.jit(lambda p, t, c: jm.forward(p, t, run, cond_embeddings=c))(
        jp, jb["tokens"], jb["cond_embeddings"])
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, run)[0]))(jp)

    tm = TModel(tc, device="cpu")
    tp = convert.from_jax(jp, tc)
    for t in tadamw.leaves(tp):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tb["cond_embeddings"] = torch.from_numpy(cond)
    run_t = RunState(gen=None, pol=None)
    tl, _ = tm.forward(tp, tb["tokens"], run_t,
                       cond_embeddings=tb["cond_embeddings"])
    assert tuple(tl.shape[:2]) == (B, S)
    assert _rel_to_max(np.asarray(jl)[..., :jc.vocab],
                       tl.detach().numpy()[..., :jc.vocab]) <= 1e-5
    tval, _ = tm.loss(tp, tb, run_t)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    want = convert.from_jax(jax.tree.map(np.asarray, jgrad), tc)
    for (path, g), (_, t) in zip(float_leaves(want), float_leaves(tp)):
        assert _rel_to_max(g.numpy(), t.grad.numpy()) <= 1e-5, path
    # Without the conditioning the same tokens give JAX's prefix-free
    # logits.
    jl0, _ = jax.jit(lambda p, t: jm.forward(p, t, run))(jp, jb["tokens"])
    tl0, _ = tm.forward(tp, tb["tokens"], run_t)
    assert _rel_to_max(np.asarray(jl0)[..., :jc.vocab],
                       tl0.detach().numpy()[..., :jc.vocab]) <= 1e-5
    assert _rel_to_max(tl0.detach().numpy(), tl.detach().numpy()) > 1e-3


def test_zero_prefix_hides_the_mask(setup, monkeypatch):
    """With the launchers' zero embeddings the prefix rows stay zero
    through every layer, so attending to them causally or fully gives the
    same logits; random embeddings tell the two apart. (So every check of
    the mask draws random embeddings.)"""
    arch, jp, jc, tc = setup
    tm, tp = TModel(tc, device="cpu"), convert.from_jax(jp, tc)
    tokens = torch.from_numpy(_batch(jc)["tokens"]).long()
    run = RunState(gen=None, pol=None)
    attention = ops.attention

    def forward(cond, causal_only):
        if causal_only:
            monkeypatch.setattr(ops, "attention", lambda *a, prefix_len=0,
                                **kw: attention(*a, **kw))
        out, _ = tm.forward(tp, tokens, run, cond_embeddings=cond)
        monkeypatch.setattr(ops, "attention", attention)
        return out
    zeros = torch.zeros((B, tc.prefix_tokens, tc.d_model))
    assert torch.equal(forward(zeros, False), forward(zeros, True))
    cond = torch.from_numpy(_cond(tc, B))
    assert _rel_to_max(forward(cond, False).numpy(),
                       forward(cond, True).numpy()) > 1e-3


def _jax_greedy(jm, jp, prompt, cond, max_len):
    P = jm.cfg.prefix_tokens
    logits, cache = jax.jit(lambda p, t, c: jm.prefill(
        p, t, max_len, cond_embeddings=c))(jp, jnp.asarray(prompt),
                                          jnp.asarray(cond))
    step = jax.jit(jm.decode_step)
    lg, toks, steps = logits, [], []
    for i in range(NEW):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i == NEW - 1:
            break
        lg, cache = step(jp, cache, tok,
                         jnp.asarray(P + PROMPT + i, jnp.int32))
        steps.append(np.asarray(lg)[:, -1])
    return np.asarray(logits)[:, -1], steps, np.concatenate(toks, 1)


@pytest.mark.parametrize("container", [None, "sfp8", "sfp-m2e4"])
def test_serving_matches_jax(setup, container):
    """JAX's prefill and stepwise greedy decode from position P + S, raw
    or packed cache, against the port's prefill, teacher-forced steps and
    ``engine.generate``: the same greedy tokens. JAX's ``generate`` gives
    them too."""
    arch, jp, jc, tc = setup
    P = jc.prefix_tokens
    max_len = P + PROMPT + NEW
    prompt = np.random.default_rng(2).integers(
        0, jc.vocab, (B, PROMPT)).astype(np.int32)
    cond = _cond(jc, B, seed=3)
    jm = JModel(jc, kv_container=container)
    jlogits, jsteps, tokens = _jax_greedy(jm, jp, prompt, cond, max_len)
    jres = jengine.generate(jm, jp, jnp.asarray(prompt), NEW,
                            cond_embeddings=jnp.asarray(cond))
    np.testing.assert_array_equal(np.asarray(jres.tokens), tokens)

    tm = TModel(tc, kv_container=container, device="cpu")
    tp = convert.from_jax(jp, tc)
    tprompt, tcond = torch.from_numpy(prompt).long(), torch.from_numpy(cond)
    tl, tcache = tm.prefill(tp, tprompt, max_len, cond_embeddings=tcond)
    np.testing.assert_allclose(tl[:, -1].numpy(), jlogits, atol=2e-3,
                               rtol=0)
    for i, want in enumerate(jsteps):
        tok = torch.from_numpy(tokens[:, i:i + 1]).long()
        tl, tcache = tm.decode_step(tp, tcache, tok, P + PROMPT + i)
        np.testing.assert_allclose(tl[:, -1].numpy(), want, atol=2e-3,
                                   rtol=0, err_msg=f"step {i}")
    res = engine.generate(tm, tp, tprompt, NEW, cond_embeddings=tcond)
    np.testing.assert_array_equal(res.tokens.numpy(), tokens)
    np.testing.assert_allclose(res.prefill_logits.numpy(), jlogits,
                               atol=2e-3, rtol=0)


def test_paged_engine_refuses_prefix_archs(setup):
    """As JAX's, the paged engine does not serve a prefix-LM."""
    arch, jp, jc, tc = setup
    tm = TModel(tc, kv_container="sfp8", device="cpu")
    with pytest.raises(NotImplementedError, match="prefix"):
        engine.PagedEngine(tm, convert.from_jax(jp, tc), max_slots=2,
                           max_len=64)
    with pytest.raises(NotImplementedError, match="prefix"):
        jengine.PagedEngine(JModel(jc, kv_container="sfp8"), jp,
                            max_slots=2, max_len=64)


@pytest.mark.parametrize("policy", ["qm", "qm+qe"])
def test_scope_lambdas_match_jax(setup, policy):
    """The footprint weights count the prefix in each period's stash,
    B x (S + P) x d values, as JAX's do."""
    arch, jp, jc, tc = setup
    jl = jstep._scope_lambdas(JModel(jc, policy), (B, S))
    tl = tstep._scope_lambdas(TModel(tc, policy, device="cpu"), (B, S))
    for k, v in jl.items():
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(v), rtol=1e-6,
                                   err_msg=k)
    assert tl["act"].numel() == tc.n_periods


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_cpu_when_asked(monkeypatch, arch):
    """``launch.serve`` (batch mode, raw cache; musicgen's 128 KV lanes
    also from sfp8) and ``launch.train --preset tiny`` take both archs and
    feed zero conditioning embeddings, as JAX's launchers do; ``--trace``
    refuses them. paligemma's tiny cut has one KV head of 32 lanes, which
    no packed cache takes: it says so."""
    _no_gpu(monkeypatch)
    base = ["--arch", arch, "--preset", "tiny", "--batch", "2",
            "--prompt-len", "40", "--max-new", "3", "--device", "cpu"]
    rep = tserve.run_batch(tserve.build_parser().parse_args(base))
    assert rep["tokens"] == 6 and len(rep["sample"]) == 3
    packed = base + ["--kv-container", "sfp8"]
    if arch == "musicgen-large":
        rep = tserve.run_batch(tserve.build_parser().parse_args(packed))
        assert rep["kv"] == "sfp8" and len(rep["sample"]) == 3
    else:
        with pytest.raises(ValueError, match="128 lanes"):
            tserve.run_batch(tserve.build_parser().parse_args(packed))
    with pytest.raises(SystemExit, match="prefix-LM"):
        tserve.run_trace(tserve.build_parser().parse_args(
            ["--arch", arch, "--preset", "tiny", "--trace",
             "--kv-container", "sfp8", "--device", "cpu"]))
    out = ttrain.main(["--arch", arch, "--preset", "tiny", "--policy", "qm",
                       "--container", "sfp8", "--steps", "1", "--device",
                       "cpu"])
    assert len(out["history"]) == 1
    assert np.isfinite(out["history"][0]["loss"])
