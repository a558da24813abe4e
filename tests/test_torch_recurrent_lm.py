"""The port's recurrent families against the JAX package, on the CPU, in
f32: mamba2-370m cut by ``reduced`` to 3 SSD layers (d_model 128, 8 heads
of 32, state 16, chunk 16; no MLP) and recurrentgemma-9b at
``n_layers=5``, one (rglru, rglru, local) period and a remainder of two
RG-LRU layers (d_model 128, 4 q / 1 KV heads of 32, window 32, lru 128).
JAX initialises the weights and ``repro_torch.convert`` hands them over,
the f32 vectors bit for bit.

Tolerances, as the other parity tests of the port: the forward's logits,
the loss and every gradient to 1e-5 of each tensor's largest element;
serving prefill and teacher-forced step logits to 2e-3, the greedy
tokens equal (40-token prompts past recurrentgemma's 32-slot window, so
its ring wraps). Also: the per-kind layer counts and both launchers on
the CPU (paged serving: ``test_torch_recurrent_paged.py``).
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
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import reduced as treduced
from repro_torch.core.stash import float_leaves
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.models.model import RunState
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine

torch.set_num_threads(2)

B, S, NEW, PROMPT = 2, 64, 6, 40
ARCHS = {"mamba2-370m": 3, "recurrentgemma-9b": 5}


def _cfgs(arch, **kw):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=ARCHS[arch]),
                                   dtype="float32", **kw)
    return (cut(jconfigs.get(arch), jreduced),
            cut(tconfigs.get(arch), treduced))


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


_PARAMS = {}


def _params(arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        jc, tc = _cfgs(arch, **kw)
        jp = jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(0)))
        _PARAMS[key] = jp, jc, tc
    return _PARAMS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_counts_and_layout_match_jax(arch):
    """Per kind, the port's ``layer_param_count`` is the leaves of JAX's
    slot, 1-D ones included, at full size and cut; ``param_count`` is all
    of JAX's leaves; ``convert.from_jax`` gives the tree the port's own
    init draws (an SSD layer without ``mlp_norm`` or MLP), its f32
    vectors bit for bit."""
    for cut in (False, True):
        if cut:
            jc, tc = _cfgs(arch)
        else:
            jc, tc = jconfigs.get(arch), tconfigs.get(arch)
        shapes = JModel(jc).param_shapes()
        tm = TModel(tc, device="cpu")
        for i, kind in enumerate(jc.period):
            slot = shapes["periods"][f"slot{i}"]
            assert tm.layer_param_count(kind) == sum(
                int(np.prod(s.shape[1:])) for s in jax.tree.leaves(slot))
        assert tm.param_count() == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    if arch == "recurrentgemma-9b":
        with pytest.raises(ValueError, match="differ"):
            tm.layer_param_count()
    jp, jc, tc = _params(arch)
    tp = convert.from_jax(jp, tc)
    fresh = TModel(tc, device="cpu").init(0)
    assert {p: (x.shape, x.dtype) for p, x in float_leaves(fresh)} == {
        p: (x.shape, x.dtype) for p, x in float_leaves(tp)}
    kinds = tc.layer_kinds()
    assert len(tp["layers"]) == len(kinds)
    for i, kind in enumerate(kinds):
        layer = tp["layers"][i]
        if kind == "ssd":
            assert set(layer) == {"pre_norm", "ssd"}
            src = jp["periods"]["slot0"]["ssd"]
            for k in ("A_log", "D", "dt_bias"):
                assert layer["ssd"][k].dtype == torch.float32
                assert np.array_equal(layer["ssd"][k].numpy(), src[k][i])
        elif kind == "rglru":
            assert set(layer) == {"pre_norm", "rglru", "mlp_norm", "mlp"}
            assert layer["rglru"]["lam"].dtype == torch.float32
    if tc.remainder:
        assert np.array_equal(tp["layers"][-1]["rglru"]["w_x"].numpy(),
                              jp["rem"]["slot1"]["rglru"]["w_x"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_jax(arch):
    """Logits, the loss and every gradient of the f32 forward, policy
    off, against JAX's."""
    jp, jc, tc = _params(arch)
    b = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)).batch(0)
    jm = JModel(jc)
    run = jm.run_state(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl, _ = jax.jit(lambda p, t: jm.forward(p, t, run))(jp, jb["tokens"])
    (jval, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, run), has_aux=True))(jp)

    tm = TModel(tc, device="cpu")
    tp = convert.from_jax(jp, tc)
    for t in tadamw.leaves(tp):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    run_t = RunState(gen=None, pol=None)
    tl, _ = tm.forward(tp, tb["tokens"], run_t)
    assert _rel_to_max(np.asarray(jl)[..., :jc.vocab],
                       tl.detach().numpy()[..., :jc.vocab]) <= 1e-5
    tval, _ = tm.loss(tp, tb, run_t)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    tval.backward()
    want = convert.from_jax(jax.tree.map(np.asarray, jgrad), tc)
    paths = []
    for (path, g), (_, t) in zip(float_leaves(want), float_leaves(tp)):
        paths.append(path)
        assert _rel_to_max(g.numpy(), t.grad.numpy()) <= 1e-5, path
    block = "ssd" if arch == "mamba2-370m" else "rglru"
    assert (("layers", len(tc.layer_kinds()) - 1, block, "w_x") in paths)


def _jax_greedy(jm, jp, prompt, max_len):
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
    return np.asarray(logits)[:, -1], steps, np.concatenate(toks, 1)


@pytest.mark.parametrize("arch,container", [
    ("mamba2-370m", None), ("mamba2-370m", "sfp8"),
    ("recurrentgemma-9b", None), ("recurrentgemma-9b", "sfp8")])
def test_serving_matches_jax(arch, container):
    """JAX prefill + stepwise greedy decode against the port's prefill,
    teacher-forced ``decode_step`` and ``engine.generate``: the same
    greedy tokens. recurrentgemma's packed cache needs 128 KV lanes, so
    its sfp8 case takes one KV head of 128 (4 q heads)."""
    kw = dict(head_dim=128) if (container and arch != "mamba2-370m") else {}
    jp, jc, tc = _params(arch, **kw)
    max_len = PROMPT + NEW
    prompt = np.random.default_rng(2).integers(
        0, jc.vocab, (B, PROMPT)).astype(np.int32)
    jlogits, jsteps, tokens = _jax_greedy(
        JModel(jc, kv_container=container), jp, prompt, max_len)
    tm = TModel(tc, kv_container=container, device="cpu")
    tp = convert.from_jax(jp, tc)
    tprompt = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        tl, tcache = tm.prefill(tp, tprompt, max_len)
        np.testing.assert_allclose(tl[:, -1].numpy(), jlogits, atol=2e-3,
                                   rtol=0)
        for i, want in enumerate(jsteps):
            tok = torch.from_numpy(tokens[:, i:i + 1]).long()
            tl, tcache = tm.decode_step(tp, tcache, tok, PROMPT + i)
            np.testing.assert_allclose(tl[:, -1].numpy(), want, atol=2e-3,
                                       rtol=0, err_msg=f"step {i}")
    res = engine.generate(tm, tp, tprompt, NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), tokens)
    assert len(set(tokens.flatten().tolist())) > 1


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_cpu_when_asked(monkeypatch, arch):
    """``launch.serve`` and ``launch.train --preset tiny`` take both
    archs; training runs under qm + sfp8 and qm+qe + sfp-m2e4 (the
    remainder's straight-through decision no longer raises)."""
    _no_gpu(monkeypatch)
    rep = tserve.run_batch(tserve.build_parser().parse_args(
        ["--arch", arch, "--preset", "tiny", "--batch", "2",
         "--prompt-len", "40", "--max-new", "3", "--device", "cpu"]))
    assert rep["tokens"] == 6 and len(rep["sample"]) == 3
    for policy, container in (("qm", "sfp8"), ("qm+qe", "sfp-m2e4")):
        out = ttrain.main(["--arch", arch, "--preset", "tiny", "--policy",
                           policy, "--container", container, "--steps", "1",
                           "--device", "cpu"])
        assert np.isfinite(out["history"][0]["loss"])
