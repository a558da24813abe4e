"""Compressed gradients with error feedback: the port against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks bit
for bit; the JAX side runs its default ``ref`` backend.

Tolerances. ``compress_grads`` is a bit machine (an f32 add, the codec's
round trip, an f32 subtract): q and the new residual are bit-equal to
JAX's for every codec. The two-step trains follow
``tests/test_torch_train.py``: f32 losses and grad norms to rtol 1e-5
(summation order only); the residual leaves to 1e-5 of each leaf's
largest element. The fault-and-replay run is bit-equal to the
uninterrupted one, residual included.
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
from repro.train import grad_compress as jgc
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.checkpoint import CheckpointManager, leaf_names
from repro_torch.configs.base import reduced as treduced
from repro_torch.core.stash import float_leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import Schedule as TSchedule
from repro_torch.train import grad_compress as tgc
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

torch.set_num_threads(2)

CODECS = ("bit_exact", "sfp8", "sfp16", "sfp-m2e4", "gecko8")
# Last dimensions on and off the 128-lane group (the SFP codecs pack the
# latter through the flat, zero-padded layout); a 1-D leaf and a list.
SHAPES = {"w": (16, 256), "odd": (3, 200), "vec": (37,),
          "layers": [(5, 129), (2, 128)]}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, fn) for v in shapes]
    return fn(shapes)


def _grads_and_residual(seed):
    """f32 gradients over 40 binades and a residual ~1e-3 of them."""
    rng = np.random.default_rng(seed)

    def draw(scale):
        return lambda s: (rng.standard_normal(s) * scale * np.exp2(
            rng.integers(-20, 20, s))).astype(np.float32)
    return _tree(SHAPES, draw(1.0)), _tree(SHAPES, draw(1e-3))


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bits(a):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("bits", [1, 3, 5, 7])
@pytest.mark.parametrize("codec", CODECS)
def test_compress_grads_bit_equal_to_jax(codec, bits):
    g, r = _grads_and_residual(bits)
    jq, jr = jgc.compress_grads(_to_jax(g), _to_jax(r), bits, codec)
    tg, tr = _to_torch(g), _to_torch(r)
    tq, tr_new = tgc.compress_grads(tg, tr, bits, codec)
    for name, a, b in (("q", jax.tree.leaves(jq), _leaves(tq)),
                       ("residual", jax.tree.leaves(jr), _leaves(tr_new))):
        assert len(a) == len(b) == 5
        for x, y in zip(a, b):
            np.testing.assert_array_equal(_bits(y), _bits(x),
                                          err_msg=f"{codec} {bits} {name}")
    # In place: q over the f32 gradients, the new residual over the old.
    for x, y in zip(_leaves(tg) + _leaves(tr), _leaves(tq) + _leaves(tr_new)):
        assert x is y
    if codec == "bit_exact":
        assert any(np.any(_bits(x) != 0) for x in _leaves(tr_new))


@pytest.mark.parametrize("bits", [0, 1, 5, 22, 23])
def test_bit_exact_feedback_is_exact(bits):
    """``bit_exact`` keeps gf's sign and exponent, so in f32 ``gf - q`` is
    exact and ``q + r' == gf`` bit for bit (a bf16 gradient too)."""
    g, r = _grads_and_residual(100 + bits)
    tg, tr = _to_torch(g), _to_torch(r)
    gf = [a + b for a, b in zip(_leaves(tg), _leaves(tr))]
    half = {"h": tg["w"].to(torch.bfloat16)}
    tq, tr_new = tgc.compress_grads(tg, tr, bits)
    for want, q, res in zip(gf, _leaves(tq), _leaves(tr_new)):
        np.testing.assert_array_equal(_bits(q + res), _bits(want))
    hq, hres = tgc.compress_grads(half, {"h": torch.zeros(16, 256)}, bits)
    assert hq["h"].dtype == torch.float32 and half["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hq["h"] + hres["h"]),
                                  _bits(half["h"].float()))


def test_init_residual_matches_jax():
    rng = np.random.default_rng(0)
    like = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32)]}
    tl = _to_torch(like)
    tl["b"][0] = tl["b"][0].to(torch.bfloat16)
    got = tgc.init_residual(tl)
    want = jgc.init_residual(_to_jax(like))
    for x, y in zip(jax.tree.leaves(want), _leaves(got)):
        assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
        assert not y.any()
    assert got["b"][0] is not tl["b"][0]


# ---------------------------------------------------------------------------
# Two compressed steps of the reduced gemma2-2b against JAX's make_train_step
# ---------------------------------------------------------------------------

B, S, LR, BITS = 4, 64, 3e-3, 5
G_GAP = (1e-5, 1e-3)   # gradient gap per step, of each leaf's largest gf
SCHED = dict(kind="cosine", base_lr=LR, warmup_steps=1, total_steps=10)


def _setup(policy):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=4), n_kv_heads=2,
                                   dtype="float32")
    jc = cut(jconfigs.get("gemma2-2b"), jreduced)
    tc = cut(tconfigs.get("gemma2-2b"), treduced)
    kw = ({} if policy == "none" else
          dict(gamma=0.05, lr=0.05, init_bits=3.0, container="sfp8"))
    jp, tp = jpolicies.get(policy, **kw), tpolicies.get(policy, **kw)
    jtc = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=LR),
                            schedule=JSchedule(**SCHED),
                            grad_compress_bits=BITS)
    ttc = tstep.TrainConfig(opt=tadamw.AdamWConfig(lr=LR),
                            schedule=TSchedule(**SCHED),
                            grad_compress_bits=BITS)
    jm, tm = JModel(jc, jp), TModel(tc, tp, device="cpu")
    js = jstep.init_state(jm, jax.random.PRNGKey(0), jtc)
    # Integer learned bits: every Bernoulli draw is 0 on both sides.
    learn = {k: jnp.full_like(v, 3.0 if k.startswith("act") else 5.0)
             for k, v in js.pstate.learn.items()}
    js = js._replace(pstate=js.pstate._replace(learn=learn),
                     step=jnp.asarray(1, jnp.int32))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), tc)
    corpus = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0))
    return (jm, jtc, js), (tm, ttc, ts), corpus


def _ceil_draw_j(n_float, key, max_bits, min_bits=0):
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    return jnp.ceil(nf).astype(jnp.int32)


def _ceil_draw_t(n_float, generator, max_bits, min_bits=0, shape=None):
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


def _capture(monkeypatch):
    """Record both packages' (gf = g + r, q, new residual) of every
    compressed step, as port-layout lists of numpy leaves."""
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jgc.compress_grads, tgc.compress_grads

    def j_wrap(grads, residual, bits, codec):
        q, r = j_orig(grads, residual, bits, codec)
        gf = jax.tree.map(lambda g, r0: g.astype(jnp.float32) + r0, grads,
                          residual)
        jax.debug.callback(lambda *t: seen["jax"].append(t), gf, q, r)
        return q, r

    def t_wrap(grads, residual, bits, codec):
        gf = [(g.float() + r).numpy() for g, r in zip(grads, residual)]
        q, r = t_orig(grads, residual, bits, codec)
        seen["port"].append((gf, [t.numpy().copy() for t in q],
                             [t.numpy().copy() for t in r]))
        return q, r
    monkeypatch.setattr(jstep.grad_compress, "compress_grads", j_wrap)
    monkeypatch.setattr(tstep.grad_compress, "compress_grads", t_wrap)
    return seen


@pytest.mark.parametrize("policy", ["none", "qm"])
def test_two_compressed_steps_match_jax(policy, monkeypatch):
    """Two steps from one state, draws injected as ceil (the learned bits
    leave their integers after the first SGD step). Losses and grad norms
    to rtol 1e-5.

    The residuals, through ``convert.from_jax``, are held to what their
    inputs allow. The step's gradients (gf less the residual fed in)
    agree to 1e-5 of each leaf's largest gf at the first step, as in
    ``tests/test_torch_train.py``; at the second to 1e-3 (measured
    1.3e-4 under qm: AdamW's first step moves a parameter whose gradient
    is below ~1e-6 anywhere within 2 lr, and qm's 5-bit weight truncation
    turns such a move into a whole-step change of the weight). q is a
    5-bit truncation of gf, so where the two packages' gf straddle a
    truncation boundary the q differ by one 5-bit step and the residuals
    by it the other way: under 1e-2 of the values may. Everywhere else
    the residuals agree to the gf gap (1e-5 of the leaf's largest gf
    plus the gradients' gap plus the gap of the residuals fed in: a
    flipped residual re-enters gf, where the next q absorbs it)."""
    from repro.core import containers as jcontainers
    from repro_torch.core import containers as tcontainers
    monkeypatch.setattr(jcontainers, "stochastic_bitlength", _ceil_draw_j)
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", _ceil_draw_t)
    seen = _capture(monkeypatch)
    (jm, jtc, js), (tm, ttc, ts), corpus = _setup(policy)
    jstep_fn = jax.jit(jstep.make_train_step(jm, jtc))
    tstep_fn = tstep.make_train_step(tm, ttc)
    assert all(not r.any() for r in tadamw.leaves(ts.grad_residual))

    def port_layout(tree):
        return [t.numpy() for _, t in float_leaves(convert.from_jax(
            jax.tree.map(np.asarray, tree), tm.cfg))]
    prev = ([np.zeros(t.shape, np.float32)
             for t in tadamw.leaves(ts.params)],) * 2
    for i in range(2):
        b = corpus.batch(i)
        js, jmet = jstep_fn(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep_fn(ts, {k: torch.from_numpy(v).long()
                                 for k, v in b.items()})
        for k in ("loss", "xent", "grad_norm", "policy_penalty"):
            np.testing.assert_allclose(float(tmet[k]),
                                       float(np.asarray(jmet[k])),
                                       rtol=1e-5, err_msg=f"{policy} {i} {k}")
        jgf, jq, jr = (port_layout(t) for t in seen["jax"][i])
        tgf, tq, tr = seen["port"][i]
        # The state's residual is the one the step computed.
        assert all(np.array_equal(a, b) for a, b in zip(
            port_layout(js.grad_residual), jr))
        assert all(np.array_equal(a, t.numpy()) for a, t in zip(
            tr, tadamw.leaves(ts.grad_residual)))
        flips = n = 0
        for a_gf, b_gf, a_q, b_q, a_r, b_r, a_r0, b_r0 in zip(
                jgf, tgf, jq, tq, jr, tr, *prev):
            tol = 1e-5 * np.abs(a_gf).max()
            # The step's gradients: gf less the residual fed in.
            g_gap = np.abs((a_gf - a_r0) - (b_gf - b_r0))
            assert g_gap.max() <= G_GAP[i] * np.abs(a_gf).max(), i
            gf_gap = g_gap + np.abs(a_r0 - b_r0) + tol
            # Truncation moves each q by less than one 5-bit step of its
            # binade: the q differ by at most the gf gap and one step, the
            # residuals by the gf gap where the q are equal.
            step = np.exp2(np.floor(np.log2(np.maximum(
                np.maximum(np.abs(a_q), np.abs(b_q)), 1e-38))) - BITS)
            assert np.all(np.abs(a_q - b_q) <= step + gf_gap), i
            flip = a_q != b_q
            assert np.all((np.abs(a_r - b_r) <= gf_gap)[~flip]), i
            assert np.abs(a_r).max() > 0
            flips += int(flip.sum())
            n += flip.size
        prev = (jr, tr)
        assert n == sum(p.numel() for p in tadamw.leaves(ts.params))
        assert flips <= 1e-2 * n, (i, flips, n)
        print(f"{policy} step {i}: {flips} of {n} q values one 5-bit step "
              f"apart")


def test_step_without_residual_raises():
    (_, _, _), (tm, ttc, ts), corpus = _setup("none")
    b = {k: torch.from_numpy(v).long() for k, v in corpus.batch(0).items()}
    with pytest.raises(ValueError, match="grad_residual"):
        tstep.make_train_step(tm, ttc)(ts._replace(grad_residual=None), b)
    # Without compression the state carries no residual.
    plain = dataclasses.replace(ttc, grad_compress_bits=None)
    assert tstep.init_state(tm, 0, plain).grad_residual is None


def test_state_from_jax_carries_the_residual():
    (jm, jtc, js), (tm, _, ts), corpus = _setup("qm")
    b = corpus.batch(0)
    js, _ = jax.jit(jstep.make_train_step(jm, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    got = convert.state_from_jax(jax.tree.map(np.asarray, js), tm.cfg)
    assert got.grad_residual["layers"][0]["attn"]["wq"].shape == \
        tuple(js.grad_residual["periods"]["slot0"]["attn"]["wq"].shape[1:])
    per = len(tm.cfg.period)
    for p in range(tm.cfg.n_periods):
        for i in range(per):
            want = np.asarray(
                js.grad_residual["periods"][f"slot{i}"]["mlp"]["w_in"][p])
            got_t = got.grad_residual["layers"][p * per + i]["mlp"]["w_in"]
            np.testing.assert_array_equal(_bits(got_t), want.view(np.uint32))
    np.testing.assert_array_equal(
        _bits(got.grad_residual["embed"]["table"]),
        np.asarray(js.grad_residual["embed"]["table"]).view(np.uint32))
    none_state = js._replace(grad_residual=None)
    assert convert.state_from_jax(jax.tree.map(np.asarray, none_state),
                                  tm.cfg).grad_residual is None


# ---------------------------------------------------------------------------
# The launcher, checkpoints and restore-and-replay
# ---------------------------------------------------------------------------

ARGV = ["--arch", "gemma2-2b", "--preset", "tiny", "--policy", "qm",
        "--container", "sfp8", "--grad-compress-bits", str(BITS),
        "--device", "cpu"]


def test_launcher_compresses_gradients(capsys):
    res = tlaunch.main(ARGV + ["--steps", "3"])
    capsys.readouterr()
    st = res["state"]
    assert st.step == 3 and st.grad_residual is not None
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in res["history"])
    res_leaves = tadamw.leaves(st.grad_residual)
    assert len(res_leaves) == len(tadamw.leaves(st.params))
    assert all(r.dtype == torch.float32 for r in res_leaves)
    assert sum(bool(r.any()) for r in res_leaves) == len(res_leaves)
    args = tlaunch.build_parser().parse_args(ARGV)
    _, _, tc, _, _ = tlaunch.build(args)
    assert (tc.grad_compress_bits, tc.grad_codec) == (BITS, "bit_exact")
    assert tlaunch.build(tlaunch.build_parser().parse_args(
        ARGV[:-4] + ["--device", "cpu"]))[2].grad_compress_bits is None


def _loop_setup():
    args = tlaunch.build_parser().parse_args(ARGV + ["--steps", "5"])
    cfg, model, tc, batch, seq = tlaunch.build(args)
    dcfg = tsyn.SyntheticConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch, seed=0)

    def batches(start):
        for b in tsyn.batches(dcfg, start):
            yield {k: torch.from_numpy(v).long() for k, v in b.items()}
    return model, tc, batches


def test_checkpoint_keeps_the_residual(tmp_path):
    model, tc, batches = _loop_setup()
    step_fn = tstep.make_train_step(model, tc)
    state = tstep.init_state(model, 0, tc)
    it = batches(0)
    for _ in range(2):
        state, _ = step_fn(state, next(it))
    names = leaf_names(state)
    first = names.index(".grad_residual['embed']['table']")
    assert names[first - 1] == ".gen" and names[-1].startswith(
        ".grad_residual")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    back = mgr.restore(2, tstep.init_state(model, 1, tc))
    for a, b in zip(tadamw.leaves(back.grad_residual),
                    tadamw.leaves(state.grad_residual)):
        assert torch.equal(a, b) and b.any()
    # compress_bits truncates the residual's matrices with the parameters'
    # (their names lack "opt", as in the JAX package).
    CheckpointManager(str(tmp_path / "c"), compress_bits=3).save(2, state)
    cut = CheckpointManager(str(tmp_path / "c")).restore(2, back)
    r0, r1 = (t.grad_residual["layers"][0]["attn"]["wq"] for t in (cut,
                                                                   state))
    assert not torch.equal(r0, r1)
    assert torch.equal(r0, tlaunch.step_mod.grad_compress.codecs.get(
        "bit_exact").roundtrip(r1, bits=3))


def test_fault_replays_bit_equal_with_the_residual(tmp_path):
    model, tc, batches = _loop_setup()
    step_fn = tstep.make_train_step(model, tc)

    def run(ckdir=None, fault=None):
        lc = tloop.LoopConfig(total_steps=5, ckpt_every=2, log_every=1,
                              ckpt_dir=None if ckdir is None else str(ckdir))
        return tloop.run(step_fn, tstep.init_state(model, 0, tc), batches,
                         lc, fault_hook=fault, device="cpu")

    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("simulated node failure")

    ref = run()
    faulted = run(tmp_path, hook)
    assert fired == [3] and faulted.restarts == 1
    assert [h["step"] for h in faulted.history] == [0, 1, 2, 2, 3, 4]
    want = {h["step"]: h for h in ref.history}
    for h in faulted.history:
        for k in ("loss", "grad_norm", "qm_act_mean"):
            assert h[k] == want[h["step"]][k], (h["step"], k)
    for a, b in zip(tadamw.leaves(faulted.state.grad_residual) +
                    tadamw.leaves(faulted.state.params),
                    tadamw.leaves(ref.state.grad_residual) +
                    tadamw.leaves(ref.state.params)):
        assert torch.equal(a, b)
