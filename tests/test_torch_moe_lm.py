"""The port's MoE decoders against the JAX package, on the CPU, in f32:
olmoe-1b-7b cut by ``reduced`` (2 layers, d_model 128, 4 q / 4 KV heads
of 32, 4 experts of 256, top-2) and phi3.5-moe-42b-a6.6b at a cut that
keeps its GQA rep of 4 and its untied head (8 q / 2 KV heads of 64). JAX
initialises the weights (the router f32) and ``repro_torch.convert``
hands them over.

Tolerances, as the other parity tests of the port: the forward's logits,
the loss and every gradient to 1e-5 of each tensor's largest element, the
MoE metrics (``moe_aux_loss``, ``moe_lb_loss``, ``moe_z_loss``,
``moe_drop_frac``) to rtol 1e-5; serving prefill and teacher-forced step
logits to 2e-3, the greedy tokens equal; a seeded paged trace through the
scheduler token-identical to JAX's engine, stats included (an idle slot's
garbage token takes MoE capacity in both: decode routes the whole batch
as one group).
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
from repro.launch import serve as jserve
from repro.models.model import DecoderModel as JModel
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import reduced as treduced
from repro_torch.core.stash import float_leaves
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.models.model import MOE_AUX, RunState
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine
from repro_torch.serve import scheduler as tsched

torch.set_num_threads(2)

B, S, NEW, PROMPT = 2, 64, 6, 40
ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
HEADS = {"olmoe-1b-7b": {},
         "phi3.5-moe-42b-a6.6b": dict(n_heads=8, n_kv_heads=2, head_dim=64)}


def _cfgs(arch):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c), dtype="float32",
                                   **HEADS[arch])
    return (cut(jconfigs.get(arch), jreduced),
            cut(tconfigs.get(arch), treduced))


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jc, tc = _cfgs(arch)
        jp = jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(0)))
        _PARAMS[arch] = jp, jc, tc
    return _PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_param_count_and_layout_match_jax(arch):
    """Field for field JAX's config; the port's parameter count is JAX's
    ``param_count`` at full size (6.82 B and 41.87 B); the converted tree
    has one ``moe`` subtree a layer with an f32 router, shaped as the
    port's own init draws it."""
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.is_moe and t.period == ("global",) and not t.remainder
    tm = TModel(t, device="cpu")
    n = (t.padded_vocab * t.d_model * (1 if t.tie_embeddings else 2)
         + t.n_layers * tm.layer_param_count())
    assert n == j.param_count()
    assert round(n / 1e9, 2) == {"olmoe-1b-7b": 6.82,
                                 "phi3.5-moe-42b-a6.6b": 41.87}[arch]
    jp, jc, tc = _params(arch)
    tp = convert.from_jax(jp, tc)
    fresh = TModel(tc, device="cpu").init(0)
    assert {p: (x.shape, x.dtype) for p, x in float_leaves(fresh)} == {
        p: (x.shape, x.dtype) for p, x in float_leaves(tp)}
    layer = tp["layers"][0]
    assert "mlp" not in layer and layer["moe"]["router"].dtype == \
        torch.float32
    assert sum(x.numel() for _, x in float_leaves(layer)) == \
        TModel(tc, device="cpu").layer_param_count()
    # In a bf16 model the router stays f32.
    bf = TModel(treduced(t), device="cpu").init(0)["layers"][0]["moe"]
    assert bf["router"].dtype == torch.float32
    assert bf["w_in"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_draws_at_jax_scale(arch):
    """The port's ``moe_init`` draws every MoE leaf as JAX's
    ``ParamFactory`` does, N(0, 1 / shape[0]): the router (d, E) at
    d ** -0.5, the expert tensors at E ** -0.5 (their leading axis). Each
    leaf's sample deviation over the layers, on both packages' draws, lies
    within five standard errors of that scale, 5 / sqrt(2 n) of it."""
    jp, jc, tc = _params(arch)
    drawn = {"jax": convert.from_jax(jp, tc),
             "port": TModel(tc, device="cpu").init(0)}
    for which, params in drawn.items():
        layers = [layer["moe"] for layer in params["layers"]]
        assert set(layers[0]) == {"router", "w_in", "w_out", "w_gate"}
        for name, first in layers[0].items():
            x = torch.cat([m[name].double().flatten() for m in layers])
            scale = first.shape[0] ** -0.5
            assert scale == (tc.d_model if name == "router"
                             else tc.n_experts) ** -0.5
            assert abs(x.mean().item()) < 5 * scale / x.numel() ** 0.5
            assert abs(x.std().item() / scale - 1) < 5 / (
                2 * x.numel()) ** 0.5, (which, name, x.std().item(), scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_metrics_loss_and_gradients_match_jax(arch):
    """Logits, the MoE metrics, the loss (cross-entropy + aux) and every
    gradient of the f32 forward, policy off, against JAX's."""
    jp, jc, tc = _params(arch)
    b = jsyn.MarkovCorpus(jsyn.SyntheticConfig(
        vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)).batch(0)
    jm = JModel(jc)
    run = jm.run_state(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl, jmet = jax.jit(lambda p, t: jm.forward(p, t, run))(jp, jb["tokens"])
    (jval, jlmet), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, run), has_aux=True))(jp)

    tm = TModel(tc, device="cpu")
    tp = convert.from_jax(jp, tc)
    for t in tadamw.leaves(tp):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    run_t = RunState(gen=None, pol=None)
    tl, tmet = tm.forward(tp, tb["tokens"], run_t)
    assert _rel_to_max(np.asarray(jl)[..., :jc.vocab],
                       tl.detach().numpy()[..., :jc.vocab]) <= 1e-5
    for k in ("moe_aux_loss",) + MOE_AUX:
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(tmet["moe_lb_loss"]) > 0
    assert float(tmet["moe_z_loss"]) > 0
    tval, tlmet = tm.loss(tp, tb, run_t)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(float(tlmet["xent"].detach()),
                               float(jlmet["xent"]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(tval.detach()),
        float(tlmet["xent"].detach() + tlmet["moe_aux_loss"].detach()),
        rtol=1e-6)
    tval.backward()
    want = convert.from_jax(jax.tree.map(np.asarray, jgrad), tc)
    paths = []
    for (path, g), (_, t) in zip(float_leaves(want), float_leaves(tp)):
        paths.append(path)
        assert _rel_to_max(g.numpy(), t.grad.numpy()) <= 1e-5, path
    assert ("layers", 0, "moe", "router") in paths
    assert float(tp["layers"][0]["moe"]["router"].grad.abs().max()) > 0


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


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax(arch, container):
    """JAX prefill + stepwise greedy decode over a packed cache against the
    port's prefill, teacher-forced steps (``moe_decode`` over the batch
    as one group) and ``engine.generate``: the same greedy tokens."""
    jp, jc, tc = _params(arch)
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


TRACE = ["--requests", "8", "--kv-container", "sfp8", "--max-slots", "3",
         "--max-len", "256", "--num-blocks", "3", "--arrival-rate", "4",
         "--prompt-len-min", "90", "--prompt-len-max", "126",
         "--max-new-min", "16", "--max-new-max", "40", "--max-pending", "8"]


def _run(mod, eng, args, reqs):
    sched = mod.Scheduler(eng, max_pending=args.max_pending,
                          storm_guard=args.storm_guard)
    clock = {"t": 0.0}

    def now():
        clock["t"] += args.step_dt
        return clock["t"]
    return sched, sched.run(reqs, now_fn=now, burst=args.burst,
                            speculate=args.speculate)


def test_paged_trace_matches_jax():
    """A seeded 8-request trace (3 slots, a 3-block pool of 128-slot
    blocks: requests that cross a block boundary preempt others) through the paged engine and scheduler of
    each package on reduced olmoe: the same streams, results and stats.
    Decode routes every slot, idle ones too, as one MoE group, so the
    streams depend on the slots' occupancy, as JAX's do."""
    jp, jc, tc = _params("olmoe-1b-7b")
    jargs, targs = (m.build_parser().parse_args(
        ["--arch", "olmoe-1b-7b", "--trace"] + TRACE)
        for m in (jserve, tserve))
    kw = dict(max_slots=3, max_len=256, num_blocks=3)
    je = jengine.PagedEngine(JModel(jc, kv_container="sfp8"),
                             jax.tree.map(jnp.asarray, jp), **kw)
    te = engine.PagedEngine(TModel(tc, kv_container="sfp8", device="cpu"),
                            convert.from_jax(jp, tc), **kw)
    js, jout = _run(jsched, je, jargs, jserve.make_trace(jargs, jc.vocab))
    ts, tout = _run(tsched, te, targs, tserve.make_trace(targs, tc.vocab))
    assert sorted(jout) == sorted(tout)
    for uid in jout:
        np.testing.assert_array_equal(np.asarray(tout[uid]),
                                      np.asarray(jout[uid]))
    assert ts.stats.as_dict() == js.stats.as_dict()
    assert ts.stats.preemptions > 0 and ts.stats.finished > 0
    te.pool.verify_invariants()
    assert te.pool.used_blocks == 0


def test_decode_capacity_counts_idle_rows():
    """Decode capacity follows the batch, idle rows included: phi3.5's
    decode batch of 4 at full size has capacity 2 for 8 assignments over
    16 experts (it can drop), and the cut olmoe's is 2 over 2 or 3 rows
    (the paged trace's 3 slots)."""
    full = tconfigs.get("phi3.5-moe-42b-a6.6b")
    assert tmoe.capacity_for(full, 4) == 2
    _, _, tc = _params("olmoe-1b-7b")
    assert tmoe.capacity_for(tc, 3) == 2 and tmoe.capacity_for(tc, 2) == 2
