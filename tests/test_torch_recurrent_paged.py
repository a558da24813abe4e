"""The port's paged engine over recurrent state against the JAX package's,
on the CPU, in f32: mamba2-370m cut by ``reduced`` to 3 SSD layers and
recurrentgemma-9b at ``n_layers=5`` (one (rglru, rglru, local) period and
the 2-layer remainder), each with ``head_dim=128``: both packages' pools
take KV rows of whole 128-lane groups, even mamba2's, which has no
attention layer. JAX initialises the weights and ``repro_torch.convert``
hands them over.

A seeded 8-request trace (3 slots, a 3-block pool: requests preempt one
another; recurrentgemma's 32-slot window makes its rings wrap) runs
through each package's ``PagedEngine`` and ``Scheduler``: the same
streams and the same stats, at ``--burst 1`` and at ``--speculate 4``.
Random weights accept every draft, so a hook on the model instance biases
one token of some draft steps' logits, slot and position dependent: the
rounds then commit the recurrent state of every verify step (``n_emit``
from 1 to 4), and the port's streams, acceptances and ``n_emit`` must
equal JAX's and its own burst-1 streams.

This file holds mamba2's cases; ``test_torch_recurrent_paged_rg.py`` runs
the same tests for recurrentgemma (each JAX engine compiles its own steps,
so one file for both would run long on one worker).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models.model import DecoderModel as JModel
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import LOCAL, RGLRU, SSD
from repro_torch.configs.base import reduced as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.serve import engine
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import kvcache

torch.set_num_threads(2)

DEPTH = {"mamba2-370m": 3, "recurrentgemma-9b": 5}
K = 4
TRACE = ["--requests", "8", "--kv-container", "sfp8", "--max-slots", "3",
         "--max-len", "256", "--num-blocks", "3", "--arrival-rate", "4",
         "--prompt-len-min", "90", "--prompt-len-max", "126",
         "--max-new-min", "16", "--max-new-max", "40", "--max-pending", "8"]
ENGINE = dict(max_slots=3, max_len=256, num_blocks=3)
MODES = {"burst1": [], "spec4": ["--speculate", str(K)]}


@pytest.fixture(params=["mamba2-370m"])
def arch(request):
    return request.param


def _cfgs(arch):
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=DEPTH[arch]),
                                   dtype="float32", head_dim=128)
    return (cut(jconfigs.get(arch), jreduced),
            cut(tconfigs.get(arch), treduced))


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jc, tc = _cfgs(arch)
        jp = jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(0)))
        _PARAMS[arch] = jp, jc, tc
    return _PARAMS[arch]


def _engines(arch):
    jp, jc, tc = _params(arch)
    je = jengine.PagedEngine(JModel(jc, kv_container="sfp8"),
                             jax.tree.map(jnp.asarray, jp), **ENGINE)
    te = engine.PagedEngine(TModel(tc, kv_container="sfp8", device="cpu"),
                            convert.from_jax(jp, tc), **ENGINE)
    return je, te


def _run(mod, serve_mod, eng, arch, mode):
    args = serve_mod.build_parser().parse_args(
        ["--arch", arch, "--trace"] + TRACE + MODES[mode])
    sched = mod.Scheduler(eng, max_pending=args.max_pending,
                          storm_guard=args.storm_guard)
    clock = {"t": 0.0}

    def now():
        clock["t"] += args.step_dt
        return clock["t"]
    out = sched.run(serve_mod.make_trace(args, eng.cfg.vocab), now_fn=now,
                    burst=args.burst, speculate=args.speculate)
    return sched, {uid: [int(t) for t in toks] for uid, toks in out.items()}


def _finished_clean(sched, eng):
    assert sched.stats.preemptions > 0 and sched.stats.finished == 8
    eng.pool.verify_invariants()
    assert eng.pool.used_blocks == 0


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_trace_matches_jax(arch, mode):
    """The seeded preempting trace through both packages' engine and
    scheduler: the same streams, the same stats, the pool's invariants
    and no block held at the end."""
    je, te = _engines(arch)
    js, jout = _run(jsched, jserve, je, arch, mode)
    ts, tout = _run(tsched, tserve, te, arch, mode)
    assert tout == jout
    assert ts.stats.as_dict() == js.stats.as_dict()
    _finished_clean(ts, te)
    if mode == "spec4":
        assert ts.stats.spec_rounds > 0


def _force_rejections(model, xp):
    """Patch ``model``'s own ``decode_step_paged`` (the instance, not the
    class) so that a draft step (``prefix_planes`` set) puts 1e4 on token
    (31 p + 7 s) mod vocab of slot s at position p where (p + s) % 5 == 0:
    within a round of K = 4 steps the first such step falls at each of
    the offsets 0-4 as positions advance, so ``n_emit`` takes 1 to 4."""
    orig, vocab = model.decode_step_paged, model.cfg.vocab

    def biased(params, mem, tok, pos, tables, prefix_planes=None):
        logits, mem = orig(params, mem, tok, pos, tables,
                           prefix_planes=prefix_planes)
        if prefix_planes is None:
            return logits, mem
        s = xp.arange(tok.shape[0])
        hit = (pos + s) % 5 == 0
        target = (pos * 31 + s * 7) % vocab
        cols = xp.arange(logits.shape[-1])
        bias = ((cols[None, :] == target[:, None]) & hit[:, None]) * 1e4
        return logits + bias[:, None, :], mem
    model.decode_step_paged = biased


def _states(eng):
    """Each recurrent layer's state fields as numpy arrays (slots first),
    in layer order, from either package's engine."""
    if isinstance(eng, engine.PagedEngine):
        return [[t.numpy() for t in eng.mem["layers"][li]]
                for li in eng._recurrent]
    cfg, n = eng.cfg, len(eng.cfg.period)
    out = []
    kinds = list(cfg.period) * cfg.n_periods + list(cfg.remainder)
    for li, kind in enumerate(kinds):
        if kind not in (SSD, RGLRU):
            continue
        p, i = divmod(li, n)
        leaf = (eng.mem["periods"][f"slot{i}"] if p < cfg.n_periods
                else eng.mem["rem"][f"slot{li - cfg.n_periods * n}"])
        out.append([np.asarray(a[p] if p < cfg.n_periods else a)
                    for a in leaf])
    return out


def _record_rounds(eng):
    """Wrap ``eng.speculate`` (the instance): per round, the running slots'
    (position, accepted, n_emit) and their committed recurrent state."""
    orig, rounds, states = eng.speculate, [], []

    def recorded(toks, pos, K, draft_planes=None):
        out = orig(toks, pos, K, draft_planes)
        live = np.asarray(pos) > 0      # idle slots carry position 0
        rounds.append([(int(p), int(a), int(n)) for p, a, n, on in zip(
            pos, np.asarray(out[2]), np.asarray(out[3]), live) if on])
        states.append([[f[live] for f in layer] for layer in _states(eng)])
        return out
    eng.speculate = recorded
    return rounds, states


def test_forced_rejections_commit_the_verified_state(arch):
    """Drafts rejected at varied steps: the port's streams, acceptances and
    n_emit equal JAX's round for round, n_emit takes every value from 1 to
    K, and the streams equal the port's own burst-1 streams, so each
    commit kept the recurrent state (and ring) of verify step n_emit - 1.
    The running slots' committed state equals JAX's after every round,
    each field within 1e-4 of its largest element (the streams alone
    would not see a wrong state: a random tied head keeps the fed token's
    own logit on top)."""
    je, te = _engines(arch)
    _force_rejections(je.model, jnp)
    _force_rejections(te.model, torch)
    (jrounds, jstates), (trounds, tstates) = (_record_rounds(je),
                                              _record_rounds(te))
    js, jout = _run(jsched, jserve, je, arch, "spec4")
    ts, tout = _run(tsched, tserve, te, arch, "spec4")
    assert tout == jout and trounds == jrounds
    for r, (jst, tst) in enumerate(zip(jstates, tstates)):
        for j, (jl, tl) in enumerate(zip(jst, tst)):
            for a, b in zip(tl, jl):
                gap = np.abs(a - b).max(initial=0.0)
                assert gap <= 1e-4 * np.abs(b).max(initial=1e-30), (r, j)
    assert ts.stats.as_dict() == js.stats.as_dict()
    assert {n for r in trounds for _, _, n in r} == set(range(1, K + 1))
    assert 0 < ts.stats.draft_accepted < ts.stats.drafted
    _finished_clean(ts, te)
    _, te1 = _engines(arch)
    _, base = _run(tsched, tserve, te1, arch, "burst1")
    assert tout == base


def _state_bytes(cfg, kind, S):
    """Bytes of one recurrent layer's S-slot state, from the config: the
    conv tails in the compute dtype, the state in f32."""
    c = torch.finfo(cfg.compute_dtype).bits // 8
    if kind == SSD:
        gn = cfg.ssm_groups * cfg.ssm_state
        return S * ((cfg.conv_width - 1) * (cfg.d_inner + 2 * gn) * c
                    + cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4)
    return S * cfg.lru_width_ * ((cfg.conv_width - 1) * c + 4)


def test_engine_without_paged_layers(arch):
    """No GLOBAL layer: every checksum is zero, ``verify_blocks`` finds
    nothing, ``scrub_block`` runs, ``corrupt_block`` raises (JAX divides by
    zero there), and ``cache_bytes`` counts the rings and the states: an
    sfp8 ring row holds a byte a lane and a base a 128-lane group, K and
    V."""
    _, te = _engines(arch)
    cfg, S = te.cfg, te.max_slots
    assert te.n_global_layers == 0 and te.block_bytes == 0
    sums = te.block_checksums()
    assert sums.shape == (te.pool.num_blocks + 1,) and not sums.any()
    assert te.verify_blocks([1, 2, 3]) == []
    te.scrub_block(2)
    te.refresh_checksums([1, 2])
    assert not te.expected_sums.any()
    with pytest.raises(ValueError, match="no paged"):
        te.corrupt_block(1)
    D = cfg.n_kv_heads * cfg.head_dim_
    L = kvcache.cache_len(cfg, LOCAL, te.max_len)
    want = 0
    for kind in te.model.kinds:
        want += (2 * S * L * (D + D // 128) if kind == LOCAL
                 else _state_bytes(cfg, kind, S))
    assert te.cache_bytes()["total"] == want
    assert set(te.model.kinds) <= {SSD, RGLRU, LOCAL}


@pytest.mark.parametrize("mode", list(MODES))
def test_launch_serve_trace_on_cpu(monkeypatch, arch, mode):
    """``launch.serve --trace --preset tiny --device cpu``: the cut's KV
    heads widened to one 128-lane group (``paged_heads``), every request
    finished."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = tserve.run_trace(tserve.build_parser().parse_args(
        ["--arch", arch, "--preset", "tiny", "--trace", "--requests", "6",
         "--kv-container", "sfp8", "--max-slots", "3", "--num-blocks", "3",
         "--device", "cpu"] + MODES[mode]))
    assert rep["finished_ok"] == 6 and rep["failed"] == 0
    assert rep["emitted_tokens"] > 0
    if mode == "spec4":
        assert rep["spec_rounds"] > 0


def test_degraded_container_refused(arch):
    """A block of no paged layer is 0 bytes at any geometry, so no
    degraded container is narrower: both packages refuse it."""
    jp, jc, tc = _params(arch)
    with pytest.raises(ValueError, match="not narrower"):
        jengine.PagedEngine(JModel(jc, kv_container="sfp8"),
                            jax.tree.map(jnp.asarray, jp),
                            degraded_container="sfp-m2e4", **ENGINE)
    with pytest.raises(ValueError, match="not narrower"):
        engine.PagedEngine(TModel(tc, kv_container="sfp8", device="cpu"),
                           convert.from_jax(jp, tc),
                           degraded_container="sfp-m2e4", **ENGINE)
