"""The port's continuous-batching server against the JAX package's: the
paged engine (prefill into slots, decode, bursts, self-speculation, block
checksums), the scheduler on one seeded trace, fault recovery and the
``launch.serve --trace`` report.

Model: gemma2-2b reduced to 4 layers (2 local/global periods, so the
checksums sum two stacked GLOBAL layers), d_model 128, 4 query heads over
2 KV heads of 64, window 32 (prompts wrap the local ring), f32. JAX
initialises the weights and ``repro_torch.convert`` hands them over. The
JAX side runs its ``ref`` backend; its reads and the port's plain versions
differ by f32 rounding only, so streams and scheduler decisions must be
identical (a greedy stream could differ only at a top-2 margin of about
1e-5, which these seeds do not reach). The packed bytes can differ: a K
value that one framework rounds to 2^k and the other to the f32 just
below packs to another word (one byte of 1.2M after these prefills), so
the engine's block checksums are held bit for bit to JAX's checksum
function over the port's own pool.
"""
import dataclasses
import json

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
from repro.serve import faults as jfaults
from repro.serve import kvcache as jkv
from repro.serve import precision as jprecision
from repro.serve import scheduler as jsched
from repro_torch import configs as tconfigs, convert
from repro_torch.configs.base import reduced as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models.model import DecoderModel as TModel
from repro_torch.serve import engine as tengine
from repro_torch.serve import faults as tfaults
from repro_torch.serve import precision as tprecision
from repro_torch.serve import scheduler as tsched

torch.set_num_threads(1)


def _cfgs():
    def cut(c, reduced):
        return dataclasses.replace(reduced(c, n_layers=4), n_heads=4,
                                   n_kv_heads=2, head_dim=64,
                                   dtype="float32")
    return (cut(jconfigs.get("gemma2-2b"), jreduced),
            cut(tconfigs.get("gemma2-2b"), treduced))


_MODELS = {}


def _models(container):
    """(JAX model, params), (port model, params) with the same weights."""
    if container not in _MODELS:
        jcfg, tcfg = _cfgs()
        jm = JModel(jcfg, kv_container=container)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = TModel(tcfg, kv_container=container, device="cpu")
        tp = convert.from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _MODELS[container] = ((jm, jp), (tm, tp))
    return _MODELS[container]


def _engines(container, **kw):
    (jm, jp), (tm, tp) = _models(container)
    return (jengine.PagedEngine(jm, jp, **kw),
            tengine.PagedEngine(tm, tp, **kw))


def _trace_args(argv):
    """The same seeded trace from both launchers' parsers."""
    base = ["--arch", "gemma2-2b", "--trace"] + argv
    return jserve.build_parser().parse_args(base), \
        tserve.build_parser().parse_args(base)


def _run(mod, eng, args, reqs, **run_kw):
    """One trace through ``mod``'s Scheduler on the virtual clock."""
    pressure = None
    if args.degraded_container:
        pm = jprecision if mod is jsched else tprecision
        pressure = pm.PressureController(low=args.pressure_low,
                                         high=args.pressure_high)
    sched = mod.Scheduler(eng, max_pending=args.max_pending,
                          storm_guard=args.storm_guard, pressure=pressure)
    clock = {"t": 0.0}

    def now():
        clock["t"] += args.step_dt
        return clock["t"]

    out = sched.run(reqs, now_fn=now, burst=args.burst,
                    speculate=args.speculate, **run_kw)
    return sched, out


def _jax_sums(te):
    """JAX's per-block checksums of the port engine's pool: each GLOBAL
    entry's layers stacked as JAX stacks the periods, salt = entry + 1."""
    total = np.zeros(te.pool.num_blocks + 1, np.uint32)
    for j, entry in enumerate(te._global_entries()):
        stacked = jkv.PagedKV(*(
            jnp.stack([jnp.asarray(te.mem["layers"][li][f].numpy())
                       for li in entry]) for f in range(4)))
        total = total + np.asarray(jkv.paged_block_checksums(stacked,
                                                             salt=j + 1))
    return total


def _same_runs(js, jout, ts, tout):
    assert sorted(jout) == sorted(tout)
    for uid in jout:
        np.testing.assert_array_equal(np.asarray(tout[uid]),
                                      np.asarray(jout[uid]))
    assert ts.stats.as_dict() == js.stats.as_dict()
    assert ({u: (r.status, r.tokens.tolist(), r.container, r.recoveries,
                 r.drafted, r.draft_accepted) for u, r in ts.results.items()}
            == {u: (r.status, np.asarray(r.tokens).tolist(), r.container,
                    r.recoveries, r.drafted, r.draft_accepted)
                for u, r in js.results.items()})


# -- the engine ------------------------------------------------------------


def test_engine_prefill_decode_burst_speculate():
    """Three prompts prefilled into slots 0, 2 and 3 (slot 1 idle on the
    trash block) of an sfp8 pool, then single steps, a 3-step burst and
    two speculative rounds: the same tokens, flags, acceptance and
    checksum bookkeeping as the JAX engine (the dense pool is served in
    ``test_speculate_trace_matches_jax_and_burst``)."""
    je, te = _engines("sfp8", max_slots=4, max_len=256)
    rng = np.random.RandomState(1)
    prompts = {0: 40, 2: 127, 3: 9}
    toks = np.zeros(4, np.int32)
    pos = np.zeros(4, np.int32)
    for slot, n in prompts.items():
        prompt = rng.randint(0, 512, n).astype(np.int32)
        for e in (je, te):
            assert e.pool.alloc_upto(slot, n + 12)
        toks[slot] = je.prefill_into_slot(slot, prompt)
        assert te.prefill_into_slot(slot, prompt) == toks[slot]
        pos[slot] = n
    np.testing.assert_array_equal(te.pool.tables, je.pool.tables)
    np.testing.assert_array_equal(te.block_checksums(), _jax_sums(te))
    live = [s for s in prompts]
    for _ in range(2):
        (jt, jb), (tt, tb) = je.decode(toks, pos), te.decode(toks, pos)
        np.testing.assert_array_equal(tt[live], jt[live])
        assert not tb.any() and not np.asarray(jb).any()
        toks = np.where(pos > 0, tt, 0).astype(np.int32)
        pos = np.where(pos > 0, pos + 1, 0).astype(np.int32)
    (jt, _), (tt, _) = (je.decode_burst(toks, pos, 3),
                        te.decode_burst(toks, pos, 3))
    np.testing.assert_array_equal(tt[:, live], np.asarray(jt)[:, live])
    toks = np.where(pos > 0, tt[-1], 0).astype(np.int32)
    pos = np.where(pos > 0, pos + 3, 0).astype(np.int32)
    dp = te.default_draft_planes()
    assert dp == je.default_draft_planes()
    for _ in range(2):
        jr = je.speculate(toks, pos, 3)
        tr = te.speculate(toks, pos, 3)
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(np.asarray(a)[..., live],
                                          np.asarray(b)[..., live])
        n_emit = tr[3]
        toks = np.where(pos > 0, tr[0][n_emit - 1, np.arange(4)], 0
                        ).astype(np.int32)
        pos = np.where(pos > 0, pos + n_emit, 0).astype(np.int32)
    ids = te.pool.owned_ids()
    te.refresh_checksums(ids)
    np.testing.assert_array_equal(te.expected_sums[ids], _jax_sums(te)[ids])
    assert te.verify_blocks(ids) == []
    je.refresh_checksums(ids)
    for e in (je, te):
        e.corrupt_block(ids[1], layer=1, field=2, row=300, col=77, bit=5)
    assert te.verify_blocks(ids) == je.verify_blocks(ids) == [ids[1]]
    for e in (je, te):
        e.scrub_block(ids[1])
    np.testing.assert_array_equal(te.block_checksums(), _jax_sums(te))
    assert not any(t[ids[1]].any() for i in te._global_entries()[0]
                   for t in te.mem["layers"][i])
    assert te.decode_steps == je.decode_steps == 2 + 3 + 2 * 2 * 3


def test_engine_rejects_unpageable_and_bad_knobs():
    (jm, jp), (tm, tp) = _models("sfp8")
    for container in ("gecko8", "bit_exact"):
        model = TModel(tm.cfg, kv_container=container, device="cpu")
        with pytest.raises(ValueError, match="fixed-width payload"):
            tengine.PagedEngine(model, tp, max_slots=1, max_len=128)
    with pytest.raises(ValueError, match="kv_container"):
        tengine.PagedEngine(TModel(tm.cfg, device="cpu"), tp)
    eng = tengine.PagedEngine(tm, tp, max_slots=1, max_len=128)
    for bad in (5, 9):
        with pytest.raises(ValueError):
            eng.validate_draft_planes(bad)
    with pytest.raises(ValueError, match="not narrower"):
        tengine.PagedEngine(tm, tp, max_slots=1, max_len=128,
                            degraded_container="sfp16")
    with pytest.raises(ValueError):
        tsched.Scheduler(eng).run([tsched.Request(
            uid=0, prompt=np.arange(4, dtype=np.int32), max_new=2)],
            speculate=0)


# -- the scheduler -----------------------------------------------------------

# Twelve requests at 4 per virtual second on a 3-block budget (sfp8, four
# slots, two blocks each): prompts of 90-126 tokens cross the block edge
# while decoding, so running requests are preempted; the queue bound of 4
# sheds, a 5 s deadline expires requests, and with free bytes under half
# the budget new admissions are downshifted to sfp-m1e2.
TRACE = ["--requests", "12", "--kv-container", "sfp8", "--max-slots", "4",
         "--max-len", "256", "--num-blocks", "3", "--arrival-rate", "4",
         "--prompt-len-min", "90", "--prompt-len-max", "126",
         "--max-new-min", "16", "--max-new-max", "48", "--deadline", "5",
         "--max-pending", "4", "--degraded-container", "sfp-m1e2",
         "--pressure-low", "0.5", "--pressure-high", "0.8"]


def test_scheduler_trace_matches_jax():
    jargs, targs = _trace_args(TRACE)
    kw = dict(max_slots=4, max_len=256, num_blocks=3,
              degraded_container="sfp-m1e2")
    je, te = _engines("sfp8", **kw)
    vocab = _cfgs()[1].vocab
    js, jout = _run(jsched, je, jargs, jserve.make_trace(jargs, vocab))
    ts, tout = _run(tsched, te, targs, tserve.make_trace(targs, vocab))
    _same_runs(js, jout, ts, tout)
    s = ts.stats
    assert (s.preemptions > 0 and s.shed > 0 and s.deadline_misses > 0
            and s.downshifted > 0 and s.finished > 0)
    te.pool.verify_invariants()
    assert te.pool.used_blocks == 0


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
def test_speculate_trace_matches_jax_and_burst(container):
    """--speculate 3 over a preempting trace: the same streams and stats
    as the JAX scheduler, and the same streams as --burst 1."""
    argv = ["--requests", "3", "--kv-container", container, "--max-slots",
            "3", "--max-len", "256", "--num-blocks", "3", "--arrival-rate",
            "4", "--prompt-len-min", "112", "--prompt-len-max", "126",
            "--max-new-min", "8", "--max-new-max", "20"]
    kw = dict(max_slots=3, max_len=256, num_blocks=3)
    vocab = _cfgs()[1].vocab
    jargs, targs = _trace_args(argv + ["--speculate", "3"])
    je, te = _engines(container, **kw)
    js, jout = _run(jsched, je, jargs, jserve.make_trace(jargs, vocab))
    ts, tout = _run(tsched, te, targs, tserve.make_trace(targs, vocab))
    _same_runs(js, jout, ts, tout)
    assert ts.stats.spec_rounds > 0 and ts.stats.preemptions > 0
    _, b1 = _trace_args(argv)
    te1 = tengine.PagedEngine(*_models(container)[1], **kw)
    _, out1 = _run(tsched, te1, b1, tserve.make_trace(b1, vocab))
    assert sorted(out1) == sorted(tout)
    for uid in out1:
        np.testing.assert_array_equal(out1[uid], tout[uid])


def test_rejected_drafts_roll_back_to_the_burst_1_state():
    """Drafts sabotaged at random (40% of draft tokens replaced) force
    rejections at every depth: the committed ring state after verify step
    n_emit - 1 and the pool must still give the --burst 1 streams."""
    argv = ["--requests", "3", "--kv-container", "sfp8", "--max-slots", "3",
            "--max-len", "256", "--num-blocks", "3", "--arrival-rate", "4",
            "--prompt-len-min", "20", "--prompt-len-max", "60",
            "--max-new-min", "10", "--max-new-max", "16"]
    vocab = _cfgs()[1].vocab
    kw = dict(max_slots=3, max_len=256, num_blocks=3)
    model, params = _models("sfp8")[1]
    _, b1 = _trace_args(argv)
    _, out1 = _run(tsched, tengine.PagedEngine(model, params, **kw), b1,
                   tserve.make_trace(b1, vocab))
    _, sp = _trace_args(argv + ["--speculate", "4"])
    eng = tengine.PagedEngine(model, params, **kw)
    step, rng = eng._step, np.random.RandomState(0)

    def sabotaged(tables, tok, pos, prefix_planes=None):
        nxt, bad = step(tables, tok, pos, prefix_planes)
        if prefix_planes is not None:
            flip = torch.as_tensor(rng.rand(nxt.shape[0]) < 0.4)
            nxt = torch.where(flip, (nxt + 1) % vocab, nxt)
        return nxt, bad

    eng._step = sabotaged
    sched, out = _run(tsched, eng, sp, tserve.make_trace(sp, vocab))
    s = sched.stats
    assert 0 < s.draft_accepted < s.drafted
    assert sorted(out) == sorted(out1)
    for uid in out1:
        np.testing.assert_array_equal(out[uid], out1[uid])


# -- faults ------------------------------------------------------------------


def _first_decode_flip(inj, fired):
    """A fault hook that flips one seeded bit before the first scheduler
    step that has blocks allocated (the first step whose decode reads a
    block written earlier), and records that it fired."""
    def hook(step):
        inj._step = step
        if not fired and inj.engine.pool.owned_ids():
            fired.append(inj.flip_random_bit(step))
    return hook


@pytest.mark.parametrize("speculate", [None, 3])
def test_bitflip_recovery_matches_fault_free_and_jax(speculate):
    """A bit flipped in an allocated block is caught by the checksums,
    the block quarantined and the owner recomputed: every stream equals
    the fault-free run, and the port and JAX agree on the flip and on
    every count."""
    argv = ["--requests", "3", "--kv-container", "sfp8", "--max-slots",
            "3", "--max-len", "256", "--prompt-len-min", "8",
            "--prompt-len-max", "40", "--max-new-min", "8",
            "--max-new-max", "16", "--flood"]
    if speculate:
        argv += ["--speculate", str(speculate)]
    jargs, targs = _trace_args(argv)
    vocab = _cfgs()[1].vocab
    kw = dict(max_slots=3, max_len=256)
    te0 = tengine.PagedEngine(*_models("sfp8")[1], **kw)
    _, clean = _run(tsched, te0, targs, tserve.make_trace(targs, vocab))
    runs = []
    for mod, fmod in ((jsched, jfaults), (tsched, tfaults)):
        je, te = _engines("sfp8", **kw)
        eng = je if mod is jsched else te
        args = jargs if mod is jsched else targs
        inj = fmod.FaultInjector(eng, seed=3)
        fired = []
        sched, out = _run(mod, eng, args,
                          (jserve if mod is jsched else tserve).make_trace(
                              args, vocab),
                          fault_hook=_first_decode_flip(inj, fired))
        assert fired and fired[0] is not None, "the fault hook never fired"
        runs.append((sched, out, [e.detail for e in inj.events]))
    (js, jout, jev), (ts, tout, tev) = runs
    assert tev == jev
    assert ts.stats.corrupt_blocks >= 1 and ts.stats.recoveries >= 1
    _same_runs(js, jout, ts, tout)
    assert sorted(tout) == sorted(clean)
    for uid in clean:
        np.testing.assert_array_equal(tout[uid], clean[uid])


def test_poisoned_bases_trip_the_nan_guard():
    """With integrity off, bases forced to 0xFF decode to non-finite
    values: the logit guard quarantines and recovers, as in JAX."""
    argv = ["--requests", "2", "--kv-container", "sfp8", "--max-slots",
            "2", "--max-len", "128", "--prompt-len-min", "8",
            "--prompt-len-max", "20", "--max-new-min", "6",
            "--max-new-max", "8", "--flood", "--no-integrity"]
    jargs, targs = _trace_args(argv)
    vocab = _cfgs()[1].vocab
    counts = []
    for mod, fmod, smod, args in ((jsched, jfaults, jserve, jargs),
                                  (tsched, tfaults, tserve, targs)):
        (jm, jp), (tm, tp) = _models("sfp8")
        model, params = (jm, jp) if mod is jsched else (tm, tp)
        eng = (jengine if mod is jsched else tengine).PagedEngine(
            model, params, max_slots=2, max_len=128, integrity=False)
        inj = fmod.FaultInjector(eng, seed=0)
        done = []

        def hook(step, inj=inj, eng=eng, done=done):
            owned = eng.pool.owned_ids()
            if not done and owned:
                inj.poison_block_bases(owned[0], step=step)
                done.append(owned[0])

        sched, out = _run(mod, eng, args, smod.make_trace(args, vocab),
                          fault_hook=hook)
        assert done
        counts.append((sched.stats.as_dict(), {u: t.tolist() if hasattr(
            t, "tolist") else list(t) for u, t in out.items()}))
    assert counts[0][0]["nan_guard_trips"] >= 1
    assert counts[1] == counts[0]


# -- the launcher ------------------------------------------------------------


def test_launch_serve_trace_report_matches_jax_keys(capsys, tmp_path):
    """``launch.serve --trace --device cpu`` prints the JAX launcher's
    report (plus the device it ran on) and writes the token streams."""
    argv = ["--arch", "gemma2-2b", "--preset", "tiny", "--trace",
            "--requests", "3", "--kv-container", "sfp8", "--max-slots", "2",
            "--max-len", "128", "--prompt-len-max", "16", "--max-new-max",
            "6", "--speculate", "2"]
    jserve.run_trace(jserve.build_parser().parse_args(argv))
    want = json.loads(capsys.readouterr().out)
    out = tmp_path / "tokens.json"
    got = tserve.run_trace(tserve.build_parser().parse_args(
        argv + ["--device", "cpu", "--tokens-out", str(out)]))
    printed = json.loads(capsys.readouterr().out)
    assert printed == got
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu" and got["requests"] == 3
    streams = json.loads(out.read_text())
    assert sum(len(v) for v in streams.values()) == got["emitted_tokens"]
