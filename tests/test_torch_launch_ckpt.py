"""The port's checkpointing launchers on the CPU, against the JAX ones.

``repro_torch.launch.train --preset tiny --policy qm --container sfp8
--steps 3 --ckpt-dir D --ckpt-every 2`` with ``--metrics``,
``--metrics-out``, ``--trace-out`` and ``--timeline-out`` beside
``repro.launch.train`` with the same arguments, from one initial state
(JAX's, through ``convert.state_from_jax``) and with the stochastic draws
of both sides replaced by the ceiling of the learned bits: both write
telemetry that passes both packages' ``obs.validate``, the same timeline
entries, the same checkpoint steps and manifest ``extra``, losses within
the bf16 training tolerance (rtol 1e-3, ROADMAP §C); and ``--policy-ckpt``
picks the same container in both serving launchers. Then restore-and-
continue on the reduced gemma2-2b (2 layers): a fault at step 3 with a
checkpoint every 2 steps gives the uninterrupted run's losses bit for bit,
and JAX's loop with the same fault within the training tolerance;
``container_from_checkpoint`` on JAX's three cases over checkpoints of
both managers; and the launchers' default device.
"""
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import containers as jcontainers
from repro.data import synthetic as jsynthetic
from repro.launch import serve as jserve
from repro.launch import train as jlaunch
from repro.obs import validate as jvalidate
from repro.serve import precision as jprecision
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import codecs as tcodecs
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import containers as tcontainers
from repro_torch.data import synthetic as tsynthetic
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.obs import validate as tvalidate
from repro_torch.serve import precision as tprecision
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

torch.set_num_threads(2)

ARGV = ["--arch", "gemma2-2b", "--preset", "tiny", "--policy", "qm",
        "--container", "sfp8", "--steps", "3", "--ckpt-every", "2",
        "--timeline-every", "1"]
OBS_FLAGS = (("--metrics", "events.jsonl"), ("--metrics-out", "m.prom"),
             ("--trace-out", "trace.json"),
             ("--timeline-out", "timeline.jsonl"))


def _j_draw(n_float, key, max_bits, min_bits=0):
    nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                  float(max_bits))
    return jnp.ceil(nf).astype(jnp.int32)


def _t_draw(n_float, generator, max_bits, min_bits=0, shape=None):
    nf = torch.clamp(n_float.detach().float(), float(min_bits),
                     float(max_bits))
    n = torch.ceil(nf).to(torch.int32)
    return n if shape is None else n.expand(tuple(shape)).clone()


@pytest.fixture
def ceil_draws(monkeypatch):
    monkeypatch.setattr(jcontainers, "stochastic_bitlength", _j_draw)
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", _t_draw)


def _jax_state0(argv):
    jargs = jlaunch.build_parser().parse_args(argv)
    _, jmodel, jtc, _, _ = jlaunch.build(jargs)
    return jax.tree.map(np.asarray, jstep.init_state(
        jmodel, jax.random.PRNGKey(jargs.seed), jtc))


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _validate(mod, d):
    return mod.main(["--metrics", str(d / "m.prom"),
                     "--trace", str(d / "trace.json"),
                     "--timeline", str(d / "timeline.jsonl"),
                     "--events", str(d / "events.jsonl")])


@pytest.fixture
def both_runs(tmp_path, monkeypatch, ceil_draws, capsys):
    """The JAX and the port launcher over the same arguments; returns the
    two output directories."""
    out = {}
    js0 = _jax_state0(ARGV)
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        argv = ARGV + ["--ckpt-dir", str(d / "ckpt")] + [
            x for flag, name in OBS_FLAGS for x in (flag, str(d / name))]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["train"] + argv)
            jlaunch.main()
        else:
            monkeypatch.setattr(tstep, "init_state", lambda model, seed, tc:
                                convert.state_from_jax(js0, model.cfg))
            tlaunch.main(argv + ["--device", "cpu"])
        out[side] = d
    capsys.readouterr()
    return out


def test_launcher_checkpoints_and_telemetry_match_jax(both_runs):
    jd, td = both_runs["jax"], both_runs["port"]
    # Telemetry passes both packages' validators, either way round.
    for d in (jd, td):
        for mod in (jvalidate, tvalidate):
            assert _validate(mod, d) == 0, (d, mod.__name__)
    # The timeline: one entry a step (--timeline-every 1) and one at the
    # end, each with the per-layer decisions.
    jt, tt = _lines(jd / "timeline.jsonl"), _lines(td / "timeline.jsonl")
    assert [e["step"] for e in tt] == [e["step"] for e in jt] == [0, 1, 2, 3]
    assert [e["layers"] for e in tt] == [e["layers"] for e in jt]
    # The event stream: the same metric lines and checkpoint events.
    je, te = _lines(jd / "events.jsonl"), _lines(td / "events.jsonl")
    assert [(e.get("event"), e["step"]) for e in te] == [
        (e.get("event"), e["step"]) for e in je] == [
        (None, 0), (None, 1), ("checkpoint", 2), (None, 2)]
    for a, b in zip(te, je):
        for k in ("loss", "xent", "grad_norm"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3,
                                           err_msg=(a["step"], k))
    # The Prometheus text carries the loop's families.
    prom = (td / "m.prom").read_text()
    for fam in ("train_step_seconds", "train_step_failures_total",
                "train_straggler_steps_total"):
        assert f"# TYPE {fam}" in prom
    assert 'train_step_seconds_count 3' in prom
    trace = json.loads((td / "trace.json").read_text())
    assert sum(e["name"] == "train_step" for e in trace["traceEvents"]) == 3
    # Checkpoints: the async save at step 2, the final one at 3, and the
    # same stamped extra.
    jm, tm = JManager(str(jd / "ckpt")), CheckpointManager(str(td / "ckpt"))
    assert tm.all_steps() == jm.all_steps() == [2, 3]
    for s in (2, 3):
        assert tm.read_extra(s) == jm.read_extra(s)
    assert tm.read_extra(3) == {"policy": "qm", "container": "sfp8",
                                "decision": {"man_bits": 7.0,
                                             "exp_bits": 8.0}}


def test_policy_ckpt_picks_the_same_container_in_both_launchers(
        both_runs, capsys):
    names = set()
    for d in both_runs.values():
        ck = str(d / "ckpt")
        assert (tprecision.container_from_checkpoint(ck)
                == jprecision.container_from_checkpoint(ck) == "sfp-m7e7")
        jargs = jserve.build_parser().parse_args(
            ["--arch", "gemma2-2b", "--preset", "tiny", "--kv-container",
             "sfp8", "--policy-ckpt", ck])
        targs = tserve.build_parser().parse_args(
            ["--arch", "gemma2-2b", "--preset", "tiny", "--kv-container",
             "sfp8", "--policy-ckpt", ck, "--device", "cpu"])
        _, _, _, jname = jserve._build_model(jargs)
        jout = capsys.readouterr().out
        _, model, _ = tserve.build_model(targs)
        tout = capsys.readouterr().out
        assert model.kv_container == jname
        assert tout == jout == (f"policy-aware container from {ck}: "
                                f"{jname}\n")
        names.add(jname)
    assert names == {"sfp-m7e7"}


def test_policy_ckpt_serves_the_derived_container(both_runs, capsys):
    report = tserve.main([
        "--arch", "gemma2-2b", "--preset", "tiny", "--batch", "2",
        "--prompt-len", "8", "--max-new", "3", "--device", "cpu",
        "--policy-ckpt", str(both_runs["port"] / "ckpt")])
    out = capsys.readouterr().out
    assert "policy-aware container" in out
    assert json.loads(out.splitlines()[-1])["kv"] == "sfp-m7e7"
    assert report is None


# -- container_from_checkpoint: JAX's three cases, both managers ------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_container_from_checkpoint_cases(tmp_path, writer):
    mgr_cls = JManager if writer == "jax" else CheckpointManager
    state = ({"w": np.zeros((2, 2), np.float32)} if writer == "jax"
             else {"w": torch.zeros((2, 2))})
    cases = {"stamped": ({"policy": "qm+qe", "container": "sfp8",
                          "decision": {"man_bits": 4.2, "exp_bits": 5.6}},
                         "sfp-m5e6"),
             "legacy": ({"policy": "qm", "container": "sfp16"}, "sfp16"),
             "bare": (None, tcodecs.DEFAULT_CONTAINER)}
    for name, (extra, want) in cases.items():
        mgr_cls(str(tmp_path / name)).save(1, state, extra=extra)
        for prec in (jprecision, tprecision):
            assert prec.container_from_checkpoint(str(tmp_path / name)) \
                == want, (name, prec.__name__)
    f = tcodecs.get("sfp-m5e6").pack_fields(torch.float32)
    assert (f.payload_bits, f.man_keep, f.dexp_bits, f.dense) == (12, 5, 6,
                                                                  True)
    for prec in (jprecision, tprecision):
        with pytest.raises(FileNotFoundError):
            prec.container_from_checkpoint(str(tmp_path / "empty"))
        assert prec.decision_from_extra({"decision": {"man_bits": "x"}}) \
            is None
        assert prec.decision_from_extra({"decision": [1, 2]}) is None
        assert prec.decision_from_extra(
            {"decision": {"man_bits": 3, "exp_bits": "4.5"}}) == {
            "man_bits": 3.0, "exp_bits": 4.5}


# -- restore-and-continue on the reduced gemma2-2b ---------------------------


FAULT_STEP, STEPS = 3, 5
LOOP_ARGV = ["--arch", "gemma2-2b", "--preset", "tiny", "--policy", "qm",
             "--container", "sfp8", "--steps", str(STEPS)]


def _fault():
    fired = []

    def hook(step):
        if step == FAULT_STEP and not fired:
            fired.append(step)
            raise RuntimeError("simulated node failure")
    return hook, fired


def _losses(history):
    """The last record of each step (a replayed step supersedes)."""
    return {h["step"]: h for h in history}


def test_fault_and_resume_bit_equal_and_match_jax(tmp_path, ceil_draws):
    js0 = _jax_state0(LOOP_ARGV)
    args = tlaunch.build_parser().parse_args(LOOP_ARGV + ["--device", "cpu"])
    cfg, model, tc, batch, seq = tlaunch.build(args)
    step_fn = tstep.make_train_step(model, tc)
    dcfg = tsynthetic.SyntheticConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch, seed=0)

    def batches(start):
        for b in tsynthetic.batches(dcfg, start):
            yield {k: torch.from_numpy(v).long() for k, v in b.items()}

    def run(total, ckdir=None, fault=None):
        lc = tloop.LoopConfig(total_steps=total, ckpt_every=2, log_every=1,
                              ckpt_dir=None if ckdir is None else str(ckdir))
        return tloop.run(step_fn, convert.state_from_jax(js0, cfg), batches,
                         lc, fault_hook=fault, device="cpu")

    ref = run(STEPS)
    hook, fired = _fault()
    faulted = run(STEPS, tmp_path / "fault", hook)
    assert fired == [FAULT_STEP] and faulted.restarts == 1
    assert [h["step"] for h in faulted.history] == [0, 1, 2, 2, 3, 4]
    run(2, tmp_path / "resume")
    resumed = run(STEPS, tmp_path / "resume")
    assert [h["step"] for h in resumed.history] == [2, 3, 4]
    want = _losses(ref.history)
    for res in (faulted, resumed):
        got = _losses(res.history)
        for s in got:
            for k in ("loss", "grad_norm", "qm_act_mean", "qm_w_mean"):
                assert got[s][k] == want[s][k], (s, k)
        for a, b in zip(tlaunch.adamw.leaves(res.state.params),
                        tlaunch.adamw.leaves(ref.state.params)):
            assert torch.equal(a, b)
    # JAX's loop with the same fault on JAX's step.
    jargs = jlaunch.build_parser().parse_args(LOOP_ARGV)
    _, jmodel, jtc, _, _ = jlaunch.build(jargs)
    jstep_fn = jax.jit(jstep.make_train_step(jmodel, jtc),
                       donate_argnums=(0,))
    jdcfg = jsynthetic.SyntheticConfig(vocab=cfg.vocab, seq_len=seq,
                                       global_batch=batch, seed=0)

    def jbatches(start):
        return ({k: jnp.asarray(v) for k, v in b.items()}
                for b in jsynthetic.batches(jdcfg, start))

    jhook, jfired = _fault()
    jres = jloop.run(jstep_fn, jax.tree.map(jnp.asarray, js0), jbatches,
                     jloop.LoopConfig(total_steps=STEPS, ckpt_every=2,
                                      ckpt_dir=str(tmp_path / "jax")),
                     fault_hook=jhook)
    assert jfired == [FAULT_STEP] and jres.restarts == 1
    assert [h["step"] for h in jres.history] == [
        h["step"] for h in faulted.history]
    for a, b in zip(faulted.history, jres.history):
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3,
                                       err_msg=(a["step"], k))
        np.testing.assert_allclose(a["qm_act_mean"], b["qm_act_mean"],
                                   atol=1e-3)


def test_per_layer_segments_restore_their_checkpoints(tmp_path, capsys,
                                                      monkeypatch):
    """With --ckpt-dir, each per-layer segment after the first restores the
    checkpoint the previous one saved (as the JAX launcher does), which
    changes nothing: the losses equal a run without checkpoints, and
    --stash-refresh defaults to --ckpt-every."""
    argv = ["--arch", "gemma2-2b", "--preset", "tiny", "--policy", "qm",
            "--container", "sfp8", "--per-layer-stash", "--steps", "4",
            "--ckpt-every", "2", "--device", "cpu"]
    restores, segments = [], []
    restore, run = CheckpointManager.restore, tloop.run

    def counting_restore(self, step, like, shardings=None):
        restores.append(step)
        return restore(self, step, like, shardings)

    def counting_run(*a, **k):
        segments.append(a[3].total_steps)
        return run(*a, **k)

    monkeypatch.setattr(CheckpointManager, "restore", counting_restore)
    monkeypatch.setattr(tloop, "run", counting_run)
    with_ckpt = tlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "ck")])
    assert segments == [2, 4] and restores == [2]
    segments.clear()
    without = tlaunch.main(argv)
    assert segments == [2, 4] and restores == [2]
    capsys.readouterr()
    assert [h["loss"] for h in with_ckpt["history"]] == [
        h["loss"] for h in without["history"]]
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 4]


# -- the default device -------------------------------------------------------


def test_launchers_need_cuda_unless_asked_for_the_cpu(tmp_path,
                                                      monkeypatch):
    CheckpointManager(str(tmp_path / "ck")).save(
        1, {"w": torch.zeros(2, 2)}, extra={"container": "sfp16"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tlaunch.main(ARGV + ["--ckpt-dir", str(tmp_path / "train")])
    assert not (tmp_path / "train").exists()
    with pytest.raises(RuntimeError, match="CUDA device"):
        tserve.main(["--arch", "gemma2-2b", "--preset", "tiny",
                     "--policy-ckpt", str(tmp_path / "ck")])


# -- the stamped decision's mean ---------------------------------------------


@pytest.mark.parametrize("policy", ["qm", "qe", "qm+qe"])
@pytest.mark.parametrize("bits", [[6.2] * 13,
                                  [6.2, 3.5, 7.0, 1.1, 5.0, 2.9, 6.6, 0.3,
                                   4.4, 7.0, 6.9, 2.0, 5.5]])
def test_decision_summary_means_as_jax(policy, bits):
    """The mean the checkpoint stamps is JAX's: the f32 sum of the
    rounded-up bits times the f32 reciprocal of the count. At 13 periods
    of 7 bits that is 7.0000005, and container_from_checkpoint derives
    sfp-m8e7 in both packages (the port's CPU path divided, gave 7.0 and
    derived sfp-m7e7; CUDA's torch.mean already multiplied)."""
    from repro import policies as jpolicies
    from repro_torch import policies as tpolicies
    dims = dict(n_periods=13, n_rem=0, man_bits=7, exp_bits=8)
    jp, tp = jpolicies.get(policy), tpolicies.get(policy)
    jd, td = jpolicies.ScopeDims(**dims), tpolicies.ScopeDims(**dims)
    js, ts = jp.init_state(jd), tp.init_state(td)
    vals = np.asarray(bits, np.float32)

    def set_j(learn):
        return {k: (jnp.asarray(vals) if k == "act" else v)
                for k, v in learn.items()}

    def set_t(learn):
        return {k: (torch.from_numpy(vals.copy()) if k == "act" else v)
                for k, v in learn.items()}

    if "+" in policy:
        js = js._replace(learn={k: set_j(v) for k, v in js.learn.items()})
        ts = ts._replace(learn={k: set_t(v) for k, v in ts.learn.items()})
    else:
        js, ts = js._replace(learn=set_j(js.learn)), ts._replace(
            learn=set_t(ts.learn))
    want = jp.decision_summary(js, jd)
    got = tp.decision_summary(ts, td)
    assert got == {k: float(v) for k, v in want.items()}
    assert (tprecision.container_for_decision(**got)
            == jprecision.container_for_decision(**want))
    if bits == [6.2] * 13 and policy == "qm":
        assert got["man_bits"] == 7.000000476837158
        assert tprecision.container_for_decision(**got) == "sfp-m8e7"
