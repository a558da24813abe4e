"""The port's host training loop (``train.loop.run``) on the CPU: it runs
the step over the batch stream when asked for the CPU, and its default
device is CUDA, which raises where there is no GPU instead of running the
plain path unasked. Then JAX's fault-tolerance tests (``tests/test_loop.py``)
on the port's mini state: checkpoints, restore-and-replay after an
injected failure (exact: w = sum(1..10)), max_restarts, resuming, the
straggler watchdog, and the telemetry the loop feeds."""
import json
import time
import types

import pytest
import torch

from repro_torch.train import loop


def _step(state, batch):
    """A stand-in train step: counts steps and sums the batch."""
    return (types.SimpleNamespace(step=state.step + 1),
            {"loss": torch.tensor(float(batch["x"].sum())), "lr": 0.5})


def _batches(start):
    for i in range(start, 100):
        yield {"x": torch.full((2,), float(i))}


def test_run_on_cpu_writes_history(tmp_path):
    metrics = tmp_path / "m.jsonl"
    cfg = loop.LoopConfig(total_steps=4, log_every=2,
                          metrics_file=str(metrics))
    res = loop.run(_step, types.SimpleNamespace(step=1), _batches, cfg,
                   device="cpu")
    assert [h["step"] for h in res.history] == [1, 2, 3]
    assert [h["loss"] for h in res.history] == [2.0, 4.0, 6.0]
    assert res.state.step == 4 and res.profile is None
    logged = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [m["step"] for m in logged] == [2, 3]


def test_run_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        loop.run(_step, types.SimpleNamespace(step=0), _batches,
                 loop.LoopConfig(total_steps=1))


# -- the fault-tolerant loop: JAX's tests (tests/test_loop.py) on the port --

from repro_torch import policies  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402

_DIMS = policies.ScopeDims(n_periods=1, n_rem=0, man_bits=7, exp_bits=8)


def _mini_state():
    params = {"w": torch.zeros((4,))}
    return TrainState(params=params, opt=adamw.init(params),
                      pstate=policies.get("qm+bitchop").init_state(_DIMS),
                      step=0, gen=torch.Generator().manual_seed(0))


def _mini_step(state, batch):
    new = state._replace(params={"w": state.params["w"] + batch["x"].mean()},
                         step=state.step + 1)
    return new, {"loss": torch.sum(new.params["w"])}


def _mini_batches(start):
    def gen():
        i = start
        while True:
            yield {"x": torch.full((2,), float(i + 1))}
            i += 1
    return gen()


def _run(cfg, fault_hook=None, step=_mini_step, state=None):
    return loop.run(step, _mini_state() if state is None else state,
                    _mini_batches, cfg, fault_hook=fault_hook, device="cpu")


def test_loop_runs_and_checkpoints(tmp_path):
    cfg = loop.LoopConfig(total_steps=10, ckpt_every=4,
                          ckpt_dir=str(tmp_path / "ck"))
    res = _run(cfg)
    assert res.state.step == 10 and res.restarts == 0
    # deterministic data: w = sum(1..10)
    assert float(res.state.params["w"][0]) == sum(range(1, 11))
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [4, 8, 10]


@pytest.mark.parametrize("fault_step,ckpt_every", [(7, 2), (5, 4), (9, 3)])
def test_loop_recovers_from_injected_failure(tmp_path, fault_step,
                                             ckpt_every):
    cfg = loop.LoopConfig(total_steps=10, ckpt_every=ckpt_every,
                          ckpt_dir=str(tmp_path / "ck"),
                          metrics_file=str(tmp_path / "m.jsonl"),
                          log_every=1)
    fired = []

    def fault(step):
        if step == fault_step and not fired:
            fired.append(step)
            raise RuntimeError("simulated node failure")

    obs = Obs()
    cfg.obs = obs
    res = _run(cfg, fault)
    assert res.restarts == 1 and res.state.step == 10
    assert float(res.state.params["w"][0]) == sum(range(1, 11))  # exact
    restore_step = fault_step - fault_step % ckpt_every
    events = [json.loads(line) for line in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    failures = [e for e in events if e.get("event") == "step_failure"]
    assert len(failures) == 1
    f = failures[0]
    assert (f["step"], f["error"], f["message"], f["restore_step"],
            f["restart"]) == (fault_step, "RuntimeError",
                              "simulated node failure", restore_step, 1)
    assert [e["event"] for e in obs.events.entries] == ["step_failure"]
    assert obs.registry.counter("train_step_failures_total").value == 1
    # the replayed steps are logged again, in order after the failure
    steps = [e["step"] for e in events if "event" not in e]
    assert steps == list(range(fault_step)) + list(range(restore_step, 10))


def test_loop_gives_up_after_max_restarts(tmp_path):
    cfg = loop.LoopConfig(total_steps=10, ckpt_every=2,
                          ckpt_dir=str(tmp_path / "ck"), max_restarts=2)
    calls = []

    def always_fail(step):
        if step == 5:
            calls.append(step)
            raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent failure"):
        _run(cfg, always_fail)
    assert len(calls) == 3  # the first failure and two restarts


def test_loop_failure_without_checkpoints_raises(tmp_path):
    def fault(step):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        _run(loop.LoopConfig(total_steps=3), fault)
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        _run(loop.LoopConfig(total_steps=3, ckpt_every=2,
                             ckpt_dir=str(tmp_path / "ck")), fault)


def test_loop_resumes_from_existing_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    _run(loop.LoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=ck))
    # a second run continues to 12 from the saved state
    res = _run(loop.LoopConfig(total_steps=12, ckpt_every=3, ckpt_dir=ck))
    assert res.state.step == 12
    assert [h["step"] for h in res.history] == list(range(6, 12))
    assert float(res.state.params["w"][0]) == sum(range(1, 13))


def test_straggler_watchdog():
    def slow_step(state, batch):
        time.sleep(0.05)
        return _mini_step(state, batch)

    obs = Obs()
    res = _run(loop.LoopConfig(total_steps=3, step_deadline_s=0.01,
                               obs=obs), step=slow_step)
    assert res.straggler_steps == 3
    assert all(h["straggler"] for h in res.history)
    assert obs.registry.counter("train_straggler_steps_total").value == 3


def test_loop_checkpoint_extra_and_events(tmp_path):
    """ckpt_extra (a dict or a callable of the state) is stamped into every
    checkpoint, and each periodic save is a ``checkpoint`` event."""
    ck = tmp_path / "ck"
    cfg = loop.LoopConfig(total_steps=5, ckpt_every=2, ckpt_dir=str(ck),
                          metrics_file=str(tmp_path / "m.jsonl"),
                          ckpt_extra=lambda s: {"w0": float(
                              s.params["w"][0])})
    _run(cfg)
    mgr = CheckpointManager(str(ck))
    assert mgr.all_steps() == [2, 4, 5]
    assert [mgr.read_extra(s)["w0"] for s in (2, 4, 5)] == [3.0, 10.0, 15.0]
    events = [json.loads(line) for line in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events if e.get("event") == "checkpoint"] \
        == [2, 4]


def test_loop_telemetry_histogram_spans_and_timeline(tmp_path):
    obs = Obs(trace=True, timeline_path=str(tmp_path / "tl.jsonl"))
    cfg = loop.LoopConfig(total_steps=5, obs=obs, timeline_every=2,
                          timeline_fn=lambda s: [(s.step, 8)])
    _run(cfg)
    assert obs.registry.snapshot()["train_step_seconds"]["series"][0][
        "count"] == 5
    spans = obs.tracer.spans(lane="train", name="train_step")
    assert [e["args"]["step"] for e in spans] == [0, 1, 2, 3, 4]
    obs.close()
    entries = [json.loads(line) for line in
               (tmp_path / "tl.jsonl").read_text().splitlines()]
    # every timeline_every steps, and once more at the end (forced)
    assert [e["step"] for e in entries] == [0, 2, 4, 5]
    assert entries[1]["layers"] == [{"layer": 0, "man_bits": 3,
                                     "exp_bits": 8}]


def test_loop_default_device_needs_cuda_with_checkpoints(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        loop.run(_mini_step, _mini_state(), _mini_batches,
                 loop.LoopConfig(total_steps=2, ckpt_every=1,
                                 ckpt_dir=str(tmp_path / "ck")))
    assert not (tmp_path / "ck").exists()
