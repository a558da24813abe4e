"""The port's host training loop (``train.loop.run``) on the CPU: it runs
the step over the batch stream when asked for the CPU, and its default
device is CUDA, which raises where there is no GPU instead of running the
plain path unasked."""
import json
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
