"""Host training loop (the port of ``repro.train.loop``).

Runs the step over a deterministic batch stream, keeps the per-step
metrics history, writes it to a JSONL file, and can bracket
``torch.profiler`` around chosen steps. Checkpointing, restore-on-failure
and the obs telemetry of the JAX loop are not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import resolve_device

PROFILE_TOP = 20  # kernels listed in the profile summary


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    metrics_file: Optional[str] = None
    # False appends to the metrics file (the per-layer-stash launcher runs
    # the loop in segments that share one file).
    metrics_truncate: bool = True
    # (start, n): bracket torch.profiler around steps [start, start + n)
    profile_steps: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class LoopResult:
    state: Any
    history: list
    profile: Optional[dict] = None


def _scalar(v):
    if isinstance(v, torch.Tensor):
        return v.item() if v.numel() == 1 else v.tolist()
    return float(v)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Profiler:
    """torch.profiler over steps [start, start + n): device time by kernel
    against the wall time of those steps (CUDA only; the profiler slows
    the host, so compare the busy time with an unprofiled step too)."""

    def __init__(self, cfg: LoopConfig, device):
        self.span, self.device = cfg.profile_steps, device
        self.prof = None
        self.summary = None

    def tick(self, step: int) -> None:
        if self.span is None:
            return
        start, n = self.span
        if self.prof is None and self.summary is None and step == start:
            from torch.profiler import ProfilerActivity, profile
            _sync(self.device)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif self.prof is not None and step >= start + n:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        _sync(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        # Device-side entries only: the CPU ops that launched the kernels
        # report the same device time again.
        from torch.autograd import DeviceType
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in self.prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        self.prof = None
        busy = sum(r[1] for r in rows) / 1e3
        rows.sort(key=lambda r: -r[1])
        self.summary = {
            "steps": self.span[1], "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "top_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                             "count": c} for k, t, c in rows[:PROFILE_TOP]]}


def run(train_step: Callable, state: Any,
        batch_iter_factory: Callable[[int], Iterator[Dict[str, Any]]],
        cfg: LoopConfig, device=None) -> LoopResult:
    """Run steps ``state.step`` .. ``cfg.total_steps - 1``.
    ``batch_iter_factory(start_step)`` starts the stream at a step.
    ``device`` (where the step runs; it brackets the profile window with
    synchronizes on CUDA) defaults to CUDA and raises without a GPU, as the
    launchers do: pass ``"cpu"`` for the plain path."""
    device = resolve_device(device)
    history = []
    sink = None
    if cfg.metrics_file:
        Path(cfg.metrics_file).parent.mkdir(parents=True, exist_ok=True)
        sink = open(cfg.metrics_file, "w" if cfg.metrics_truncate else "a")
    prof = _Profiler(cfg, device)
    step = state.step
    try:
        for batch in batch_iter_factory(step):
            if step >= cfg.total_steps:
                break
            prof.tick(step)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            metrics = {k: _scalar(v) for k, v in metrics.items()}
            metrics["step"] = step
            metrics["step_time_s"] = time.perf_counter() - t0
            history.append(metrics)
            if sink and (step % cfg.log_every == 0
                         or step == cfg.total_steps - 1):
                sink.write(json.dumps(metrics) + "\n")
            step += 1
        prof.tick(step)
    finally:
        prof.stop()
        if sink:
            sink.close()
    return LoopResult(state=state, history=history, profile=prof.summary)
