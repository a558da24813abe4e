"""Fault-tolerant host training loop (the port of ``repro.train.loop``).

Responsibilities:
  * periodic async checkpoints (atomic; rollback-safe);
  * automatic restore-and-continue after a step failure: the loop restores
    the last good checkpoint and replays the data stream from its step
    (deterministic corpus), up to ``max_restarts``;
  * straggler watchdog: steps past a wall-time deadline are counted and
    flagged in their metrics;
  * telemetry: the per-step metrics stream is an ``obs.EventLog`` (JSONL;
    per-step metric lines, and lifecycle events such as step failures and
    checkpoints as ``{"event": ...}`` lines in the same stream); an
    optional ``LoopConfig.obs`` records the step-time histogram, the
    failure and straggler counters, ``train_step`` spans and, with
    ``timeline_fn``, the per-layer precision timeline;
  * ``profile_steps`` brackets ``torch.profiler`` around chosen steps and
    summarizes device time by kernel.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs import EventLog, Obs

PROFILE_TOP = 20  # kernels listed in the profile summary


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    metrics_file: Optional[str] = None
    step_deadline_s: Optional[float] = None  # straggler watchdog
    max_restarts: int = 3
    # JSON-able run metadata stamped into every checkpoint manifest, or a
    # callable(state) -> dict (the policy's current decision summary,
    # which policy-aware serving reads back).
    ckpt_extra: Optional[Any] = None
    # False appends to the metrics file (the per-layer-stash launcher runs
    # the loop in segments that share one file).
    metrics_truncate: bool = True
    # Telemetry: ``obs`` carries the registry, tracer and timeline; with
    # its timeline enabled, ``timeline_fn(state)`` -> [(man_bits,
    # exp_bits), ...] is sampled every ``timeline_every`` steps.
    obs: Optional[Obs] = None
    timeline_fn: Optional[Callable[[Any], Any]] = None
    timeline_every: int = 10
    # (start, n): bracket torch.profiler around steps [start, start + n);
    # its Chrome trace is written under profile_dir
    profile_steps: Optional[Tuple[int, int]] = None
    profile_dir: str = "experiments/traces/train"


@dataclasses.dataclass
class LoopResult:
    state: Any
    history: list
    restarts: int = 0
    straggler_steps: int = 0
    profile: Optional[dict] = None


def _resolve_extra(extra, state):
    return extra(state) if callable(extra) else extra


def _scalar(v):
    if isinstance(v, torch.Tensor):
        return v.item() if v.numel() == 1 else v.tolist()
    return float(v)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Profiler:
    """torch.profiler over steps [start, start + n): device time by kernel
    against the wall time of those steps (the profiler slows the host, so
    compare the busy time with an unprofiled step too), and the window's
    Chrome trace (host ops, and the kernels on CUDA) written to
    ``profile_dir/train_steps_{start}-{start + n - 1}.json``."""

    def __init__(self, cfg: LoopConfig, device):
        self.span, self.device = cfg.profile_steps, device
        self.dir = cfg.profile_dir
        self.prof = None
        self.summary = None

    def tick(self, step: int) -> None:
        if self.span is None:
            return
        start, n = self.span
        if self.prof is None and self.summary is None and step == start:
            from torch.profiler import ProfilerActivity, profile
            _sync(self.device)
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
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
        start, n = self.span
        trace = Path(self.dir) / f"train_steps_{start}-{start + n - 1}.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(trace))
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
            "steps": n, "trace": str(trace), "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "top_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                             "count": c} for k, t, c in rows[:PROFILE_TOP]]}


def run(train_step: Callable, state: Any,
        batch_iter_factory: Callable[[int], Iterator[Dict[str, Any]]],
        cfg: LoopConfig, fault_hook: Optional[Callable[[int], None]] = None,
        device=None) -> LoopResult:
    """Run steps ``state.step`` .. ``cfg.total_steps - 1``, resuming from
    the latest checkpoint under ``cfg.ckpt_dir`` when there is one.
    ``batch_iter_factory(start_step)`` must restart the stream at any step
    (deterministic data); ``fault_hook(step)`` lets tests inject failures.
    ``device`` (where the step runs; it brackets the profile window with
    synchronizes on CUDA) defaults to CUDA and raises without a GPU, as the
    launchers do: pass ``"cpu"`` for the plain path."""
    device = resolve_device(device)
    mgr = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
           if cfg.ckpt_dir else None)
    history = []
    restarts = 0
    stragglers = 0
    sink = None
    if cfg.metrics_file:
        Path(cfg.metrics_file).parent.mkdir(parents=True, exist_ok=True)
        sink = EventLog(cfg.metrics_file, truncate=cfg.metrics_truncate)
    obs = cfg.obs
    h_step = c_fail = c_straggle = None
    if obs is not None:
        h_step = obs.registry.histogram(
            "train_step_seconds", "train step wall time", unit="s")
        c_fail = obs.registry.counter(
            "train_step_failures_total", "step failures restored from "
            "checkpoint")
        c_straggle = obs.registry.counter(
            "train_straggler_steps_total", "steps past the wall-time "
            "deadline")
    prof = _Profiler(cfg, device)

    def tick_timeline(step: int, force: bool = False) -> None:
        if (obs is None or obs.timeline is None
                or cfg.timeline_fn is None):
            return
        if force or step % max(1, cfg.timeline_every) == 0:
            obs.timeline.record_train(step, cfg.timeline_fn(state))

    step = int(state.step)
    if mgr is not None and mgr.latest_step() is not None:
        state = mgr.restore(mgr.latest_step(), state)
        step = int(state.step)

    try:
        while step < cfg.total_steps:
            batches = batch_iter_factory(step)
            try:
                for batch in batches:
                    if step >= cfg.total_steps:
                        break
                    if fault_hook is not None:
                        fault_hook(step)
                    prof.tick(step)
                    t0 = time.perf_counter()
                    state, metrics = train_step(state, batch)
                    metrics = {k: _scalar(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    metrics["step"] = step
                    metrics["step_time_s"] = dt
                    if h_step is not None:
                        h_step.observe(dt)
                    if obs is not None and obs.tracer is not None:
                        obs.tracer.complete("train_step", "train", dt,
                                            step=step)
                    if cfg.step_deadline_s and dt > cfg.step_deadline_s:
                        stragglers += 1
                        metrics["straggler"] = True
                        if c_straggle is not None:
                            c_straggle.inc()
                    history.append(metrics)
                    if sink and (step % cfg.log_every == 0
                                 or step == cfg.total_steps - 1):
                        sink.write(metrics)
                    tick_timeline(step)
                    step += 1
                    if mgr is not None and step % cfg.ckpt_every == 0:
                        mgr.save(step, state, blocking=False,
                                 extra=_resolve_extra(cfg.ckpt_extra,
                                                      state))
                        if sink:
                            sink.emit("checkpoint", step=step)
                prof.tick(step)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                restarts += 1
                if c_fail is not None:
                    c_fail.inc()
                if mgr is None or restarts > cfg.max_restarts:
                    raise
                mgr.wait()
                latest = mgr.latest_step()
                if latest is None:
                    raise RuntimeError(
                        "step failed before first checkpoint") from e
                # The structured twin of the console message: tooling
                # reads failures from the JSONL stream, not stdout.
                for dst in (sink, None if obs is None else obs.events):
                    if dst is not None:
                        dst.emit("step_failure", step=step,
                                 error=type(e).__name__, message=str(e),
                                 restore_step=int(latest),
                                 restart=restarts)
                print(f"[loop] step {step} failed "
                      f"({type(e).__name__}: {e}); "
                      f"restoring step {latest} (restart {restarts})")
                state = mgr.restore(latest, state)
                step = int(state.step)
                continue
    finally:
        prof.stop()
        tick_timeline(step, force=True)
        if sink:
            sink.close()

    if mgr is not None:
        mgr.save(step, state, blocking=True,
                 extra=_resolve_extra(cfg.ckpt_extra, state))
    return LoopResult(state=state, history=history, restarts=restarts,
                      straggler_steps=stragglers, profile=prof.summary)
