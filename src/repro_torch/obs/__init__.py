"""Unified telemetry: metrics registry + span tracer + precision timeline.

One ``Obs`` object is the whole observability surface for a process. The
registry is always live (recording into it is cheap enough to leave on);
the span tracer and precision timeline are opt-in, because they retain
per-event state for export. Construction from launcher flags::

    obs = Obs(metrics_path=args.metrics_out, trace_path=args.trace_out,
              timeline_path=args.timeline_out)
    sched = Scheduler(eng, ..., obs=obs)
    ...
    obs.flush()   # writes prometheus text + Perfetto trace JSON

Hot-path contract: obs mutators are host-side only. Callers record
*after* device values have been pulled to the host at an existing
boundary (the per-step token download); the registry, tracer and
timeline take plain Python scalars and never force a device sync
themselves. A stdlib-only copy of the JAX package's ``obs`` (the port
imports nothing of it), ``obs/validate.py`` included.
"""
from __future__ import annotations

from typing import Any

from repro_torch.obs.registry import (EventLog, MetricsRegistry,  # noqa: F401
                                log_buckets)
from repro_torch.obs.timeline import PrecisionTimeline  # noqa: F401
from repro_torch.obs.trace import SpanTracer  # noqa: F401


class Obs:
    """Facade bundling registry, event log, tracer, and timeline.

    ``tracer`` / ``timeline`` are ``None`` unless enabled — call sites
    guard with ``if obs.tracer is not None`` so the disabled path costs
    one attribute load.
    """

    def __init__(self, *, metrics_path: str | None = None,
                 events_path: str | None = None,
                 trace_path: str | None = None,
                 timeline_path: str | None = None,
                 trace: bool = False, timeline: bool = False) -> None:
        self.registry = MetricsRegistry()
        self.metrics_path = metrics_path
        self.events = EventLog(events_path)
        self.tracer = (SpanTracer()
                       if (trace or trace_path is not None) else None)
        self.trace_path = trace_path
        self.timeline = (PrecisionTimeline(timeline_path)
                         if (timeline or timeline_path is not None)
                         else None)

    def event(self, name: str, **fields: Any) -> None:
        self.events.emit(name, **fields)

    def flush(self) -> None:
        """Write every file-backed exporter; safe to call repeatedly."""
        if self.metrics_path:
            with open(self.metrics_path, "w") as fh:
                fh.write(self.registry.to_prometheus())
        if self.tracer is not None and self.trace_path:
            self.tracer.write(self.trace_path)

    def close(self) -> None:
        self.flush()
        self.events.close()
        if self.timeline is not None:
            self.timeline.close()
