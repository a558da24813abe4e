"""Per-request span tracer exporting Chrome ``trace_event`` JSON.

Every request gets its own lane (tid) inside one process row, so the
Perfetto timeline reads as: one horizontal track per request, spans for
`queued → prefill → decode[burst] → ...`, instants for submit / preempt /
recover / retire, with geometry, blocks held, and downshift flags as
span args. The output format is the Trace Event Format's JSON-array
flavor (``{"traceEvents": [...]}``) — the same container
``torch.profiler``'s Chrome export produces — so a serve trace opens in
Perfetto/``chrome://tracing`` next to the profiler capture from
`bench_decode_micro.py`.

Timestamps are microseconds from a monotonic clock; the tracer never
touches device values, so it adds no host sync — callers hand it host
scalars only, after any device step has already been consumed at the
host boundary.
"""
from __future__ import annotations

import json
import time
from typing import Any, NamedTuple

_PID = 1  # single-process: one row in the viewer


class _Open(NamedTuple):
    name: str
    tid: int
    t0_us: float
    args: dict[str, Any]


class SpanTracer:
    def __init__(self, clock=time.perf_counter) -> None:
        self._clock = clock
        self._t0 = clock()
        self.events: list[dict[str, Any]] = []
        self._tids: dict[str, int] = {}

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _tid(self, lane: str) -> int:
        tid = self._tids.get(lane)
        if tid is None:
            tid = self._tids[lane] = len(self._tids) + 1
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                "args": {"name": lane}})
        return tid

    def begin(self, name: str, lane: str, **args: Any) -> _Open:
        """Open a span on ``lane`` (request uid or subsystem name)."""
        return _Open(name, self._tid(lane), self._now_us(), args)

    def end(self, span: _Open, **extra: Any) -> None:
        t1 = self._now_us()
        self.events.append({
            "name": span.name, "ph": "X", "pid": _PID, "tid": span.tid,
            "ts": span.t0_us, "dur": max(t1 - span.t0_us, 0.0),
            "args": {**span.args, **extra}})

    def complete(self, name: str, lane: str, dur_s: float,
                 **args: Any) -> None:
        """Record an already-finished span ending now, ``dur_s`` long."""
        t1 = self._now_us()
        dur = max(dur_s, 0.0) * 1e6
        # A span can out-span the tracer (the first prefill includes the kernel
        # build; the tracer may be younger): clamp its start into the
        # trace's epoch rather than emitting a negative timestamp.
        self.events.append({
            "name": name, "ph": "X", "pid": _PID, "tid": self._tid(lane),
            "ts": max(t1 - dur, 0.0), "dur": dur, "args": args})

    def instant(self, name: str, lane: str, **args: Any) -> None:
        self.events.append({
            "name": name, "ph": "i", "s": "t", "pid": _PID,
            "tid": self._tid(lane), "ts": self._now_us(), "args": args})

    def export(self) -> dict[str, Any]:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.export(), fh)

    # ---- queries (test/report support) ----------------------------------

    def spans(self, lane: str | None = None,
              name: str | None = None) -> list[dict[str, Any]]:
        tid = self._tids.get(lane) if lane is not None else None
        return [e for e in self.events
                if e["ph"] in ("X", "i")
                and (lane is None or e["tid"] == tid)
                and (name is None or e["name"] == name)]

    def lanes(self) -> list[str]:
        return list(self._tids)
