"""Lock-cheap metrics registry: counters, gauges, log-bucket histograms.

One process, one registry, many labeled series. The design constraints
come from the serving hot loop: recording a sample must not allocate
(histograms pre-compute their bucket bounds and keep plain int arrays),
must not synchronize with the device (callers pass host floats/ints that
were already materialized at a host boundary — never traced values), and
must be safe to call at step frequency. Export is the slow path:
``to_prometheus()`` renders the standard text exposition format and
``snapshot()`` returns a JSON-able dict for the JSONL event stream.

Labeled series follow the prometheus-client idiom::

    reqs = reg.counter("serve_requests_total", "terminal outcomes",
                       labels=("outcome",))
    reqs.labels(outcome="ok").inc()

``labels()`` returns a bound series; binding is a dict lookup plus (on
first use) one tuple allocation, so hot paths should bind once and hold
the handle where possible. Unlabeled metrics skip even that:
``reg.counter("serve_decode_steps_total", ...).inc(k)`` mutates a single
slot.
"""
from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import IO, Any


def _fmt(v: float) -> str:
    """Prometheus-style number: integers stay integral, no exponent noise."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def log_buckets(lo: float = 1e-5, hi: float = 100.0,
                per_decade: int = 4) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds, ``lo``..``hi`` inclusive.

    The default (1e-5s .. 100s, 4/decade = 29 bounds) spans everything we
    time — sub-ms decode steps through multi-second floods — with ~78%
    worst-case relative quantization per bucket step, good enough for
    p50/p95/p99 reporting. Fixed at construction so `observe` is a binary
    search over a tuple: no allocation, no rehash.
    """
    n_dec = round(math.log10(hi / lo))
    n = n_dec * per_decade
    return tuple(lo * (10 ** (i / per_decade)) for i in range(n + 1))


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount


class _GaugeSeries:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class _HistogramSeries:
    __slots__ = ("bounds", "counts", "sum", "count", "min", "max")

    def __init__(self, bounds: tuple[float, ...]) -> None:
        self.bounds = bounds
        # +1 overflow slot for samples above the last bound.
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound >= v (upper-inclusive buckets)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Bucket-resolution quantile, ``q`` in [0, 1].

        Returns the upper bound of the bucket containing the q-th sample
        (the max observed value for the overflow bucket); 0.0 when empty.
        Allocation-free: one pass over the fixed count array.
        """
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i == len(self.bounds):
                    return self.max
                return min(self.bounds[i], self.max)
        return self.max


@dataclass
class _Family:
    name: str
    kind: str  # counter | gauge | histogram
    help: str
    unit: str
    label_names: tuple[str, ...]
    bounds: tuple[float, ...] | None = None
    series: dict[tuple[str, ...], Any] = field(default_factory=dict)

    def _make(self):
        if self.kind == "counter":
            return _CounterSeries()
        if self.kind == "gauge":
            return _GaugeSeries()
        return _HistogramSeries(self.bounds or log_buckets())

    def labels(self, **kv: Any):
        if set(kv) != set(self.label_names):
            raise KeyError(f"{self.name}: expected labels "
                           f"{self.label_names}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        s = self.series.get(key)
        if s is None:
            s = self.series[key] = self._make()
        return s

    # Unlabeled convenience: family acts as its own single series.
    def _solo(self):
        if self.label_names:
            raise KeyError(f"{self.name} is labeled {self.label_names}; "
                           "use .labels(...)")
        s = self.series.get(())
        if s is None:
            s = self.series[()] = self._make()
        return s

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def percentile(self, q: float) -> float:
        return self._solo().percentile(q)

    @property
    def value(self) -> float:
        return self._solo().value

    def total(self, **fixed: Any) -> float:
        """Sum a counter/gauge family across series matching ``fixed``."""
        idx = {n: i for i, n in enumerate(self.label_names)}
        out = 0.0
        for key, s in self.series.items():
            if all(key[idx[n]] == str(v) for n, v in fixed.items()):
                out += s.value
        return out


class MetricsRegistry:
    """Get-or-create registry of metric families.

    Creation is idempotent: asking for an existing name returns the same
    family (kind must match), so callers can look metrics up by name at
    any layer without threading handles around. A single lock guards
    family creation only — sample recording is plain Python mutation,
    which is atomic enough under the GIL for our single-writer loops.
    """

    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str, unit: str,
             labels: tuple[str, ...],
             bounds: tuple[float, ...] | None = None) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise TypeError(f"{name} already registered as {fam.kind}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name=name, kind=kind, help=help, unit=unit,
                              label_names=tuple(labels), bounds=bounds)
                self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", unit: str = "",
                labels: tuple[str, ...] = ()) -> _Family:
        return self._get(name, "counter", help, unit, labels)

    def gauge(self, name: str, help: str = "", unit: str = "",
              labels: tuple[str, ...] = ()) -> _Family:
        return self._get(name, "gauge", help, unit, labels)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  labels: tuple[str, ...] = (),
                  bounds: tuple[float, ...] | None = None) -> _Family:
        return self._get(name, "histogram", help, unit, labels,
                         bounds or log_buckets())

    # ---- export ---------------------------------------------------------

    def to_prometheus(self) -> str:
        """Standard text exposition format (one family per HELP/TYPE)."""
        out: list[str] = []
        for fam in self._families.values():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} "
                       f"{'histogram' if fam.kind == 'histogram' else fam.kind}")
            for key in sorted(fam.series):
                s = fam.series[key]
                lbl = _label_str(fam.label_names, key)
                if fam.kind in ("counter", "gauge"):
                    out.append(f"{fam.name}{lbl} {_fmt(s.value)}")
                    continue
                cum = 0
                for bound, c in zip(s.bounds, s.counts):
                    cum += c
                    le = _label_str(fam.label_names + ("le",),
                                    key + (_fmt(bound),))
                    out.append(f"{fam.name}_bucket{le} {cum}")
                le = _label_str(fam.label_names + ("le",),
                                key + ("+Inf",))
                out.append(f"{fam.name}_bucket{le} {s.count}")
                out.append(f"{fam.name}_sum{lbl} {_fmt(s.sum)}")
                out.append(f"{fam.name}_count{lbl} {s.count}")
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict[str, Any]:
        """JSON-able dump: one entry per family, series keyed by labels."""
        out: dict[str, Any] = {}
        for fam in self._families.values():
            series = []
            for key in sorted(fam.series):
                s = fam.series[key]
                entry: dict[str, Any] = {
                    "labels": dict(zip(fam.label_names, key))}
                if fam.kind == "histogram":
                    entry.update(count=s.count, sum=s.sum,
                                 min=(None if s.count == 0 else s.min),
                                 max=(None if s.count == 0 else s.max),
                                 p50=s.percentile(0.50),
                                 p95=s.percentile(0.95),
                                 p99=s.percentile(0.99))
                else:
                    entry["value"] = s.value
                series.append(entry)
            out[fam.name] = {"kind": fam.kind, "unit": fam.unit,
                             "series": series}
        return out


class EventLog:
    """Append-only JSONL sink shared by metrics, events, and the loop.

    Two write modes: ``emit(name, **fields)`` stamps a wall-clock ``ts``
    and an ``event`` discriminator key; ``write(obj)`` dumps the dict
    verbatim — that is the byte-compatible path for `train/loop.py`'s
    existing per-step metric lines, whose format downstream notebooks
    already parse.
    """

    def __init__(self, path: str | None, truncate: bool = True) -> None:
        self.path = path
        self._fh: IO[str] | None = None
        self.entries: list[dict[str, Any]] = []
        if path:
            self._fh = open(path, "w" if truncate else "a")

    def write(self, obj: dict[str, Any]) -> None:
        self.entries.append(obj)
        if self._fh is not None:
            self._fh.write(json.dumps(obj) + "\n")
            self._fh.flush()

    def emit(self, event: str, **fields: Any) -> None:
        self.write({"event": event, "ts": time.time(), **fields})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
