"""Exporter-output validation against checked-in schemas (CI smoke); a
stdlib-only copy of the JAX package's ``obs/validate.py``.

A deliberately small JSON-Schema subset — ``type``, ``required``,
``properties``, ``additionalProperties`` (schema-valued), ``items``,
``enum``, ``anyOf``, ``minimum`` — implemented here because the CI image
installs no schema library and the hard no-new-deps rule holds. The
schemas live in ``tests/fixtures/obs/`` so a format drift fails CI with
a diffable fixture, exactly like the analysis fixtures pin lint rules.

CLI (what the CI observability smoke runs)::

    python -m repro_torch.obs.validate \
        --metrics obs/metrics.prom --trace obs/trace.json \
        --timeline obs/timeline.jsonl --events obs/events.jsonl \
        --require-chain --require-downshift

Beyond schema-shape it checks the semantic acceptance criteria: the
Prometheus text parses and carries the TTFT/latency histograms, the
trace holds >=1 complete request span chain (submit -> queued ->
prefill -> decode -> retire), ``--require-downshift`` demands a
downshift-annotated prefill span, and every serve timeline entry's
per-geometry bytes sum exactly to the pool's ``used_bytes``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Any

_TYPES = {
    "object": dict, "array": list, "string": str,
    "boolean": bool, "null": type(None),
}


def _type_ok(value: Any, t: str) -> bool:
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    return isinstance(value, _TYPES[t])


def validate(value: Any, schema: dict[str, Any],
             path: str = "$") -> list[str]:
    """Return a list of violation messages (empty == valid)."""
    errs: list[str] = []
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, x) for x in types):
            return [f"{path}: expected {t}, got {type(value).__name__}"]
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{path}: {value!r} not in {schema['enum']}")
    if "anyOf" in schema:
        branches = [validate(value, sub, path) for sub in schema["anyOf"]]
        if not any(not b for b in branches):
            errs.append(f"{path}: matched no anyOf branch "
                        f"({'; '.join(branches[0])})")
    if ("minimum" in schema and isinstance(value, (int, float))
            and not isinstance(value, bool) and value < schema["minimum"]):
        errs.append(f"{path}: {value} < minimum {schema['minimum']}")
    if isinstance(value, dict):
        for name in schema.get("required", ()):
            if name not in value:
                errs.append(f"{path}: missing required key {name!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties")
        for k, v in value.items():
            if k in props:
                errs.extend(validate(v, props[k], f"{path}.{k}"))
            elif isinstance(extra, dict):
                errs.extend(validate(v, extra, f"{path}.{k}"))
            elif extra is False:
                errs.append(f"{path}: unexpected key {k!r}")
    if isinstance(value, list) and "items" in schema:
        for i, v in enumerate(value):
            errs.extend(validate(v, schema["items"], f"{path}[{i}]"))
    return errs


def validate_jsonl(path: str, schema: dict[str, Any]) -> list[str]:
    errs: list[str] = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            errs.append(f"{path}:{i + 1}: not JSON ({e})")
            continue
        errs.extend(f"{path}:{i + 1}: {m}"
                    for m in validate(obj, schema, "$"))
    return errs


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")


def validate_prometheus(path: str,
                        require: tuple[str, ...] = ()) -> list[str]:
    """Check exposition-format shape + that required histograms exist
    with a terminating ``+Inf`` bucket."""
    errs: list[str] = []
    seen_inf: set[str] = set()
    text = Path(path).read_text()
    for i, line in enumerate(text.splitlines()):
        if not line or line.startswith("#"):
            continue
        if not _PROM_LINE.match(line):
            errs.append(f"{path}:{i + 1}: malformed sample line: {line!r}")
            continue
        name = line.split("{")[0].split(" ")[0]
        if name.endswith("_bucket") and 'le="+Inf"' in line:
            seen_inf.add(name[:-len("_bucket")])
    for name in require:
        if f"# TYPE {name} histogram" not in text:
            errs.append(f"{path}: missing histogram {name}")
        elif name not in seen_inf:
            errs.append(f"{path}: {name} lacks a +Inf bucket")
    return errs


CHAIN_SPANS = ("queued", "prefill", "decode")
CHAIN_INSTANTS = ("submit", "retire")


def check_trace_chain(trace: dict[str, Any],
                      require_downshift: bool = False) -> list[str]:
    """>=1 lane carrying the full request span chain; optionally >=1
    prefill span annotated with a pressure downshift."""
    events = trace.get("traceEvents", [])
    by_tid: dict[int, dict[str, set[str]]] = {}
    for e in events:
        if e.get("ph") in ("X", "i"):
            d = by_tid.setdefault(e["tid"], {"X": set(), "i": set()})
            d[e["ph"]].add(e["name"])
    complete = [tid for tid, d in by_tid.items()
                if set(CHAIN_SPANS) <= d["X"]
                and set(CHAIN_INSTANTS) <= d["i"]]
    errs: list[str] = []
    if not complete:
        errs.append("trace: no lane has a complete request span chain "
                    f"(need spans {CHAIN_SPANS} + instants "
                    f"{CHAIN_INSTANTS})")
    if require_downshift:
        hit = any(e.get("ph") == "X" and e.get("name") == "prefill"
                  and e.get("args", {}).get("downshift")
                  for e in events)
        if not hit:
            errs.append("trace: no downshift-annotated prefill span")
    return errs


def check_timeline_accounting(path: str) -> list[str]:
    """Per-step geometry bytes must byte-agree with pool accounting."""
    errs: list[str] = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        if not line.strip():
            continue
        e = json.loads(line)
        if e.get("kind") != "serve":
            continue
        geo = sum(e["geometry_bytes"].values())
        if geo != e["used_bytes"]:
            errs.append(f"{path}:{i + 1}: geometry_bytes sum {geo} != "
                        f"used_bytes {e['used_bytes']}")
        if e["used_bytes"] + e["free_bytes"] != e["capacity_bytes"]:
            errs.append(f"{path}:{i + 1}: used+free != capacity")
    return errs


def _load_schema(schemas_dir: str, name: str) -> dict[str, Any]:
    return json.loads((Path(schemas_dir) / name).read_text())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="validate obs exporter output against the checked-in "
                    "schemas")
    ap.add_argument("--metrics", help="prometheus text file")
    ap.add_argument("--trace", help="Chrome trace_event JSON")
    ap.add_argument("--timeline", help="precision-timeline JSONL")
    ap.add_argument("--events", help="structured-event JSONL")
    ap.add_argument("--schemas-dir", default="tests/fixtures/obs")
    ap.add_argument("--require-chain", action="store_true",
                    help="demand >=1 complete request span chain and the "
                         "TTFT/latency histograms")
    ap.add_argument("--require-downshift", action="store_true",
                    help="demand a downshift-annotated prefill span")
    args = ap.parse_args(argv)

    errs: list[str] = []
    if args.metrics:
        req = (("serve_ttft_seconds", "serve_token_latency_seconds")
               if args.require_chain else ())
        errs += validate_prometheus(args.metrics, req)
    if args.trace:
        trace = json.loads(Path(args.trace).read_text())
        errs += validate(trace, _load_schema(args.schemas_dir,
                                             "trace.schema.json"), "trace")
        if args.require_chain or args.require_downshift:
            errs += check_trace_chain(trace, args.require_downshift)
    if args.timeline:
        errs += validate_jsonl(args.timeline,
                               _load_schema(args.schemas_dir,
                                            "timeline.schema.json"))
        errs += check_timeline_accounting(args.timeline)
    if args.events:
        errs += validate_jsonl(args.events,
                               _load_schema(args.schemas_dir,
                                            "events.schema.json"))
    for e in errs:
        print(f"[obs.validate] {e}")
    print(f"[obs.validate] {'FAIL' if errs else 'ok'} "
          f"({len(errs)} violation(s))")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
