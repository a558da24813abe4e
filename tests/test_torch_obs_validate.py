"""The port's ``obs/validate.py`` (a stdlib-only copy of the JAX
package's) against JAX's, on telemetry the port's exporters write: the
same verdict, the same messages and the same exit code for valid files
and for each kind of broken one, through the CLI and the schema walker."""
import json

import pytest

from repro.obs import validate as jvalidate
from repro_torch.obs import Obs
from repro_torch.obs import validate as tvalidate

SCHEMAS = "tests/fixtures/obs"


def _write_valid(d):
    """Exporter output of a small serve run: TTFT and latency histograms,
    one complete request chain with a downshifted prefill, two serve
    timeline entries and a few events."""
    obs = Obs(metrics_path=str(d / "m.prom"), events_path=str(d / "ev.jsonl"),
              trace_path=str(d / "trace.json"),
              timeline_path=str(d / "tl.jsonl"))
    ttft = obs.registry.histogram("serve_ttft_seconds", "ttft", unit="s")
    lat = obs.registry.histogram("serve_token_latency_seconds", "lat",
                                 unit="s")
    for v in (0.01, 0.2, 3.0):
        ttft.observe(v)
        lat.observe(v / 10)
    obs.registry.counter("serve_requests_total", "reqs").inc(3)
    tr = obs.tracer
    tr.instant("submit", "req0")
    for name, args in (("queued", {}), ("prefill", {"downshift": True}),
                       ("decode", {})):
        tr.end(tr.begin(name, "req0", **args))
    tr.instant("retire", "req0")
    for step, used in ((0, 256), (1, 384)):
        obs.timeline.record_serve(
            step, geometry_blocks={"sfp8": used // 128},
            geometry_bytes={"sfp8": used}, used_bytes=used,
            free_bytes=1024 - used, capacity_bytes=1024, occupancy=used / 1024,
            pressure="normal", quarantined=0, running=1)
    obs.timeline.record_train(2, [(3, 8), (7, 5)])
    obs.event("admit", step=0, uid=0)
    obs.events.write({"step": 1, "step_time_s": 0.5, "loss": 2.0})
    obs.close()


def _break(d, what):
    if what == "prom_line":
        with open(d / "m.prom", "a") as f:
            f.write("bad line with spaces here\n")
    elif what == "prom_inf":
        text = (d / "m.prom").read_text().splitlines()
        (d / "m.prom").write_text("\n".join(
            line for line in text
            if not ("serve_ttft_seconds_bucket" in line and "+Inf" in line))
            + "\n")
    elif what == "trace_chain":
        trace = json.loads((d / "trace.json").read_text())
        trace["traceEvents"] = [e for e in trace["traceEvents"]
                                if e.get("name") != "retire"]
        (d / "trace.json").write_text(json.dumps(trace))
    elif what == "trace_schema":
        trace = json.loads((d / "trace.json").read_text())
        trace["traceEvents"][1]["ph"] = "Q"
        trace["traceEvents"][2]["pid"] = "main"
        (d / "trace.json").write_text(json.dumps(trace))
    elif what == "timeline_bytes":
        lines = (d / "tl.jsonl").read_text().splitlines()
        e = json.loads(lines[1])
        e["geometry_bytes"]["sfp8"] += 1
        e["free_bytes"] -= 3
        lines[1] = json.dumps(e)
        (d / "tl.jsonl").write_text("\n".join(lines) + "\n")
    elif what == "timeline_schema":
        with open(d / "tl.jsonl", "a") as f:
            f.write(json.dumps({"kind": "train", "step": -1,
                                "layers": [{"layer": 0, "man_bits": 1.5}]})
                    + "\n")
    elif what == "events":
        with open(d / "ev.jsonl", "a") as f:
            f.write(json.dumps({"event": 3, "ts": "x"}) + "\n"
                    + json.dumps({"loss": 1.0}) + "\n{not json\n")


def _argv(d):
    return ["--metrics", str(d / "m.prom"), "--trace", str(d / "trace.json"),
            "--timeline", str(d / "tl.jsonl"), "--events",
            str(d / "ev.jsonl"), "--require-chain", "--require-downshift",
            "--schemas-dir", SCHEMAS]


@pytest.mark.parametrize("what", [None, "prom_line", "prom_inf",
                                  "trace_chain", "trace_schema",
                                  "timeline_bytes", "timeline_schema",
                                  "events"])
def test_validate_cli_agrees_with_jax(tmp_path, capsys, what):
    _write_valid(tmp_path)
    if what is not None:
        _break(tmp_path, what)
    rc_j = jvalidate.main(_argv(tmp_path))
    out_j = capsys.readouterr().out
    rc_t = tvalidate.main(_argv(tmp_path))
    out_t = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j)
    assert rc_t == (0 if what is None else 1)
    assert out_t.splitlines()[-1].startswith(
        "[obs.validate] ok" if what is None else "[obs.validate] FAIL")


def test_default_schemas_dir_is_the_fixtures(tmp_path, capsys, monkeypatch):
    _write_valid(tmp_path)
    argv = _argv(tmp_path)[:-2]
    assert tvalidate.main(argv) == 0   # run from the repo root
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        tvalidate.main(argv)
    with pytest.raises(FileNotFoundError):
        jvalidate.main(argv)


VALUES = [
    ({"a": 1}, {"type": "object", "required": ["a", "b"]}),
    ({"a": True}, {"type": "object", "properties": {"a": {
        "type": "integer"}}}),
    ([1, 2.5, -1], {"type": "array", "items": {"type": "integer",
                                               "minimum": 0}}),
    ({"x": 1, "y": "z"}, {"type": "object", "additionalProperties": False,
                          "properties": {"x": {"type": "number"}}}),
    ("q", {"enum": ["a", "b"]}),
    (3, {"anyOf": [{"type": "string"}, {"type": "integer",
                                         "minimum": 5}]}),
    (None, {"type": ["null", "string"]}),
    ({"k": {"n": -2}}, {"type": "object", "additionalProperties": {
        "type": "object", "properties": {"n": {"minimum": 0}}}}),
]


@pytest.mark.parametrize("value,schema", VALUES)
def test_schema_walker_agrees_with_jax(value, schema):
    assert tvalidate.validate(value, schema) == jvalidate.validate(value,
                                                                   schema)
