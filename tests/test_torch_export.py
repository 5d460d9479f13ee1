"""The port's telemetry exporters (telemetry/export.py) against the JAX
package's, on the CPU.

- ``prometheus_text``: both renderers fed one snapshot document (the
  port's registry after counters, a gauge, a labelled histogram, and a
  collector with nested and ``by_<label>`` blocks) give the same text,
  line for line;
- ``JsonlExporter``: spans and a metrics snapshot land in
  ``spans-<pid>.jsonl`` / ``metrics-<pid>.jsonl`` with the reference's
  line schema; the flush rides the preemption teardown; one exporter a
  process (install, get, shutdown), installed at import when
  ``SKYLARK_TELEMETRY_DIR`` is set.
"""

import json
import os
import subprocess
import sys

import pytest

from libskylark_tpu.telemetry import export as rexport
from libskylark_tpu_torch import sessions, telemetry  # noqa: F401 (counters)
from libskylark_tpu_torch.resilience import preemption
from libskylark_tpu_torch.telemetry import export, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recording():
    before = metrics._ENABLED
    metrics.set_enabled(True)
    yield
    metrics._ENABLED = before


def _document():
    reg = metrics.MetricsRegistry()
    c = reg.counter("t.export.hits", "Hits, by class")
    c.inc(3, **{"class": "interactive"})
    c.inc(1, **{"class": "best_effort"})
    reg.gauge("t.export.depth", "Queue depth").set(7.5)
    h = reg.histogram("t.export.latency_s", "Latency", buckets=(0.01, 0.1))
    for v in (0.005, 0.05, 0.5, 0.07):
        h.observe(v, endpoint="solve")
    reg.register_collector("t.serve", lambda: {
        "submitted": 12, "healthy": True, "note": "text", "p": None,
        "latency_s": {"p50": 0.25, "n": 4},
        "by_replica": {"r0": {"submitted": 5, "latency_s": {"p50": 0.5}},
                       "r\"1": {"submitted": 7}},
        "nested": {"by_kind": {"cwt": {"folds": 2}}, "x": 1.0}})
    return reg.snapshot()


def test_prometheus_text_matches_the_reference_line_for_line(
        recording, monkeypatch):
    doc = _document()
    monkeypatch.setattr(rexport._metrics, "snapshot", lambda: doc)
    want = rexport.prometheus_text()
    got = export._render(doc)
    assert got.splitlines() == want.splitlines()
    assert 'skylark_t_export_hits_total{class="interactive"} 3' in got
    assert 'skylark_t_serve_submitted{replica="r0"} 5' in got
    assert "skylark_t_export_latency_s_bucket" in got
    # the live registry renders too, with the session and io counters
    text = telemetry.prometheus_text()
    for name in ("skylark_sessions_appends_total",
                 "skylark_io_chunked_batches_total"):
        assert name in text


def test_jsonl_exporter_writes_spans_and_metrics(tmp_path, recording):
    ex = export.JsonlExporter(str(tmp_path), flush_interval_s=60.0)
    try:
        assert ex.flush_sync in preemption._HOOKS
        with telemetry.span("t.export.outer", attrs={"k": 1}):
            with telemetry.span("t.export.inner"):
                pass
        ex.flush_sync()
    finally:
        ex.close()
    assert ex.flush_sync not in preemption._HOOKS
    spans = [json.loads(ln) for ln in open(ex.span_path)]
    names = [s["name"] for s in spans]
    assert names[-2:] == ["t.export.inner", "t.export.outer"]
    inner, outer = spans[-2:]
    assert inner["parent_id"] == outer["span_id"]
    for s in (inner, outer):
        assert s["kind"] == "span"
        assert {"name", "trace_id", "span_id", "parent_id", "t_wall",
                "duration_s", "status", "thread"} <= set(s)
    lines = [json.loads(ln) for ln in open(ex.metrics_path)]
    assert len(lines) == 2                  # flush_sync, then close
    assert lines[0]["kind"] == "metrics"
    assert {"metrics", "collectors"} <= set(lines[0]["snapshot"])


def test_one_exporter_a_process(tmp_path, monkeypatch):
    monkeypatch.delenv("SKYLARK_TELEMETRY_DIR", raising=False)
    export.shutdown_exporter()
    assert export.install_exporter() is None
    a = export.install_exporter(str(tmp_path / "a"))
    try:
        assert export.install_exporter(str(tmp_path / "a")) is a
        assert export.get_exporter() is a
        b = export.install_exporter(str(tmp_path / "b"))
        assert a._closed and b is not a and export.get_exporter() is b
    finally:
        export.shutdown_exporter()
    assert export.get_exporter() is None


def test_exporter_installs_itself_from_the_environment(tmp_path):
    env = dict(os.environ, SKYLARK_TELEMETRY_DIR=str(tmp_path))
    code = ("import libskylark_tpu_torch.telemetry as t\n"
            "ex = t.get_exporter()\n"
            "assert ex is not None and t.enabled()\n"
            "with t.span('t.export.env'):\n    pass\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    files = sorted(os.listdir(tmp_path))
    assert [f.split("-")[0] for f in files] == ["metrics", "spans"]
    spans = [json.loads(ln) for ln in open(tmp_path / files[1])]
    assert [s["name"] for s in spans] == ["t.export.env"]
