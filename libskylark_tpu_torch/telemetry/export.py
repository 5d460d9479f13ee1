"""Telemetry exporters: JSONL span/metric sink and Prometheus text (the
port of libskylark_tpu/telemetry/export.py).

**JSONL** (:class:`JsonlExporter`, auto-installed when
``SKYLARK_TELEMETRY_DIR`` is set): every finished span becomes one JSON
line in ``spans-<pid>.jsonl`` and every metrics flush one line in
``metrics-<pid>.jsonl`` under the directory. Writes happen on a
background flusher thread (the span hot path only appends to an
in-memory queue); :meth:`JsonlExporter.flush_sync` drains
synchronously, and the exporter registers it with the resilience
preemption teardown (:func:`libskylark_tpu_torch.resilience.on_preemption`)
plus ``atexit``, so a SIGTERM'd serving process loses no spans.

Line schema (the reference's):

- span lines: ``{"kind": "span", "name", "trace_id", "span_id",
  "parent_id", "t_wall", "duration_s", "status", "thread",
  "request_id"?, "attrs"?, "events"?, "error"?}``
- metric lines: ``{"kind": "metrics", "t_wall", "snapshot": <the
  telemetry.snapshot() document>}``

**Prometheus** (:func:`prometheus_text`): the registry's counters,
gauges and histograms in text exposition format, plus every collector
block flattened to gauges — one scrape surface carrying the unified
engine/serve/resilience/tune/io numbers. Naming: ``skylark_`` prefix,
dots to underscores, counters get ``_total``, histograms the classic
``_bucket``/``_sum``/``_count`` triplet. Collector sub-blocks named
``by_<label>`` (``serve_stats()``'s ``by_replica``, ``fleet_stats()``'s
ditto) render as *label sets* — ``skylark_serve_submitted{replica=
"r0"}`` — so N executors disaggregate per replica on the scrape
surface instead of silently summing.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import threading
import time
from typing import Optional

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

# ---------------------------------------------------------------------------
# JSONL exporter
# ---------------------------------------------------------------------------


class JsonlExporter:
    """Background-flushed JSONL sink under ``directory``."""

    def __init__(self, directory: str, flush_interval_s: float = 0.5):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        pid = os.getpid()
        self.span_path = os.path.join(directory, f"spans-{pid}.jsonl")
        self.metrics_path = os.path.join(directory, f"metrics-{pid}.jsonl")
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._flush_interval = float(flush_interval_s)
        self._closed = False
        self._io_lock = _locks.make_lock("telemetry.export_io")
        self._wake = threading.Event()
        self._unsink = _trace.add_sink(self._on_span)
        self._unhook = self._register_preemption()
        self._flusher = threading.Thread(
            target=self._flusher_loop, name="skylark-telemetry-flusher",
            daemon=True)
        self._flusher.start()

    def _register_preemption(self):
        """A preempted serving process must not lose its tail spans:
        the final synchronous flush rides the resilience teardown
        (after the serve drain resolves the in-flight futures — hook
        order — so the drained flush spans are in the file)."""
        try:
            from libskylark_tpu_torch.resilience.preemption import on_preemption

            return on_preemption(self.flush_sync)
        except Exception:  # pragma: no cover - resilience always present
            return lambda: None

    # -- span intake (hot path: enqueue only) --

    def _on_span(self, span) -> None:
        if not self._closed:
            self._q.put(span.to_dict())

    # -- flushing --

    def _drain(self) -> list:
        docs = []
        while True:
            try:
                docs.append(self._q.get_nowait())
            except queue.Empty:
                return docs

    def _write_spans(self, docs: list) -> None:
        if not docs:
            return
        with self._io_lock:
            with open(self.span_path, "a") as fh:
                for doc in docs:
                    fh.write(json.dumps(doc, sort_keys=True,
                                        default=str) + "\n")

    def _flusher_loop(self) -> None:
        while not self._closed:
            self._wake.wait(timeout=self._flush_interval)
            self._wake.clear()
            try:
                self._write_spans(self._drain())
            except Exception:  # noqa: BLE001 — exporter never kills work
                pass

    def flush_sync(self) -> None:
        """Drain every queued span and append a metrics-snapshot line,
        synchronously (preemption teardown / atexit / tests)."""
        try:
            self._write_spans(self._drain())
            with self._io_lock:
                with open(self.metrics_path, "a") as fh:
                    fh.write(json.dumps(
                        {"kind": "metrics", "t_wall": round(time.time(), 6),
                         "snapshot": _metrics.snapshot()},
                        sort_keys=True, default=str) + "\n")
        except Exception:  # noqa: BLE001
            pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._unsink()
        try:
            self._unhook()
        except Exception:  # pragma: no cover
            pass
        self._wake.set()
        self._flusher.join(timeout=5.0)
        self.flush_sync()


_EXPORTER: Optional[JsonlExporter] = None
_EXPORTER_LOCK = _locks.make_lock("telemetry.exporter")


def install_exporter(directory: Optional[str] = None) -> Optional[JsonlExporter]:
    """Install (or return) the process JSONL exporter. ``directory``
    defaults to ``SKYLARK_TELEMETRY_DIR``; returns ``None`` when
    neither names a directory. Idempotent: one exporter per process
    (a second call with a different directory closes the first)."""
    global _EXPORTER
    directory = directory or _env.TELEMETRY_DIR.get()
    if not directory:
        return None
    with _EXPORTER_LOCK:
        if _EXPORTER is not None:
            if _EXPORTER.directory == directory and not _EXPORTER._closed:
                return _EXPORTER
            _EXPORTER.close()
        _EXPORTER = JsonlExporter(directory)
        return _EXPORTER


def get_exporter() -> Optional[JsonlExporter]:
    return _EXPORTER


def shutdown_exporter() -> None:
    """Close the process exporter (tests; reconfiguration)."""
    global _EXPORTER
    with _EXPORTER_LOCK:
        if _EXPORTER is not None:
            _EXPORTER.close()
            _EXPORTER = None


@atexit.register
def _atexit_flush() -> None:  # pragma: no cover - process teardown
    ex = _EXPORTER
    if ex is not None and not ex._closed:
        ex.flush_sync()


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _prom_name(*parts: str) -> str:
    out = "_".join(p for p in parts if p)
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in out)
    if not out or not (out[0].isalpha() or out[0] == "_"):
        out = "_" + out
    return "skylark_" + out


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    items = []
    for k, v in sorted(merged.items()):
        v = str(v).replace("\\", "\\\\").replace('"', '\\"')
        v = v.replace("\n", "\\n")
        items.append(f'{k}="{v}"')
    return "{" + ",".join(items) + "}"


def _prom_number(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _flatten_numeric(doc: dict, prefix: str, out: list) -> None:
    for k, v in sorted(doc.items()):
        if str(k).startswith("by_") and isinstance(v, dict):
            continue       # labeled sub-blocks render separately
        key = f"{prefix}_{k}" if prefix else str(k)
        if isinstance(v, bool):
            out.append((key, 1.0 if v else 0.0))
        elif isinstance(v, (int, float)):
            out.append((key, float(v)))
        elif isinstance(v, dict):
            _flatten_numeric(v, key, out)
        # strings / lists / None: not scrape-able scalars — skip


def _labeled_blocks(doc: dict, prefix: str = ""):
    """Yield ``(key_prefix, label, member, block)`` for every
    ``by_<label>`` convention sub-dict in a collector block: a dict
    named ``by_replica`` (say) maps member name -> numeric sub-block,
    and renders as ``{replica="<member>"}``-labeled gauges instead of
    flattening the member name into the metric name — the per-replica
    disaggregation contract of ``serve_stats()``."""
    for k, v in sorted(doc.items()):
        if not isinstance(v, dict):
            continue
        key = f"{prefix}_{k}" if prefix else str(k)
        if str(k).startswith("by_") and len(str(k)) > 3:
            label = str(k)[3:]
            for member, block in sorted(v.items()):
                if isinstance(block, dict):
                    yield prefix, label, str(member), block
        else:
            yield from _labeled_blocks(v, key)


def prometheus_text() -> str:
    """The registry + collector adapters in Prometheus text format."""
    return _render(_metrics.snapshot())


def _render(snap: dict) -> str:
    """A :func:`~libskylark_tpu_torch.telemetry.snapshot` document in
    Prometheus text format."""
    lines: list[str] = []

    for name, doc in snap["metrics"].items():
        kind = doc["type"]
        base = _prom_name(name.replace(".", "_"))
        if kind == "counter":
            base += "_total"
        if doc.get("help"):
            lines.append(f"# HELP {base} {doc['help']}")
        lines.append(f"# TYPE {base} "
                     f"{'gauge' if kind == 'gauge' else kind}")
        if kind == "histogram":
            buckets = doc["buckets"]
            for cell in doc["values"]:
                labels = cell["labels"]
                cum = 0
                for b, c in zip(buckets, cell["counts"]):
                    cum += c
                    lines.append(
                        f"{base}_bucket"
                        f"{_prom_labels(labels, {'le': _prom_number(b)})}"
                        f" {cum}")
                cum += cell["counts"][-1]
                lines.append(
                    f"{base}_bucket{_prom_labels(labels, {'le': '+Inf'})}"
                    f" {cum}")
                lines.append(f"{base}_sum{_prom_labels(labels)}"
                             f" {_prom_number(cell['sum'])}")
                lines.append(f"{base}_count{_prom_labels(labels)} {cum}")
        else:
            for cell in doc["values"]:
                lines.append(f"{base}{_prom_labels(cell['labels'])}"
                             f" {_prom_number(cell['value'])}")

    # collector adapters: every numeric leaf becomes a gauge under the
    # collector's namespace — the re-homed engine/serve/resilience/...
    # counters on one scrape surface. ``by_<label>`` sub-blocks render
    # as label sets (one series per replica), not name-mangled gauges.
    for cname, block in snap["collectors"].items():
        if not isinstance(block, dict):
            continue
        # group every series by metric family FIRST: the exposition
        # format requires all lines of a family contiguous under one
        # TYPE line — an aggregate gauge and its labeled per-replica
        # series are ONE family, and interleaving families fails
        # strict parsers (promtool/OpenMetrics)
        families: dict = {}     # base -> [(labels-or-None, value)]
        flat: list = []
        _flatten_numeric(block, "", flat)
        for key, value in flat:
            base = _prom_name(cname.replace(".", "_"),
                              key.replace(".", "_"))
            families.setdefault(base, []).append((None, value))
        for kprefix, label, member, sub in _labeled_blocks(block):
            flat = []
            _flatten_numeric(sub, "", flat)
            for key, value in flat:
                base = _prom_name(cname.replace(".", "_"),
                                  (f"{kprefix}_{key}" if kprefix
                                   else key).replace(".", "_"))
                families.setdefault(base, []).append(
                    ({label: member}, value))
        for base in sorted(families):
            lines.append(f"# TYPE {base} gauge")
            for lbls, value in families[base]:
                lines.append(
                    f"{base}{_prom_labels(lbls) if lbls else ''}"
                    f" {_prom_number(value)}")

    return "\n".join(lines) + ("\n" if lines else "")


__all__ = [
    "JsonlExporter", "get_exporter", "install_exporter",
    "prometheus_text", "shutdown_exporter",
]
