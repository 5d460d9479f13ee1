"""Telemetry: the metrics registry (counters, gauges, histograms and
collectors under one :func:`snapshot`), structured request tracing
(spans with cross-thread handoff, each a ``torch.profiler`` range), and
the exporters (the JSONL sink under ``SKYLARK_TELEMETRY_DIR``,
auto-installed at first import when it is set, and the Prometheus
renderer); the port of libskylark_tpu/telemetry/."""

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.telemetry import metrics
from libskylark_tpu_torch.telemetry.metrics import (
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, counter,
    enabled, gauge, histogram, register_collector, registry, set_enabled,
    snapshot,
)
from libskylark_tpu_torch.telemetry.trace import (
    Span, SpanContext, add_event, add_sink, attach, clear_finished,
    current_span, finished_spans, get_context, new_request_id, span,
)
from libskylark_tpu_torch.telemetry.export import (
    JsonlExporter, get_exporter, install_exporter, prometheus_text,
    shutdown_exporter,
)

# the JSONL exporter installs itself when the environment names its
# directory: the first telemetry import wires the export path
if _env.TELEMETRY_DIR.get():
    install_exporter()

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "JsonlExporter",
    "MetricsRegistry", "get_exporter", "install_exporter",
    "prometheus_text", "shutdown_exporter",
    "Span", "SpanContext", "add_event", "add_sink", "attach",
    "clear_finished", "counter", "current_span", "enabled",
    "finished_spans", "gauge", "get_context", "histogram", "metrics",
    "new_request_id", "register_collector", "registry", "set_enabled",
    "snapshot", "span",
]
