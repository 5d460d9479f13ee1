"""Telemetry: the metrics registry (counters, gauges, histograms and
collectors under one :func:`snapshot`) and structured request tracing
(spans with cross-thread handoff, each a ``torch.profiler`` range); the
port of libskylark_tpu/telemetry/ but for its JSONL exporter and
Prometheus renderer (``export.py``, ROADMAP A7)."""

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

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "SpanContext", "add_event", "add_sink", "attach",
    "clear_finished", "counter", "current_span", "enabled",
    "finished_spans", "gauge", "get_context", "histogram", "metrics",
    "new_request_id", "register_collector", "registry", "set_enabled",
    "snapshot", "span",
]
