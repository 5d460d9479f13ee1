"""Telemetry: the metrics registry that the ML layer records to (the
counters and gauges of libskylark_tpu/telemetry/metrics.py; its
histograms, collectors, exporters, spans and Prometheus surface are not
ported)."""

from libskylark_tpu_torch.telemetry import metrics
from libskylark_tpu_torch.telemetry.metrics import (Counter, Gauge,
                                                    MetricsRegistry, counter,
                                                    enabled, gauge,
                                                    set_enabled)

__all__ = ["metrics", "Counter", "Gauge", "MetricsRegistry", "counter",
           "gauge", "enabled", "set_enabled"]
