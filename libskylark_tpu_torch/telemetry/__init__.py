"""Telemetry: the metrics registry that the ML layer records to (the
counters and gauges of libskylark_tpu/telemetry/metrics.py; its exporters,
spans and Prometheus surface are not ported)."""

from libskylark_tpu_torch.telemetry import metrics

__all__ = ["metrics"]
