"""Process-wide metrics registry: named counters and gauges (the port of
the counters and gauges of libskylark_tpu/telemetry/metrics.py, which the
ML layer records to).

A disabled ``inc``/``set`` is one call and one branch: nothing is
recorded, and callers gate any host read of a device value on
:func:`enabled`. Enablement: ``SKYLARK_TELEMETRY`` (any value but empty or
``0``) or ``SKYLARK_TELEMETRY_DIR`` set, read once, or :func:`set_enabled`.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """Whether telemetry recording is on."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = (os.environ.get("SKYLARK_TELEMETRY", "") not in ("", "0")
                    or bool(os.environ.get("SKYLARK_TELEMETRY_DIR")))
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic switch (overrides the environment)."""
    global _ENABLED
    _ENABLED = bool(on)


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """Name, help text and a lock-guarded value per label set.
    ``registry`` is the reference's parameter (the registry that made the
    metric); a port registry finds its metrics by name, so it is not
    kept."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 registry: "Optional[MetricsRegistry]" = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(_label_key(labels))

    def to_dict(self) -> dict:
        """{"type", "help", "values": [{"labels", "value"}, ...]}."""
        with self._lock:
            return {"type": self.kind, "help": self.help,
                    "values": [{"labels": dict(k), "value": v}
                               for k, v in sorted(self._values.items())]}

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(Metric):
    """A monotonically increasing count."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if not enabled():
            return
        self.inc_always(n, **labels)

    def inc_always(self, n: float = 1, **labels) -> None:
        """Record whatever the global switch says."""
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + n

    def value(self, **labels) -> float:
        """The count (0 before the first ``inc``)."""
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Gauge(Metric):
    """A value that goes up and down (the last objective)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not enabled():
            return
        self.set_always(v, **labels)

    def set_always(self, v: float, **labels) -> None:
        """Record whatever the global switch says."""
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def add(self, n: float = 1, **labels) -> None:
        if not enabled():
            return
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + n


class MetricsRegistry:
    """Get-or-create store of instruments, idempotent by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str,
                       help: str) -> Metric:  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, registry=self)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._get_or_create(Gauge, name, help)


_REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:  # noqa: A002
    return _REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:  # noqa: A002
    return _REGISTRY.gauge(name, help)
