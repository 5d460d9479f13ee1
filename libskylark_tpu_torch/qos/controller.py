"""Adaptive batching: per-bucket linger and batch targets tuned from the
live latency and padding-waste observations against the class SLOs (the
port of libskylark_tpu/qos/controller.py).

Each tick (``SKYLARK_QOS_ADAPT_INTERVAL``), each bucket with enough fresh
completions is scored against the strictest p99 SLO among the classes
whose traffic it carried:

- **over the SLO**: the linger target halves (floor 0: flush at once)
  and the batch target steps one rung down the bucket's warm capacity
  ladder;
- **under half the SLO with padding waste above the threshold**: linger
  grows 1.5x (capped at 8x the static config) and the batch target steps
  one rung up;
- two consecutive ticks must agree before a change applies, and each
  change is one bounded step.

The controller moves only the linger and batch targets: which requests
share a flush, never what a lane computes. Every lane of a flush runs the
same program at any capacity and a lane's bits do not depend on its
cohort (ROADMAP C15), so adaptation cannot change a result. Batch targets
move only along the capacities the bucket has flushed at.

``SKYLARK_QOS_ADAPT=0`` freezes every controller (a tick only counts
itself).
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict, Optional

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.qos import tenants as _tenants
from libskylark_tpu_torch.telemetry import metrics as _metrics

# the live targets, labeled by replica and endpoint
_LINGER_TARGET = _metrics.gauge(
    "qos.linger_target",
    "Adaptive per-bucket linger target (seconds), by replica and "
    "endpoint")
_BATCH_TARGET = _metrics.gauge(
    "qos.batch_target",
    "Adaptive per-bucket cohort-size target (requests), by replica "
    "and endpoint")

#: Linger ceiling as a multiple of the executor's static config.
LINGER_CEILING_FACTOR = 8.0

#: Padding-waste ratio above which latency headroom is traded for
#: denser batching.
WASTE_THRESHOLD = 0.3

#: Consecutive same-direction ticks required before a change applies.
HYSTERESIS_TICKS = 2

#: Fresh completions a bucket needs between ticks to be scored.
MIN_SAMPLES = 4


class AdaptiveController:
    """One executor's adaptive batching loop (module doc). Owned and
    started by :class:`~libskylark_tpu_torch.engine.serve.
    MicrobatchExecutor` when built with ``adaptive=True``; stopped from
    the executor's shutdown."""

    def __init__(self, executor, interval_s: Optional[float] = None,
                 start: bool = True):
        self._ex = executor
        self.interval_s = float(
            interval_s if interval_s is not None
            else _env.QOS_ADAPT_INTERVAL.get())
        self._cond = threading.Condition(
            _locks.make_lock("qos.controller"))
        self._stats_lock = _locks.make_lock("qos.controller_stats")
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # per-bucket controller memory: consecutive trend direction,
        # completions already scored, last applied targets
        self._trend: Dict[tuple, int] = {}
        self._seen_n: Dict[tuple, int] = {}
        self._counts = {"ticks": 0, "frozen_ticks": 0,
                        "linger_down": 0, "linger_up": 0,
                        "batch_down": 0, "batch_up": 0}
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop,
            name=f"skylark-qos-controller-{self._ex.name}", daemon=True)
        self._thread.start()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                self._cond.wait(timeout=self.interval_s)
                if self._stop:
                    return
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — controller lives
                warnings.warn(f"qos controller tick failed: {e}",
                              RuntimeWarning, stacklevel=1)

    # -- the control decision ------------------------------------------

    def tick(self) -> int:
        """Score every active bucket once; returns how many target
        changes were applied (tests drive this synchronously). A
        no-op (beyond counting) when ``SKYLARK_QOS_ADAPT=0``."""
        with self._stats_lock:
            self._counts["ticks"] += 1
        if not _env.QOS_ADAPT.get():
            with self._stats_lock:
                self._counts["frozen_ticks"] += 1
            return 0
        changes = 0
        obs = self._ex.qos_bucket_obs()
        for statics, o in obs.items():
            changes += self._score_bucket(statics, o)
        return changes

    def _score_bucket(self, statics: tuple, o: dict) -> int:
        n = int(o.get("n", 0))
        if n - self._seen_n.get(statics, 0) < MIN_SAMPLES:
            return 0
        self._seen_n[statics] = n
        p99 = o.get("p99")
        if p99 is None:
            return 0
        slo = min((_tenants.slo_seconds(c)
                   for c in (o.get("classes") or ("standard",))),
                  default=_tenants.slo_seconds("standard"))
        waste = o.get("padding_waste") or 0.0
        if p99 > slo:
            direction = -1            # too slow: batch less, flush sooner
        elif p99 < 0.5 * slo and waste > WASTE_THRESHOLD:
            direction = +1            # headroom + waste: batch denser
        else:
            direction = 0
        prev = self._trend.get(statics, 0)
        trend = (prev + direction
                 if direction and (prev == 0
                                   or (prev > 0) == (direction > 0))
                 else direction)
        self._trend[statics] = trend
        if direction == 0 or abs(trend) < HYSTERESIS_TICKS:
            return 0
        self._trend[statics] = 0       # acted: restart the hysteresis
        return self._apply(statics, o, direction)

    def _apply(self, statics: tuple, o: dict, direction: int) -> int:
        ex = self._ex
        linger, cap = ex.bucket_targets(statics)
        warm = sorted(int(c) for c in (o.get("caps") or ()))
        changed = 0
        if direction < 0:
            new_linger = 0.0 if linger < 1e-4 else linger * 0.5
            lower = [c for c in warm if c < cap]
            new_cap = lower[-1] if lower else cap
            key_l, key_b = "linger_down", "batch_down"
        else:
            new_linger = min(max(linger * 1.5, 1e-4),
                             ex.linger * LINGER_CEILING_FACTOR)
            higher = [c for c in warm
                      if cap < c <= ex.max_batch]
            new_cap = higher[0] if higher else cap
            key_l, key_b = "linger_up", "batch_up"
        if new_linger != linger:
            changed += 1
            with self._stats_lock:
                self._counts[key_l] += 1
        if new_cap != cap:
            changed += 1
            with self._stats_lock:
                self._counts[key_b] += 1
        if changed:
            ex.set_bucket_targets(statics, linger_s=new_linger,
                                  batch_cap=new_cap)
            # drop the evidence that triggered the step: the next
            # decision must score POST-change traffic, or the same
            # burst keeps driving same-direction steps for a whole
            # window length after latency recovered
            ex.qos_reset_bucket_obs(statics)
            endpoint = str(statics[0]) if statics else "?"
            _LINGER_TARGET.set(new_linger, replica=ex.name,
                               endpoint=endpoint)
            _BATCH_TARGET.set(float(new_cap), replica=ex.name,
                              endpoint=endpoint)
        return changed

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            c = dict(self._counts)
        c["adjustments"] = (c["linger_down"] + c["linger_up"]
                            + c["batch_down"] + c["batch_up"])
        c["frozen"] = not _env.QOS_ADAPT.get()
        c["interval_s"] = self.interval_s
        return c


__all__ = ["AdaptiveController", "HYSTERESIS_TICKS",
           "LINGER_CEILING_FACTOR", "MIN_SAMPLES", "WASTE_THRESHOLD"]
