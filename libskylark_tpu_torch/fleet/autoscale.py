"""Queue-depth autoscaler: elastic replica count under live load (the port
of libskylark_tpu/fleet/autoscale.py).

A fixed-N :class:`~libskylark_tpu_torch.fleet.pool.ReplicaPool` makes the
operator size for the peak: idle replicas hold memory (a process replica
is a whole interpreter and a CUDA context) and an undersized fleet sheds.
The :class:`Autoscaler` closes the loop with the fleet's two mechanisms:

- **scale-up is the pack boot**:
  :meth:`~libskylark_tpu_torch.fleet.pool.ReplicaPool.add_replica` builds
  the new replica from the pool's warmup pack, so added capacity serves
  its packed buckets with no capture during traffic;
- **scale-down is the SIGTERM drain**:
  :meth:`~libskylark_tpu_torch.fleet.pool.ReplicaPool.remove_replica`
  preempts the victim (a real SIGTERM for a process replica), the hub
  announces DRAINING before its queue empties, the router sheds its
  traffic, in-flight futures resolve and its drain hooks fire.

The control signal is each replica's queue depth (queued and in-flight
requests, the number the router's spill rule reads) and the shed evidence
of a subscribed router (a refusal at a replica's shed bound is a router
failover). The loop is hysteretic:

- scale **up** when the mean depth per replica holds at or above
  ``up_depth`` (or sheds appear) for ``up_ticks`` consecutive ticks;
- scale **down** when it holds at or below ``down_depth`` with no sheds
  for ``down_ticks`` consecutive ticks;
- never outside ``[min_replicas, max_replicas]``, and never within
  ``cooldown_s`` of the previous scale event.

Ticks run on one daemon thread; a scale event blocks it (a process
replica's boot takes seconds), which is itself a hysteresis.
"""

from __future__ import annotations

import itertools
import threading
import time
import warnings
import weakref
from typing import Optional

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.fleet.pool import ReplicaPool
from libskylark_tpu_torch.telemetry import metrics as _metrics

_UP = _metrics.counter(
    "fleet.autoscale_up", "Replicas added by the autoscaler")
_DOWN = _metrics.counter(
    "fleet.autoscale_down", "Replicas drained away by the autoscaler")
_REPLICAS = _metrics.gauge(
    "fleet.replicas", "Live replica count of an autoscaled pool, by "
    "scaler (one process can autoscale several pools)")

_SCALERS: "weakref.WeakSet[Autoscaler]" = weakref.WeakSet()
_SCALER_SEQ = itertools.count()

# process-lifetime rollup: scale events outlive their Autoscaler
_LIFETIME = _metrics.LifetimeCounter(
    "fleet.autoscale_life", kinds=("scale_ups", "scale_downs"))


class Autoscaler:
    """Controller thread scaling a :class:`ReplicaPool` between
    ``min_replicas`` and ``max_replicas`` (see module doc).

    ::

        pool = fleet.ReplicaPool(2, backend="process",
                                 warmup_pack=pack_dir, max_batch=16)
        router = fleet.Router(pool)
        scaler = fleet.Autoscaler(pool, router,
                                  min_replicas=2, max_replicas=8)
        ...
        scaler.close(); router.close(); pool.shutdown()

    ``router`` is optional: its failover counter is the shed evidence that
    lets the controller react to refusals when queue depths look tame.
    Every unset knob defaults from ``SKYLARK_FLEET_AUTOSCALE_*``.
    """

    def __init__(self, pool: ReplicaPool, router=None, *,
                 name: Optional[str] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 up_depth: Optional[int] = None,
                 down_depth: Optional[int] = None,
                 up_ticks: int = 2, down_ticks: int = 8,
                 cooldown_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 drain_timeout: float = 30.0,
                 start: bool = True):
        self.pool = pool
        self.router = router
        # the gauge's label: two autoscaled pools in one process must not
        # overwrite each other's count
        self.name = str(name) if name else f"as{next(_SCALER_SEQ)}"
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else _env.FLEET_AUTOSCALE_MIN.get())
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else _env.FLEET_AUTOSCALE_MAX.get())
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{self.min_replicas}, {self.max_replicas}]")
        self.up_depth = int(up_depth if up_depth is not None
                            else _env.FLEET_AUTOSCALE_UP_DEPTH.get())
        self.down_depth = int(
            down_depth if down_depth is not None
            else _env.FLEET_AUTOSCALE_DOWN_DEPTH.get())
        self.up_ticks = max(int(up_ticks), 1)
        self.down_ticks = max(int(down_ticks), 1)
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else _env.FLEET_AUTOSCALE_COOLDOWN.get())
        self.interval_s = float(
            interval_s if interval_s is not None
            else _env.FLEET_AUTOSCALE_INTERVAL.get())
        self.drain_timeout = float(drain_timeout)
        self._cond = threading.Condition(
            _locks.make_lock("fleet.autoscale"))
        self._stats_lock = _locks.make_lock("fleet.autoscale_stats")
        self._stop = False
        self._up_run = 0
        self._down_run = 0
        self._last_event = 0.0          # monotonic stamp of the last scale
        self._failover_seen = 0
        self._counts = {"scale_ups": 0, "scale_downs": 0, "ticks": 0}
        self._events: list = []
        self._added: list = []          # LIFO scale-down preference
        self._thread: Optional[threading.Thread] = None
        _SCALERS.add(self)
        _REPLICAS.set(len(pool.names()), scaler=self.name)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="skylark-fleet-autoscaler",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the controller (the pool keeps its current size)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=self.drain_timeout + 10.0)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- control loop --------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                self._cond.wait(timeout=self.interval_s)
                if self._stop:
                    return
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the controller lives
                warnings.warn(f"autoscaler tick failed: {e}",
                              RuntimeWarning, stacklevel=1)

    def _shed_delta(self) -> int:
        """New router failovers since the last tick: the shed evidence."""
        if self.router is None:
            return 0
        seen = int(self.router.stats().get("failover", 0))
        delta = seen - self._failover_seen
        self._failover_seen = seen
        return max(delta, 0)

    def _tick(self) -> None:
        pool = self.pool
        names = pool.names()
        n = len(names)
        if n == 0:
            return
        depth = 0
        for name in names:
            try:
                depth += pool.get(name).queue_depth()
            except KeyError:
                continue               # removed mid-walk
        mean = depth / n
        shed = self._shed_delta()
        with self._stats_lock:
            self._counts["ticks"] += 1
        up_sig = mean >= self.up_depth or shed > 0
        down_sig = mean <= self.down_depth and shed == 0
        self._up_run = self._up_run + 1 if up_sig else 0
        self._down_run = self._down_run + 1 if down_sig else 0
        now = time.monotonic()
        if now - self._last_event < self.cooldown_s:
            return
        if n < self.min_replicas:
            # below the floor (a crashed member was reaped, or something
            # removed one): replace it now by a pack boot, no depth run-up
            # needed; the cooldown still paces a failing boot
            self._scale_up(mean, shed)
        elif (self._up_run >= self.up_ticks
                and n < self.max_replicas):
            self._scale_up(mean, shed)
        elif (self._down_run >= self.down_ticks
              and n > self.min_replicas):
            self._scale_down(mean)

    def _record(self, kind: str, name: str, mean: float,
                shed: int) -> None:
        with self._stats_lock:
            self._counts["scale_ups" if kind == "up"
                         else "scale_downs"] += 1
            self._events.append({
                "kind": kind, "replica": name,
                "mean_depth": round(mean, 2), "shed": shed,
                "replicas": len(self.pool.names()),
            })
            del self._events[:-32]
        _REPLICAS.set(len(self.pool.names()), scaler=self.name)

    def _scale_up(self, mean: float, shed: int) -> None:
        # stamped before the boot: a boot that keeps failing gets the
        # same cooldown as a success
        self._last_event = time.monotonic()
        self._up_run = self._down_run = 0
        name = self.pool.add_replica()   # pack boot (pool.warmup_pack)
        self._added.append(name)
        _UP.inc()
        _LIFETIME.inc("scale_ups")
        self._record("up", name, mean, shed)

    def _scale_down(self, mean: float) -> None:
        # un-grow what we grew (LIFO), else the highest name in natural
        # order ("r10" after "r9")
        names = set(self.pool.names())
        victim = None
        while self._added:
            cand = self._added.pop()
            if cand in names:
                victim = cand
                break
        if victim is None:
            victim = max(names, key=lambda n: (len(n), n))
        self._last_event = time.monotonic()
        self._up_run = self._down_run = 0
        self.pool.remove_replica(victim, timeout=self.drain_timeout)
        _DOWN.inc()
        _LIFETIME.inc("scale_downs")
        self._record("down", victim, mean, 0)

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            c = dict(self._counts)
            events = list(self._events)
        return {
            "replicas": len(self.pool.names()),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "scale_ups": c["scale_ups"],
            "scale_downs": c["scale_downs"],
            "ticks": c["ticks"],
            "events": events,
        }


def autoscale_stats() -> dict:
    """Rollup over every live autoscaler and the process-lifetime scale
    totals (folded into the ``fleet`` collector by
    :func:`libskylark_tpu_torch.fleet.router.fleet_stats`)."""
    agg = {"scalers": 0, "scale_ups": 0, "scale_downs": 0,
           "replicas": 0}
    for scaler in list(_SCALERS):
        s = scaler.stats()
        agg["scalers"] += 1
        agg["scale_ups"] += s["scale_ups"]
        agg["scale_downs"] += s["scale_downs"]
        agg["replicas"] += s["replicas"]
    agg.update(_LIFETIME.snapshot())
    return agg


__all__ = ["Autoscaler", "autoscale_stats"]
