"""The port's queue-depth autoscaler (``libskylark_tpu_torch/fleet/
autoscale.py``) and the elastic pool membership under it, against the
reference's contract (``tests/test_fleet_autoscale.py``), on the CPU.

Oracles:

- *the same decisions*: both packages' ``Autoscaler._tick``, driven over
  one fixed trace of queue depths and router failovers against stub
  pools, make the same scale events (kind, replica, mean depth, shed,
  pool size) in the same order;
- *scale-up under load*: a queued storm grows the pool and the subscribed
  router's ring (the hub's SERVING publish), with every result
  ``torch.equal`` to one executor's; *scale-down at idle*: sustained
  idleness drains a replica away back to the floor (LIFO);
- *hysteresis*: never below ``min_replicas`` or above ``max_replicas``,
  and one event at most inside the cooldown.

Every decision test drives ``_tick`` directly on a controller built with
``start=False`` and holds the queue by a long linger, so no count depends
on how fast a loaded host drains (the reference times a live storm).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libskylark_tpu import fleet as rfleet
from libskylark_tpu_torch import Context, engine, fleet
from libskylark_tpu_torch import sketch as sk

DEV = "cpu"


def _workload(n_reqs=8, n=40, s_dim=16, seed=0):
    rng = np.random.default_rng(seed)
    T = sk.CWT(n, s_dim, Context(seed=seed))
    ops = [rng.standard_normal((n, 3 + i % 4)).astype(np.float32)
           for i in range(n_reqs)]
    ex = engine.MicrobatchExecutor(max_batch=8, linger_us=500, device=DEV)
    try:
        refs = [ex.submit_sketch(T, A).result(timeout=60) for A in ops]
    finally:
        ex.shutdown()
    return T, ops, refs


class _StubReplica:
    def __init__(self, depth):
        self.depth = depth

    def queue_depth(self):
        return self.depth[0]


class _StubPool:
    """Names, depths and the two membership verbs; every replica reports
    the trace's current depth."""

    def __init__(self, n):
        self.depth = [0]
        self._names = [f"r{i}" for i in range(n)]
        self._next = n

    def names(self):
        return list(self._names)

    def get(self, name):
        if name not in self._names:
            raise KeyError(name)
        return _StubReplica(self.depth)

    def add_replica(self):
        name = f"r{self._next}"
        self._next += 1
        self._names.append(name)
        return name

    def remove_replica(self, name, timeout=None):
        self._names.remove(name)
        return True


class _StubRouter:
    def __init__(self):
        self.failover = 0

    def stats(self):
        return {"failover": self.failover}


# (depth per replica, router failovers so far) per tick
_TRACE = ([(0, 0)] * 3 + [(9, 0)] * 3 + [(12, 0), (3, 0), (3, 2)]
          + [(0, 2)] * 10 + [(8, 5), (0, 5)] + [(0, 5)] * 12)


def _events(fleet_mod, **kw):
    pool, router = _StubPool(2), _StubRouter()
    scaler = fleet_mod.Autoscaler(pool, router, start=False, **kw)
    for depth, failover in _TRACE:
        pool.depth[0] = depth
        router.failover = failover
        scaler._tick()
    return scaler.stats()


@pytest.mark.parametrize("knobs", [
    dict(min_replicas=2, max_replicas=4, up_depth=8, down_depth=1,
         up_ticks=2, down_ticks=4, cooldown_s=0.0),
    dict(min_replicas=1, max_replicas=3, up_depth=4, down_depth=0,
         up_ticks=1, down_ticks=2, cooldown_s=0.0),
    dict(min_replicas=3, max_replicas=5, up_depth=10, down_depth=2,
         up_ticks=3, down_ticks=8, cooldown_s=0.0),
])
def test_scale_events_equal_the_references(knobs):
    mine, ref = _events(fleet, **knobs), _events(rfleet, **knobs)
    assert mine["events"] == ref["events"]
    assert mine["events"], "the trace must scale"
    assert (mine["scale_ups"], mine["scale_downs"], mine["replicas"],
            mine["ticks"]) == (ref["scale_ups"], ref["scale_downs"],
                               ref["replicas"], ref["ticks"])


class TestPoolMembership:
    def test_add_replica_joins_router_ring(self):
        pool = fleet.ReplicaPool(1, max_batch=4, linger_us=1000,
                                 device=DEV)
        router = fleet.Router(pool)
        try:
            assert router.routable() == ["r0"]
            name = pool.add_replica()
            assert name == "r1"
            assert pool.names() == ["r0", "r1"]
            # the SERVING publish reached the router before add returned
            assert name in router.routable()
            T, ops, refs = _workload(4)
            for A, want in zip(ops, refs):
                assert torch.equal(
                    router.submit_sketch(T, A).result(timeout=60), want)
        finally:
            router.close()
            pool.shutdown()

    def test_remove_replica_drains_and_fires_hooks(self):
        pool = fleet.ReplicaPool(2, max_batch=4, linger_us=1000,
                                 device=DEV)
        router = fleet.Router(pool)
        hooks = []
        pool.on_replica_drain("r1", lambda: hooks.append("r1"))
        try:
            assert pool.remove_replica("r1")
            assert hooks == ["r1"]
            assert pool.names() == ["r0"]
            assert "r1" not in router.routable()
            with pytest.raises(KeyError):
                pool.remove_replica("r1")
            T, ops, refs = _workload(2)
            assert torch.equal(
                router.submit_sketch(T, ops[0]).result(timeout=60),
                refs[0])
        finally:
            router.close()
            pool.shutdown()

    def test_duplicate_add_rejected(self):
        pool = fleet.ReplicaPool(1, max_batch=4, linger_us=1000,
                                 device=DEV)
        try:
            with pytest.raises(ValueError):
                pool.add_replica("r0")
        finally:
            pool.shutdown()


class TestAutoscaler:
    def test_storm_scales_up_idle_scales_down(self):
        T, ops, refs = _workload(6)
        pool = fleet.ReplicaPool(1, max_batch=8, linger_us=30_000_000,
                                 device=DEV)
        router = fleet.Router(pool)
        scaler = fleet.Autoscaler(
            pool, router, min_replicas=1, max_replicas=2, up_depth=2,
            down_depth=1, up_ticks=1, down_ticks=3, cooldown_s=0.0,
            start=False)
        try:
            # the long linger holds the storm (under a full cohort) queued
            # on the owner
            futs = [router.submit_sketch(T, A) for A in ops]
            scaler._tick()
            assert pool.names() == ["r0", "r1"]
            assert router.routable() == ["r0", "r1"]
            pool.flush()
            for f, want in zip(futs, refs):
                assert torch.equal(f.result(timeout=60), want)
            for _ in range(2):
                scaler._tick()
                assert len(pool.names()) == 2   # not yet: 3 idle ticks
            scaler._tick()
            assert pool.names() == ["r0"]
            st = scaler.stats()
            assert (st["scale_ups"], st["scale_downs"]) == (1, 1)
            assert [e["kind"] for e in st["events"]] == ["up", "down"]
            assert st["events"][1]["replica"] == "r1"   # LIFO
            assert st["replicas"] == 1
            assert router.routable() == ["r0"]
            out = router.submit_sketch(T, ops[0])
            pool.flush()
            assert torch.equal(out.result(timeout=60), refs[0])
        finally:
            scaler.close()
            router.close()
            pool.shutdown()

    def test_bounds_and_cooldown(self):
        T, ops, _ = _workload(3)
        pool = fleet.ReplicaPool(1, max_batch=4, linger_us=30_000_000,
                                 device=DEV)
        router = fleet.Router(pool)
        scaler = fleet.Autoscaler(
            pool, router, min_replicas=1, max_replicas=2, up_depth=1,
            down_depth=0, up_ticks=1, down_ticks=1, cooldown_s=600.0,
            start=False)
        try:
            futs = [router.submit_sketch(T, A) for A in ops]
            for _ in range(5):
                scaler._tick()
            st = scaler.stats()
            assert st["scale_ups"] == 1, "cooldown was ignored"
            assert st["ticks"] == 5 and len(pool.names()) == 2
            pool.flush()
            [f.result(timeout=60) for f in futs]
        finally:
            scaler.close()
            router.close()
            pool.shutdown()

    def test_never_below_min_and_refills_the_floor(self):
        pool = fleet.ReplicaPool(2, max_batch=4, linger_us=1000,
                                 device=DEV)
        scaler = fleet.Autoscaler(
            pool, None, min_replicas=2, max_replicas=3, up_depth=100,
            down_depth=5, up_ticks=1, down_ticks=1, cooldown_s=0.0,
            start=False)
        try:
            for _ in range(10):
                scaler._tick()
            assert len(pool.names()) == 2
            assert scaler.stats()["scale_downs"] == 0
            # an external removal leaves the pool below its floor: the
            # next tick refills it without any load signal
            pool.remove_replica("r1")
            scaler._tick()
            assert pool.names() == ["r0", "r2"]
            assert scaler.stats()["scale_ups"] == 1
        finally:
            scaler.close()
            pool.shutdown()

    def test_the_controller_thread_ticks(self):
        pool = fleet.ReplicaPool(1, max_batch=4, device=DEV)
        scaler = fleet.Autoscaler(pool, None, min_replicas=1,
                                  max_replicas=1, interval_s=0.01)
        try:
            import time

            deadline = time.monotonic() + 30
            while (scaler.stats()["ticks"] < 3
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert scaler.stats()["ticks"] >= 3
        finally:
            scaler.close()
            pool.shutdown()

    def test_invalid_bounds_rejected(self):
        pool = fleet.ReplicaPool(1, max_batch=4, device=DEV)
        try:
            with pytest.raises(ValueError):
                fleet.Autoscaler(pool, min_replicas=3, max_replicas=2,
                                 start=False)
        finally:
            pool.shutdown()

    def test_env_defaults(self, monkeypatch):
        monkeypatch.setenv("SKYLARK_FLEET_AUTOSCALE_MIN", "2")
        monkeypatch.setenv("SKYLARK_FLEET_AUTOSCALE_MAX", "5")
        monkeypatch.setenv("SKYLARK_FLEET_AUTOSCALE_UP_DEPTH", "17")
        monkeypatch.setenv("SKYLARK_FLEET_AUTOSCALE_DOWN_DEPTH", "3")
        monkeypatch.setenv("SKYLARK_FLEET_AUTOSCALE_COOLDOWN", "9.5")
        monkeypatch.setenv("SKYLARK_FLEET_AUTOSCALE_INTERVAL", "0.5")
        pool = fleet.ReplicaPool(2, max_batch=4, device=DEV)
        scaler = fleet.Autoscaler(pool, start=False)
        try:
            assert (scaler.min_replicas, scaler.max_replicas) == (2, 5)
            assert (scaler.up_depth, scaler.down_depth) == (17, 3)
            assert scaler.cooldown_s == 9.5
            assert scaler.interval_s == 0.5
        finally:
            scaler.close()
            pool.shutdown()

    def test_collector_rollup(self):
        pool = fleet.ReplicaPool(1, max_batch=4, device=DEV)
        scaler = fleet.Autoscaler(pool, start=False, min_replicas=1,
                                  max_replicas=2)
        try:
            agg = fleet.fleet_stats()["autoscale"]
            assert agg["scalers"] >= 1
            assert "scale_ups" in agg and "scale_downs" in agg
        finally:
            scaler.close()
            pool.shutdown()
