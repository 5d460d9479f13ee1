"""Hedged requests of the port's router (``libskylark_tpu_torch/fleet/
router.py``) against the reference's contract
(``tests/test_fleet_hedge.py``), on the CPU with thread replicas.

Oracles:

- *straggler rescue*: a primary held back resolves through the mirror,
  ``torch.equal`` to one executor's result, with ``hedged`` and
  ``hedge_wins`` counted once;
- *determinism guard*: in verify mode both attempts complete and compare
  equal (``hedge_mismatches`` stays 0), and a divergence is counted;
- *no false hedges*: a fleet whose delay no request can reach never
  mirrors; a one-replica fleet has no target;
- *no orphans*: every client future of a storm with held primaries
  resolves; the hedge delay is fixed, p99-derived, or read from the
  environment.

No count depends on timing: a primary is held by an event until the
mirror has settled the client (the reference holds it by a 0.5 s stall
fault and asserts wall times, which load can flip).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import wait as cf_wait

import numpy as np
import pytest
import torch

from libskylark_tpu_torch import Context, engine, fleet
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.fleet.replica import _resolve
from libskylark_tpu_torch.fleet.router import _same

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


def _until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def _warm_all(pool, T, A):
    for name in pool.names():
        pool.get(name).submit("sketch_apply", transform=T, A=A,
                              dimension=None).result(timeout=60)


class _Hold:
    """Holds back every future of one replica's ``submit`` until
    :meth:`release`: the replica computes, its caller waits."""

    def __init__(self, replica):
        self.gate = threading.Event()
        self.threads = []
        self._replica = replica
        self._submit = replica.submit
        replica.submit = self._held

    def _held(self, endpoint, **kw):
        inner = self._submit(endpoint, **kw)
        out: Future = Future()

        def forward():
            self.gate.wait(60)
            try:
                out.set_result(inner.result(timeout=60))
            except Exception as e:  # noqa: BLE001 — forwarded
                out.set_exception(e)

        t = threading.Thread(target=forward, daemon=True)
        self.threads.append(t)
        t.start()
        return out

    def release(self):
        self.gate.set()
        for t in self.threads:
            t.join(timeout=60)
        self._replica.submit = self._submit


def _owner(router, T, A):
    return router.owner_of("sketch_apply", transform=T, A=A,
                           dimension=None)


class TestHedging:
    def test_held_primary_rescued_by_mirror(self):
        T, ops, refs = _workload()
        pool = fleet.ReplicaPool(2, max_batch=8, linger_us=1000,
                                 device=DEV)
        router = fleet.Router(pool, hedge=True, hedge_delay_ms=20,
                              hedge_verify=True)
        try:
            _warm_all(pool, T, ops[0])
            hold = _Hold(pool.get(_owner(router, T, ops[0])))
            out = router.submit_sketch(T, ops[0]).result(timeout=60)
            assert torch.equal(out, refs[0])
            # the win is counted just after the client settles
            assert _until(lambda: router.stats()["hedge_wins"] == 1)
            assert router.stats()["hedged"] == 1
            # verify mode: the held primary completes and is compared
            hold.release()
            assert router.stats()["hedge_mismatches"] == 0
        finally:
            router.close()
            pool.shutdown()

    def test_healthy_fleet_never_hedges(self):
        T, ops, refs = _workload()
        pool = fleet.ReplicaPool(2, max_batch=8, linger_us=1000,
                                 device=DEV)
        router = fleet.Router(pool, hedge=True, hedge_delay_ms=600_000)
        try:
            _warm_all(pool, T, ops[0])
            futs = [router.submit_sketch(T, A) for A in ops]
            for f, want in zip(futs, refs):
                assert torch.equal(f.result(timeout=60), want)
            st = router.stats()
            assert st["hedged"] == 0 and st["hedge_wins"] == 0
        finally:
            router.close()
            pool.shutdown()

    def test_single_replica_hedge_is_noop(self):
        T, ops, refs = _workload()
        pool = fleet.ReplicaPool(1, max_batch=8, linger_us=1000,
                                 device=DEV)
        router = fleet.Router(pool, hedge=True, hedge_delay_ms=5)
        try:
            _warm_all(pool, T, ops[0])
            hold = _Hold(pool.get("r0"))
            fut = router.submit_sketch(T, ops[0])
            # the watchdog fired and found no target once the entry left
            # its heap
            assert _until(lambda: router._hedger is not None
                          and not router._hedger._heap)
            hold.release()
            assert torch.equal(fut.result(timeout=60), refs[0])
            assert router.stats()["hedged"] == 0
        finally:
            router.close()
            pool.shutdown()

    def test_hedged_storm_all_resolve(self):
        T, ops, refs = _workload(8)
        pool = fleet.ReplicaPool(2, max_batch=8, linger_us=1000,
                                 device=DEV)
        router = fleet.Router(pool, hedge=True, hedge_delay_ms=10,
                              hedge_verify=True)
        try:
            _warm_all(pool, T, ops[0])
            hold = _Hold(pool.get(_owner(router, T, ops[0])))
            futs = [router.submit_sketch(T, A) for A in ops]
            done, pending = cf_wait(futs, timeout=120)
            assert not pending, "orphaned client futures"
            for f, want in zip(futs, refs):
                assert torch.equal(f.result(), want)
            hold.release()
            assert _until(
                lambda: router.stats()["hedge_wins"] == len(ops))
            st = router.stats()
            assert st["hedged"] == len(ops)
            assert st["hedge_mismatches"] == 0
            for name in pool.names():
                assert pool.get(name).queue_depth() == 0
        finally:
            router.close()
            pool.shutdown()

    def test_divergence_is_counted(self):
        """The guard compares bits: two results that differ in one ulp,
        or in device, shape or type, are a mismatch."""
        a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        b = a.clone()
        assert _same(a, b) and _same((a, {"x": a}), (b, {"x": b}))
        b[1, 2] = torch.nextafter(b[1, 2], torch.tensor(99.0))
        assert not _same(a, b)
        assert not _same(a, a.numpy()) and not _same(a, a.double())
        pool = fleet.ReplicaPool(2, max_batch=4, device=DEV)
        router = fleet.Router(pool, hedge=True, hedge_verify=True)
        try:
            from libskylark_tpu_torch.fleet.router import _HedgeEntry

            entry = _HedgeEntry("sketch_apply", {}, (), Future(), "r0", ())
            entry.results = {"primary": a, "hedge": b}
            with pytest.warns(RuntimeWarning, match="diverging"):
                router._verify_hedge(entry)
            assert router.stats()["hedge_mismatches"] == 1
        finally:
            router.close()
            pool.shutdown()

    def test_delay_fixed_and_p99_derived(self):
        pool = fleet.ReplicaPool(2, max_batch=4, linger_us=1000,
                                 device=DEV)
        fixed = fleet.Router(pool, hedge=True, hedge_delay_ms=123.0)
        derived = fleet.Router(pool, hedge=True)
        try:
            assert fixed._hedge_delay_s() == pytest.approx(0.123)
            derived._latency.extend([0.010] * 50 + [0.200] * 50)
            derived._hedge_delay_cache = (0.0, 0.0)
            assert derived._hedge_delay_s() == pytest.approx(0.200,
                                                             rel=0.05)
            cold = fleet.Router(pool, hedge=True)
            cold._hedge_delay_cache = (0.0, 0.0)
            assert cold._hedge_delay_s() > 0.0
            cold.close()
        finally:
            fixed.close()
            derived.close()
            pool.shutdown()

    def test_env_flag_enables_hedging(self, monkeypatch):
        monkeypatch.setenv("SKYLARK_FLEET_HEDGE", "1")
        monkeypatch.setenv("SKYLARK_FLEET_HEDGE_DELAY_MS", "77")
        monkeypatch.setenv("SKYLARK_FLEET_HEDGE_VERIFY", "1")
        pool = fleet.ReplicaPool(2, max_batch=4, device=DEV)
        router = fleet.Router(pool)
        try:
            assert router._hedge_on and router._hedge_verify
            assert router._hedge_delay_s() == pytest.approx(0.077)
        finally:
            router.close()
            pool.shutdown()

    def test_resolve_tolerates_cancelled_future(self):
        fut = Future()
        fut.cancel()
        _resolve(fut, result=1)
        _resolve(fut, exception=RuntimeError("x"))
        fut2 = Future()
        _resolve(fut2, result=41)
        _resolve(fut2, result=42)
        assert fut2.result(timeout=1) == 41
