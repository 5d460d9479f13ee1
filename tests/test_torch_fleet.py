"""The port's replicated serving tier (``libskylark_tpu_torch/fleet/``)
against the JAX package's, on the CPU, with thread replicas.

Oracles:

- *routing parity*: for the same pool names and requests the port's
  ``Router`` picks the same owner as the reference's, sequence after
  sequence of bucket classes (the bounded-load rule charges ownership as
  it goes), and ``request_statics`` gives equal tuples across the serve
  endpoints (the ring itself is bit-equal, ``tests/test_torch_dist.py``);
- *results*: through a thread router each result is ``torch.equal`` to
  one port executor's; against the reference router's numpy results,
  exact for the CWT, within 1e-4·max for the JLT (the reference's
  oracle);
- *the reference's fleet contracts* (``tests/test_fleet.py``): stickiness
  and affinity hit rate 1.0, read-only ``owner_of``, a collectible
  dropped router, load spill, DRAINING pushed off the ring, DEGRADED
  demoted, a router seeded from live states, a drain mid-traffic and an
  injected ``fleet.route`` fault with no client-visible failure, no
  healthy replica, the shared dispatch pool, the process-wide SIGTERM,
  per-replica Prometheus lines, the ``fleet`` collector and route spans;
- *environment*: ``propagated_env()`` names the reference's
  ``PROPAGATED_ENV``, and ``resolve_backend`` picks by core count.

Sizes: JLT 256 → 32 on 33–64 rows, CWT 128 → 32 and CWT classes of
40/70/130 rows → 16. Process replicas are in
``tests/test_torch_fleet_process.py``.
"""

from __future__ import annotations

import os
import signal
import threading

import numpy as np
import pytest
import torch

from libskylark_tpu import Context as RContext
from libskylark_tpu import engine as rengine
from libskylark_tpu import fleet as rfleet
from libskylark_tpu import ml as rml
from libskylark_tpu import sketch as rsk
from libskylark_tpu_torch import Context, engine, fleet, resilience, telemetry
from libskylark_tpu_torch import ml as pml
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.telemetry import trace as trace_mod

DEV = "cpu"


def _fleet(n=3, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("linger_us", 1000)
    pool = fleet.ReplicaPool(n, device=DEV, **kw)
    return pool, fleet.Router(pool)


def _classed_reqs(n_reqs=12, classes=(40, 70, 130), s_dim=16, seed=0):
    """Requests over len(classes) distinct pow2 bucket classes."""
    rng = np.random.default_rng(seed)
    ctx = Context(seed=seed)
    transforms = {n: sk.CWT(n, s_dim, ctx) for n in classes}
    reqs = []
    for i in range(n_reqs):
        n = classes[i % len(classes)]
        A = rng.standard_normal((n, 3 + i % 3)).astype(np.float32)
        reqs.append((transforms[n], A))
    return reqs


def _refs(reqs, dimension=None):
    """The same requests on one port executor."""
    ex = engine.MicrobatchExecutor(max_batch=8, linger_us=500, device=DEV)
    try:
        return [ex.submit_sketch(T, A, dimension).result(timeout=60)
                for (T, A) in reqs]
    finally:
        ex.shutdown()


def _equal_all(futs, refs):
    for f, ref in zip(futs, refs):
        got = f.result(timeout=60)
        assert isinstance(got, torch.Tensor) and torch.equal(got, ref)


# -- parity with the reference ------------------------------------------

_RNG = np.random.default_rng(0)
_AR = _RNG.standard_normal((40, 256)).astype(np.float32)
_AC = _RNG.standard_normal((128, 5)).astype(np.float32)
_B = _RNG.standard_normal((128, 2)).astype(np.float32)
_X = _RNG.standard_normal((20, 3)).astype(np.float32)
_Q = _RNG.standard_normal((4, 3)).astype(np.float32)
_COEF = _RNG.standard_normal((20,)).astype(np.float32)

# endpoint -> (package -> the request's kwargs)
_REQUESTS = {
    "jlt-rw": ("sketch_apply", lambda s, C, m: dict(
        transform=s.JLT(256, 32, C(seed=1)), A=_AR, dimension=s.ROWWISE)),
    "cwt-cw": ("sketch_apply", lambda s, C, m: dict(
        transform=s.CWT(128, 32, C(seed=1)), A=_AC, dimension=None)),
    "ct-cw": ("sketch_apply", lambda s, C, m: dict(
        transform=s.CT(128, 32, C(seed=1), C=1.0), A=_AC, dimension=None)),
    "srht": ("sketch_apply", lambda s, C, m: dict(
        transform=s.FJLT(128, 32, C(seed=1), fut="wht"), A=_AC,
        dimension=None)),
    "solve": ("solve_l2_sketched", lambda s, C, m: dict(
        A=_AC, B=_B, transform=s.CWT(128, 32, C(seed=1)), method="qr")),
    "krr": ("krr_predict", lambda s, C, m: dict(
        kernel=m.Gaussian(3, sigma=1.0), X_new=_Q, X_train=_X,
        coef=_COEF)),
    "condest": ("condest", lambda s, C, m: dict(A=_AC, steps=4)),
    "cmm": ("compressed_matmul", lambda s, C, m: dict(
        transform=s.CWT(128, 32, C(seed=1)), A=np.ascontiguousarray(_AC.T),
        B=_B)),
    "fastfood": ("fastfood_features", lambda s, C, m: dict(
        transform=m.Gaussian(3, sigma=1.0).create_rft(64, C(seed=2),
                                                      "fast"), A=_X)),
}


def _statics(pkg_engine, sk_mod, ctx_cls, ml_mod, name, **over):
    endpoint, make = _REQUESTS[name]
    kw = dict(make(sk_mod, ctx_cls, ml_mod), **over)
    return pkg_engine.request_statics(endpoint, **kw)


@pytest.mark.parametrize("name", sorted(_REQUESTS))
def test_request_statics_equal_the_references(name):
    assert (_statics(engine, sk, Context, pml, name)
            == _statics(rengine, rsk, RContext, rml, name))


def test_routing_parity_with_the_reference():
    """The same pool names, the same sequence of bucket classes: both
    routers charge ownership alike and name the same owners; ``owner_of``
    agrees too."""
    rpool = rfleet.ReplicaPool(3, max_batch=8, linger_us=1000)
    rrouter = rfleet.Router(rpool)
    pool, router = _fleet(3)
    try:
        seq = []
        for name in sorted(_REQUESTS):
            seq.append((_statics(engine, sk, Context, pml, name),
                        _statics(rengine, rsk, RContext, rml, name)))
        for rows in (33, 40, 64, 100, 200, 300, 500, 1000):
            A = np.ones((rows, 256), np.float32)
            seq.append((_statics(engine, sk, Context, pml, "jlt-rw", A=A),
                        _statics(rengine, rsk, RContext, rml, "jlt-rw",
                                 A=A)))
        for ps, rs in seq:
            assert ps == rs
            assert (router._affinity_owner(ps, record=False)
                    == rrouter._affinity_owner(rs, record=False))
        owners = [router._affinity_owner(ps) for ps, _ in seq]
        assert owners == [rrouter._affinity_owner(rs) for _, rs in seq]
        assert len(set(owners)) == 3          # bounded load spreads them
        # a probe through the public verb agrees, and stays read-only
        for name in ("jlt-rw", "cwt-cw"):
            endpoint, make = _REQUESTS[name]
            assert (router.owner_of(endpoint, **make(sk, Context, pml))
                    == rrouter.owner_of(endpoint,
                                        **make(rsk, RContext, rml)))
    finally:
        rrouter.close()
        rpool.shutdown()
        router.close()
        pool.shutdown()


def test_results_equal_one_executor_and_the_reference_router():
    """Through a thread router: each result ``torch.equal`` to one port
    executor's; against the reference router's, CWT exact and JLT within
    1e-4·max."""
    rng = np.random.default_rng(7)
    jl = [rng.standard_normal((33 + 6 * i, 256)).astype(np.float32)
          for i in range(6)]
    cw = [rng.standard_normal((128, 3 + i)).astype(np.float32)
          for i in range(4)]
    T, C = sk.JLT(256, 32, Context(seed=3)), sk.CWT(128, 32, Context(seed=4))
    RT, RC = (rsk.JLT(256, 32, RContext(seed=3)),
              rsk.CWT(128, 32, RContext(seed=4)))
    want_j = _refs([(T, A) for A in jl], sk.ROWWISE)
    want_c = _refs([(C, A) for A in cw])
    pool, router = _fleet(2)
    rpool = rfleet.ReplicaPool(2, max_batch=8, linger_us=1000)
    rrouter = rfleet.Router(rpool)
    try:
        fj = [router.submit_sketch(T, A, sk.ROWWISE) for A in jl]
        fc = [router.submit_sketch(C, A) for A in cw]
        # the reference one request at a time: one capacity to compile
        rj = [rrouter.submit_sketch(RT, A, rsk.ROWWISE).result(timeout=120)
              for A in jl]
        rc = [rrouter.submit_sketch(RC, A).result(timeout=120) for A in cw]
        _equal_all(fj, want_j)
        _equal_all(fc, want_c)
        for f, r in zip(fj, rj):
            got, ref = f.result().numpy(), np.asarray(r)
            assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))
        for f, r in zip(fc, rc):
            assert torch.equal(f.result(), torch.from_numpy(np.array(r)))
        assert router.stats()["affinity_hit_rate"] == 1.0
    finally:
        router.close()
        pool.shutdown()
        rrouter.close()
        rpool.shutdown()


def test_propagated_env_names_the_references():
    assert sorted(fleet.PROPAGATED_ENV) == sorted(rfleet.PROPAGATED_ENV)
    assert sorted(fleet.propagated_env()) == sorted(fleet.PROPAGATED_ENV)


def test_backend_auto_resolves_by_core_count(monkeypatch):
    monkeypatch.setattr("os.cpu_count", lambda: 2)
    assert fleet.resolve_backend("auto") == "thread"
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    assert fleet.resolve_backend("auto") == "process"
    monkeypatch.setenv("SKYLARK_FLEET_BACKEND", "thread")
    assert fleet.resolve_backend(None) == "thread"


def test_a_pool_runs_on_the_card_unless_asked():
    """No device given: the package default, ``"cuda"``, which raises
    without a card instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from libskylark_tpu_torch.base import errors

    with pytest.raises(errors.UnsupportedError):
        fleet.ReplicaPool(1)


# -- the reference's contracts, mirrored --------------------------------


class TestRouterAffinity:
    def test_results_bit_equal_and_sticky(self):
        reqs = _classed_reqs(24)
        refs = _refs(reqs)
        pool, router = _fleet(3)
        try:
            futs = [router.submit_sketch(T, A) for (T, A) in reqs]
            _equal_all(futs, refs)
            st = router.stats()
            assert st["routed"] == 24
            assert st["affinity_hit_rate"] == 1.0
            assert st["failover"] == 0
            owners = {router.owner_of("sketch_apply", transform=T, A=A,
                                      dimension=None) for (T, A) in reqs}
            assert set(st["by_replica"]) == owners
            # each class flushed on its owner alone
            for name in pool.names():
                flushed = pool.get(name).stats()["completed"]
                assert flushed == st["by_replica"].get(name, 0)
        finally:
            router.close()
            pool.shutdown()

    def test_owner_of_is_read_only(self):
        pool, router = _fleet(2)
        try:
            ctx = Context(seed=0)
            probed = [router.owner_of(
                "sketch_apply", transform=sk.CWT(n, 16, ctx),
                A=np.ones((n, 2), np.float32), dimension=None)
                for n in (40, 70, 130, 200)]
            assert all(p is not None for p in probed)
            assert router._assign == {}
            assert not router._owned
            T = sk.CWT(40, 16, ctx)
            A = np.ones((40, 2), np.float32)
            peek = router.owner_of("sketch_apply", transform=T, A=A,
                                   dimension=None)
            router.submit_sketch(T, A).result(timeout=60)
            assert router.stats()["by_replica"] == {peek: 1}
        finally:
            router.close()
            pool.shutdown()

    def test_dropped_router_is_collectible(self):
        import gc
        import weakref

        pool = fleet.ReplicaPool(2, max_batch=4, linger_us=500,
                                 device=DEV)
        try:
            router = fleet.Router(pool)
            wr = weakref.ref(router)
            del router
            gc.collect()
            assert wr() is None
            pool.get(pool.names()[0]).drain(timeout=10)
        finally:
            pool.shutdown()

    def test_load_spill_past_threshold(self):
        reqs = _classed_reqs(8, classes=(40,))
        pool, router = _fleet(2, max_batch=4, linger_us=10_000_000)
        router.spill_threshold = 4
        try:
            futs = [router.submit_sketch(T, A) for (T, A) in reqs]
            st = router.stats()
            assert st["spilled"] > 0
            assert len(st["by_replica"]) == 2
            pool.flush()
            _equal_all(futs, _refs(reqs))
        finally:
            router.close()
            pool.shutdown()


class TestHealthRouting:
    def test_draining_replica_leaves_ring_push_not_poll(self):
        pool, router = _fleet(3)
        try:
            victim = pool.names()[0]
            assert victim in router.routable()
            pool.get(victim).drain(timeout=30)
            assert victim not in router.routable()
            assert victim in router.stats()["removed"]
        finally:
            router.close()
            pool.shutdown()

    def test_degraded_replica_deprioritized(self):
        reqs = _classed_reqs(6, classes=(40,))
        pool, router = _fleet(2, linger_us=500)
        try:
            owner = router.owner_of("sketch_apply",
                                    transform=reqs[0][0], A=reqs[0][1],
                                    dimension=None)
            ex = pool.get(owner).executor
            for _ in range(8):
                ex._health.append(1.0)
            ex._maybe_publish_state()
            assert owner in router.stats()["degraded"]
            futs = [router.submit_sketch(T, A) for (T, A) in reqs]
            _equal_all(futs, _refs(reqs))
            st = router.stats()
            assert st["by_replica"].get(owner, 0) == 0
            assert st["affinity_hit_rate"] == 0.0
            for _ in range(32):
                ex._health.append(0.0)
            ex._maybe_publish_state()
            assert owner not in router.stats()["degraded"]
        finally:
            router.close()
            pool.shutdown()

    def test_router_seeded_from_current_states(self):
        pool = fleet.ReplicaPool(2, max_batch=4, linger_us=500,
                                 device=DEV)
        try:
            pool.get("r0").drain(timeout=30)
            router = fleet.Router(pool)
            assert router.routable() == ["r1"]
            router.close()
        finally:
            pool.shutdown()


class TestFailover:
    def test_drain_one_replica_mid_traffic(self):
        """Preempt one replica while traffic flows: peers absorb the
        load, no future is orphaned, no client sees a failure, and the
        drained replica's hook fires exactly once."""
        reqs = _classed_reqs(48, classes=(40, 70, 130), seed=3)
        refs = _refs(reqs)
        pool, router = _fleet(3, linger_us=2000)
        fired = []
        try:
            victim = router.owner_of("sketch_apply",
                                     transform=reqs[0][0], A=reqs[0][1],
                                     dimension=None)
            pool.on_replica_drain(victim, lambda: fired.append(victim))
            half = threading.Event()
            t = threading.Thread(target=lambda: (
                half.wait(30), pool.preempt_replica(victim, timeout=60)))
            t.start()
            futs = []
            for i, (T, A) in enumerate(reqs):
                futs.append(router.submit_sketch(T, A))
                if i == 8:
                    half.set()
            t.join()
            _equal_all(futs, refs)
            assert fired == [victim]
            assert victim not in router.routable()
            st = router.stats()
            assert sum(st["by_replica"].get(n, 0)
                       for n in pool.names() if n != victim) > 0
            pool.preempt_replica(victim, timeout=5)
            assert fired == [victim]
        finally:
            router.close()
            pool.shutdown()

    def test_injected_route_fault_fails_over(self):
        reqs = _classed_reqs(6, classes=(40,), seed=4)
        plan = {"seed": 3, "faults": [
            {"site": "fleet.route", "error": "IOError_", "every": 2}]}
        pool, router = _fleet(2, linger_us=500)
        try:
            with faults.fault_plan(plan):
                futs = [router.submit_sketch(T, A) for (T, A) in reqs]
                _equal_all(futs, _refs(reqs))
                fired = faults.fired()
            st = router.stats()
            # every 2nd attempt fires and costs one more attempt: 5
            # failovers for 6 submits, all landing
            assert st["failover"] == 5
            assert st["routed"] == 6
            assert [f[0] for f in fired] == ["fleet.route"] * 5
        finally:
            router.close()
            pool.shutdown()

    def test_all_replicas_down_raises_no_healthy(self):
        pool, router = _fleet(2)
        try:
            for name in pool.names():
                pool.get(name).drain(timeout=30)
            T = sk.CWT(40, 16, Context(seed=0))
            with pytest.raises(fleet.NoHealthyReplicaError):
                router.submit_sketch(T, np.ones((40, 2), np.float32))
            with pytest.raises(engine.ServeOverloadedError):
                router.submit_sketch(T, np.ones((40, 2), np.float32))
        finally:
            router.close()
            pool.shutdown()


class TestSharedDispatchPool:
    def test_shared_workers_serve_and_drain(self):
        reqs = _classed_reqs(18, seed=13)
        refs = _refs(reqs)
        pool = fleet.ReplicaPool(3, max_batch=4, linger_us=1000,
                                 shared_workers=2, device=DEV)
        router = fleet.Router(pool)
        try:
            for r in pool.replicas():
                assert r.executor._workers == []
            _equal_all([router.submit_sketch(T, A) for (T, A) in reqs],
                       refs)
            assert pool.preempt_replica(pool.names()[0], timeout=30)
            _equal_all([router.submit_sketch(T, A) for (T, A) in reqs],
                       refs)
        finally:
            router.close()
            pool.shutdown()

    def test_shared_workers_rejects_process_backend(self):
        with pytest.raises(ValueError, match="thread replicas only"):
            fleet.ReplicaPool(2, backend="process", shared_workers=2,
                              device=DEV)


class TestPreemptionComposition:
    @pytest.fixture(autouse=True)
    def _clean_handler(self):
        yield
        resilience.uninstall_preemption_handler()
        resilience.reset_preemption()

    def test_sigterm_drains_fleet_and_fires_replica_hooks(self):
        reqs = _classed_reqs(9, seed=5)
        refs = _refs(reqs)
        pool, router = _fleet(3, linger_us=10_000_000)
        fired = []
        try:
            for name in pool.names():
                pool.on_replica_drain(name,
                                      lambda n=name: fired.append(n))
            futs = [router.submit_sketch(T, A) for (T, A) in reqs]
            resilience.install_preemption_handler(drain_timeout=60.0)
            os.kill(os.getpid(), signal.SIGTERM)
            assert resilience.wait_for_preemption_teardown(timeout=60.0)
            _equal_all(futs, refs)
            assert sorted(fired) == pool.names()
            assert router.routable() == []
            with pytest.raises(fleet.NoHealthyReplicaError):
                router.submit_sketch(reqs[0][0], reqs[0][1])
        finally:
            router.close()
            pool.shutdown()


class TestFleetTelemetry:
    def test_prometheus_disaggregates_per_replica(self):
        reqs = _classed_reqs(4, classes=(40,), seed=7)
        pool = fleet.ReplicaPool(2, max_batch=4, linger_us=500,
                                 device=DEV, names=["prom-a", "prom-b"])
        try:
            a, b = pool.get("prom-a"), pool.get("prom-b")
            futs = ([a.submit("sketch_apply", transform=T, A=A)
                     for (T, A) in reqs[:3]]
                    + [b.submit("sketch_apply", transform=T, A=A)
                       for (T, A) in reqs[3:]])
            [f.result(timeout=60) for f in futs]
            by = telemetry.snapshot()["collectors"]["serve"]["by_replica"]
            assert by["prom-a"]["submitted"] == 3
            assert by["prom-b"]["submitted"] == 1
            text = telemetry.prometheus_text()
            assert 'skylark_serve_submitted{replica="prom-a"} 3' in text
            assert 'skylark_serve_submitted{replica="prom-b"} 1' in text
        finally:
            pool.shutdown()

    def test_fleet_collector_and_route_spans(self):
        reqs = _classed_reqs(6, seed=8)
        telemetry.set_enabled(True)
        try:
            trace_mod.clear_finished()
            pool, router = _fleet(2, linger_us=500)
            try:
                [f.result(timeout=60) for f in
                 [router.submit_sketch(T, A) for (T, A) in reqs]]
                fl = telemetry.snapshot()["collectors"]["fleet"]
                assert fl["routed"] >= 6
                assert fl["affinity_hit_rate"] is not None
                assert fl["by_replica"]
                assert "autoscale" in fl
                text = telemetry.prometheus_text()
                assert any(ln.startswith("skylark_fleet_routed{replica=")
                           for ln in text.splitlines())
            finally:
                router.close()
                pool.shutdown()
            routed = telemetry.snapshot()["metrics"]["fleet.routed"]
            assert sum(v["value"] for v in routed["values"]) >= 6
            spans = trace_mod.finished_spans()
            routes = {s.span_id: s for s in spans
                      if s.name == "fleet.route"}
            submits = [s for s in spans if s.name == "serve.submit"]
            parented = [s for s in submits if s.parent_id in routes]
            assert routes and parented
            for s in parented:
                assert s.request_id == routes[s.parent_id].request_id
        finally:
            telemetry.set_enabled(False)
