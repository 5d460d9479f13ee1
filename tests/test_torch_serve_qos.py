"""The serve executor's production layer on the CPU: the result cache,
single-flight and residency, deadlines, DEGRADED shedding, QoS tenants,
the adaptive controller and the shared dispatch queue, and the count
fields of ``serve_stats``/``qos_stats``/``cache_stats`` against the JAX
package's executor on one request script.

Exact: every result served from the cache, a flight, a resident operand
or under the controller is torch.equal to the cache-off, by-value or
capacity-1 result, and no returned tensor aliases the cache or another
caller's. Against the reference: counts equal, results within the serve
parity, max|Δ| ≤ 1e-4·max|ref|. No sleep; every future is waited with a
timeout and every executor shut down.
"""

import queue
import threading
import weakref

import numpy as np
import pytest
import torch

import torch_serve_cases as cases
from libskylark_tpu import qos as jqos
from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.engine import serve as jserve
from libskylark_tpu_torch import qos, sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.engine import serve
from libskylark_tpu_torch.resilience import faults, health

ORACLE = 1e-4
LONG = 60_000_000      # linger (µs) that only flush() ends


@pytest.fixture
def executors():
    made = []

    def make(**kw):
        kw.setdefault("device", "cpu")
        ex = serve.MicrobatchExecutor(**kw)
        made.append(ex)
        return ex

    yield make
    for ex in made:
        ex.shutdown()


def _submit(ex, endpoint, kw, **extra):
    return ex.submit(endpoint, **kw, **extra)


@pytest.mark.parametrize("endpoint", cases.ENDPOINTS)
def test_cache_on_equals_cache_off_for_every_endpoint(endpoint, executors):
    on = executors(cache=True, linger_us=LONG)
    off = executors(cache=False, linger_us=LONG)
    kw = cases.case(endpoint, "port")
    lead = [_submit(on, endpoint, kw) for _ in range(3)]
    want = _submit(off, endpoint, kw)
    on.flush()
    off.flush()
    want = want.result(timeout=60)
    hit = _submit(on, endpoint, kw).result(timeout=60)
    got = [f.result(timeout=60) for f in lead] + [hit]
    assert all(cases.same(g, want) for g in got)
    ptrs = [t.data_ptr() for g in got for t in cases.tensors(g)]
    assert len(set(ptrs)) == len(ptrs)
    c = on.stats()["cache"]
    assert (c["misses"], c["single_flight_coalesced"], c["hits"]) == (1, 2, 1)
    assert on.stats()["flushes"] == 1


def test_a_storm_is_one_flush_and_no_result_aliases_the_cache(executors):
    on = executors(cache=True, linger_us=LONG, max_batch=8)
    off = executors(cache=False, max_batch=1)
    kw = cases.case("solve_l2_sketched", "port")
    futs = []
    threads = [threading.Thread(target=lambda: futs.extend(
        _submit(on, "solve_l2_sketched", kw) for _ in range(8)))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    on.flush()
    want = _submit(off, "solve_l2_sketched", kw).result(timeout=60)
    got = [f.result(timeout=60) for f in futs]
    st = on.stats()
    assert st["flushes"] == 1 and st["completed"] == 1
    assert st["cache"]["single_flight_coalesced"] == 31
    assert all(torch.equal(g, want) for g in got)
    (entry, _), = [v for d in on._cache._entries.values()
                   for v in d.values()]
    ptrs = {g.data_ptr() for g in got}
    assert len(ptrs) == 32 and entry.data_ptr() not in ptrs
    got[0].mul_(-1.0)
    again = _submit(on, "solve_l2_sketched", kw).result(timeout=60)
    assert torch.equal(again, want) and torch.equal(entry, want)
    other = dict(kw, transform=cases.case("solve_l2_sketched", "port",
                                          seed=1)["transform"])
    _submit(on, "solve_l2_sketched", other)
    on.flush()
    assert on.stats()["cache"]["misses"] == 2


def test_a_failed_leader_fails_every_follower(executors):
    on = executors(cache=True, linger_us=LONG)
    kw = cases.case("sketch_apply", "port")
    plan = {"faults": [{"site": "serve.flush", "error": "SketchError"}]}
    with faults.fault_plan(plan):
        futs = [_submit(on, "sketch_apply", kw) for _ in range(4)]
        on.flush()
    assert all(isinstance(f.exception(timeout=60), errors.SketchError)
               for f in futs)
    assert on.stats()["cache"]["entries"] == 0


def test_an_operand_ref_equals_a_by_value_submit(executors):
    on = executors(cache=True, linger_us=LONG)
    off = executors(cache=False, linger_us=LONG)
    kw = cases.case("solve_l2_sketched", "port")
    A = np.asarray(kw["A"])
    ref = on.register_operand(A)
    assert on.register_operand(A.copy()) == ref
    assert on.resident_operands() == [ref.digest]
    rng = np.random.default_rng(9)
    bs = [rng.standard_normal(A.shape[0]).astype(np.float32)
          for _ in range(3)]
    by_ref = [on.submit_solve(ref, b, kw["transform"]) for b in bs]
    by_val = [off.submit_solve(A, b, kw["transform"]) for b in bs]
    on.flush()
    off.flush()
    for r, v in zip(by_ref, by_val):
        assert torch.equal(r.result(timeout=60), v.result(timeout=60))
    # the digest of a submit by reference is that of the raw bytes
    hit = on.submit_solve(A, bs[0], kw["transform"]).result(timeout=60)
    assert torch.equal(hit, by_val[0].result())
    assert on.stats()["cache"]["hits"] == 1
    assert on.stats()["cache"]["residency"]["uploads"] == 1
    # a pinned sketch is served without a flush (registration's own
    # sketch waits out the linger: a short one here)
    quick = executors(cache=True, linger_us=1000)
    sk_kw = cases.case("sketch_apply", "port")
    X = np.asarray(sk_kw["A"])
    xref = quick.register_operand(X, transform=sk_kw["transform"],
                                  dimension=sk_kw["dimension"])
    flushes = quick.stats()["flushes"]
    pinned = quick.submit_sketch(sk_kw["transform"], xref,
                                 dimension=sk_kw["dimension"]).result(60)
    assert quick.stats()["flushes"] == flushes == 1
    assert quick.stats()["cache"]["residency"]["pinned_results"] == 1
    want = off.submit_sketch(sk_kw["transform"], X,
                             dimension=sk_kw["dimension"])
    off.flush()
    assert torch.equal(pinned, want.result(timeout=60))
    assert quick.unregister_operand(xref) and on.unregister_operand(ref)
    with pytest.raises(KeyError):
        on.submit_solve(ref, bs[0], kw["transform"])


def test_expired_requests_never_flush(executors):
    ex = executors(linger_us=LONG)
    kw = cases.case("sketch_apply", "port")
    late = [_submit(ex, "sketch_apply", kw, deadline=0.0) for _ in range(3)]
    live = _submit(ex, "sketch_apply", kw, deadline=60.0)
    ex.flush()
    for f in late:
        assert isinstance(f.exception(timeout=60), serve.ServeOverloadedError)
    assert live.result(timeout=60).shape == (5, 16)
    st = ex.stats()
    assert st["expired"] == 3 and st["completed"] == 1
    assert st["cohort_size_hist"] == {1: 1}
    only = executors(linger_us=LONG)
    f = _submit(only, "sketch_apply", kw, deadline=0.0)
    only.flush()
    assert isinstance(f.exception(timeout=60), serve.ServeOverloadedError)
    assert only.stats()["flushes"] == 0


def test_faults_degrade_shed_by_class_and_recover(executors):
    reg = qos.TenantRegistry()
    reg.register("ui", qos.INTERACTIVE)
    reg.register("bulk", qos.BEST_EFFORT)
    ex = executors(linger_us=LONG, max_queue=20, cache=True, tenants=reg)
    one = executors(max_batch=1)
    seen = []
    unsubscribe = health.subscribe(
        lambda src, old, new: seen.append((old, new)) if src is ex else None)
    kw = cases.case("sketch_apply", "port")
    try:
        plan = {"faults": [{"site": "serve.flush", "error": "IOError_",
                            "tag": "bad"}]}
        with faults.fault_plan(plan):
            with faults.tag("bad"):
                for i in range(4):
                    f = _submit(ex, "sketch_apply",
                                cases.case("sketch_apply", "port", seed=i))
                    ex.flush()
                    assert isinstance(f.exception(timeout=60),
                                      errors.IOError_)
        assert ex.state == serve.DEGRADED and seen == [("SERVING",
                                                        "DEGRADED")]
        misses = ex.stats()["cache"]["misses"]
        bound = ex._class_shed_bound(qos.BEST_EFFORT)
        assert bound == 2
        best = [_submit(ex, "sketch_apply", kw, tenant="bulk")
                for _ in range(bound)]
        with pytest.raises(serve.ServeOverloadedError):
            _submit(ex, "sketch_apply", kw, tenant="bulk")
        ui = [_submit(ex, "sketch_apply", kw, tenant="ui") for _ in range(2)]
        ex.flush()
        want = _submit(one, "sketch_apply", kw).result(timeout=60)
        assert all(torch.equal(f.result(timeout=60), want) for f in best + ui)
        assert ex.stats()["cache"]["misses"] == misses
        assert ex.stats()["shed"] == 1
        assert ex.stats()["qos"]["by_class"]["best_effort"]["shed"] == 1
        while ex.state == serve.DEGRADED:
            _submit(ex, "sketch_apply", kw, tenant="ui")
            ex.flush()
        assert seen[-1] == ("DEGRADED", "SERVING")
        assert ex.stats()["flush_failures"] == 4
    finally:
        unsubscribe()


def test_tenants_are_rate_limited_and_ordered(executors):
    reg = qos.TenantRegistry()
    reg.register("capped", qos.STANDARD, rate=1e-6, burst=3)
    ex = executors(linger_us=LONG, tenants=reg)
    kw = cases.case("sketch_apply", "port")
    ok, refused = [], 0
    for _ in range(7):
        try:
            ok.append(_submit(ex, "sketch_apply", kw, tenant="capped"))
        except errors.TenantQuotaError as e:
            refused += 1
            assert e.tenant == "capped" and e.retry_after_s > 0
    ex.flush()
    assert refused == 4 and len(ok) == 3
    st = ex.stats()["qos"]
    assert st["by_tenant"]["capped"] == {"admitted": 3, "shed": 0,
                                         "rate_limited": 4}
    plan = {"faults": [{"site": "qos.admit", "error": "AllocationError"}]}
    with faults.fault_plan(plan), pytest.raises(errors.AllocationError):
        _submit(ex, "sketch_apply", kw)


def test_the_controller_changes_no_result(executors, monkeypatch):
    monkeypatch.setenv("SKYLARK_QOS_ADAPT_INTERVAL", "0.01")
    ad = executors(adaptive=True, linger_us=500, max_batch=4)
    one = executors(max_batch=1)
    reqs = [cases.case("sketch_apply", "port", seed=i % 5) for i in range(24)]
    futs = [_submit(ad, "sketch_apply", kw) for kw in reqs]
    got = [f.result(timeout=60) for f in futs]
    ad._controller.tick()
    for kw, g in zip(reqs, got):
        assert torch.equal(g, _submit(one, "sketch_apply", kw).result(60))
    for statics in ad.qos_bucket_obs():
        linger, cap = ad.bucket_targets(statics)
        assert 0.0 <= linger <= 8 * ad.linger and 1 <= cap <= 4
    ad.set_bucket_targets(next(iter(ad.qos_bucket_obs())), batch_cap=99)
    assert ad.bucket_targets(next(iter(ad.qos_bucket_obs())))[1] == 4
    assert ad.stats()["qos"]["controller"]["ticks"] >= 1


def test_two_executors_share_one_dispatch_queue(executors):
    workq = queue.Queue()
    workers = [threading.Thread(target=serve.dispatch_loop, args=(workq,))
               for _ in range(2)]
    for t in workers:
        t.start()
    try:
        a = executors(dispatch_queue=workq, linger_us=1000)
        b = executors(dispatch_queue=workq, linger_us=1000)
        assert not a._workers and not b._workers
        kw = cases.case("condest", "port")
        want = executors(max_batch=1).submit("condest", **kw).result(60)
        futs = [ex.submit("condest", **kw) for ex in (a, b) for _ in range(3)]
        assert all(torch.equal(f.result(timeout=60), want) for f in futs)
    finally:
        for _ in workers:
            workq.put(None)
        for t in workers:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in workers)


def _script(side):
    """One request script against a cache-on executor with two tenants:
    coalesced storms, a rate-limited tenant, an expired request, hits and
    a miss under another seed. Returns the executor, kept alive."""
    if side == "ref":
        M, C, mod, Q = jsk, JContext, jserve, jqos
        ex = mod.MicrobatchExecutor(linger_us=LONG, cache=True, kernel="xla",
                                    tenants=None)
    else:
        M, C, mod, Q = sk, Context, serve, qos
        ex = mod.MicrobatchExecutor(linger_us=LONG, cache=True,
                                    device="cpu")
    reg = Q.TenantRegistry()
    reg.register("ui", "interactive")
    reg.register("bulk", "best_effort", rate=1e-6, burst=2)
    ex._tenants = reg
    rng = np.random.default_rng(4)
    A1 = rng.standard_normal((6, 64)).astype(np.float32)
    A2 = rng.standard_normal((9, 64)).astype(np.float32)
    T, T2 = M.JLT(64, 16, C(1)), M.JLT(64, 16, C(2))
    out = {}

    def sub(name, A, t=T, **kw):
        try:
            out.setdefault(name, []).append(
                ex.submit_sketch(t, A, dimension=M.ROWWISE, **kw))
        except Exception as e:  # noqa: BLE001 — compared by name
            out.setdefault(name, []).append(type(e).__name__)

    for _ in range(3):
        sub("a1", A1, tenant="ui")
    for _ in range(3):
        sub("a2", A2, tenant="bulk")
    sub("late", A2 + 1, deadline=0.0)
    ex.flush()
    sub("a1", A1, tenant="ui")
    sub("a2", A2)
    sub("seed", A1, t=T2)
    ex.flush()
    return ex, out


def _counts(stats, keys):
    return {k: stats[k] for k in keys}


SERVE_KEYS = ("submitted", "completed", "failed", "rejected", "shed",
              "expired", "poisoned", "flush_failures", "isolation_retries",
              "coalesced", "flushes", "queued", "queued_peak",
              "isolation_depth_peak", "batch_capacity_hist",
              "cohort_size_hist", "padding_waste_ratio", "executors",
              "states")
CACHE_KEYS = ("hits", "misses", "single_flight_coalesced", "insertions",
              "entries", "bytes", "evicted", "uncacheable", "max_bytes",
              "in_flight", "bytes_saved", "caches", "hit_rate", "by_class")


def test_stats_counts_equal_the_reference(monkeypatch):
    ex, got = _script("port")
    jex, want = _script("ref")
    try:
        monkeypatch.setattr(serve, "_EXECUTORS", weakref.WeakSet([ex]))
        monkeypatch.setattr(jserve, "_EXECUTORS", weakref.WeakSet([jex]))
        for name in want:
            for g, w in zip(got[name], want[name]):
                if isinstance(w, str) or isinstance(g, str):
                    assert g == w
                    continue
                ge, we = g.exception(timeout=60), w.exception(timeout=60)
                assert type(ge).__name__ == type(we).__name__
                if we is None:
                    r, j = g.result().numpy(), np.asarray(w.result())
                    assert np.abs(r - j).max() <= ORACLE * np.abs(j).max()
        s, js = serve.serve_stats(), jserve.serve_stats()
        assert _counts(s, SERVE_KEYS) == _counts(js, SERVE_KEYS)
        q, jq = serve.qos_stats(), jserve.qos_stats()
        for k in ("by_class", "by_tenant", "served"):
            assert q[k] == jq[k], k
        c, jc = serve.cache_stats(), jserve.cache_stats()
        assert _counts(c, CACHE_KEYS) == _counts(jc, CACHE_KEYS)
        qb, jqb = ex.stats()["qos"], jex.stats()["qos"]
        assert qb["scheduler"] == jqb["scheduler"]
        assert {k: {kk: v for kk, v in blk.items()
                    if kk in ("admitted", "shed", "rate_limited",
                              "queue_depth")}
                for k, blk in qb["by_class"].items()} == {
            k: {kk: v for kk, v in blk.items()
                if kk in ("admitted", "shed", "rate_limited", "queue_depth")}
            for k, blk in jqb["by_class"].items()}
    finally:
        ex.shutdown()
        jex.shutdown()
