"""The serving slice as a whole, on the CPU: the port's
``MicrobatchExecutor(device="cpu")`` against the JAX package's
``MicrobatchExecutor(kernel="xla")`` on the same concurrent requests —
JLT rowwise and CT columnwise on ragged shapes, CWT and SRHT on dense
operands, FastGaussianRFT with mixed seeds, and CWT and JLT on scipy CSR
operands. CWT results are bit-equal; the others within the reference's
oracle, max |Δ| ≤ 1e-4·max|ref|.

Also: the bucket statics equal the reference's, requests coalesce
(``flushes`` < requests), a full queue raises ``ServeOverloadedError``,
sparse operands at density ≥ 0.25 go densified, a failing lane is
isolated by bisection while its cohort-mates succeed, an exception in a
flush reaches the futures, a lane that cannot be handed its result counts
as failed, every lane is bit-equal to a capacity-1 flush,
drain resolves everything, and ``kernel="cuda"`` on a CPU executor raises
at construction.
"""

import math
import threading
import time

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu import engine as jengine
from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import engine, sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.engine import serve

ORACLE = 1e-4


def _requests():
    """(kind, transform factory (module, Context), operand, dimension)."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        m = int(rng.integers(5, 30))
        reqs.append(("jlt", lambda M, C, i=i: M.JLT(100, 16, C(i % 3)),
                     rng.standard_normal((m, 100)).astype(np.float32),
                     "rowwise"))
    for i in range(5):
        m = int(rng.integers(2, 15))
        reqs.append(("ct", lambda M, C, i=i: M.CT(100, 16, C(10 + i),
                                                  C=1.0 + i % 2),
                     rng.standard_normal((100, m)).astype(np.float32),
                     "columnwise"))
    for i in range(5):
        reqs.append(("cwt", lambda M, C, i=i: M.CWT(100, 16, C(20 + i % 2)),
                     rng.standard_normal((100, int(rng.integers(3, 20))))
                     .astype(np.float32), "columnwise"))
    for i in range(4):
        reqs.append(("srht", lambda M, C, i=i: M.FJLT(256, 32, C(30 + i),
                                                      fut="wht"),
                     rng.standard_normal((int(rng.integers(2, 12)), 256))
                     .astype(np.float32), "rowwise"))
    for i in range(5):
        reqs.append(("ff", lambda M, C, i=i: M.FastGaussianRFT(
            60, 40, C(40 + i % 2), sigma=8.0),
            rng.standard_normal((int(rng.integers(2, 9)), 60)).astype(
                np.float32), None))
    for i in range(5):
        reqs.append(("spcwt", lambda M, C, i=i: M.CWT(300, 16, C(50 + i)),
                     sp.random(int(rng.integers(10, 40)), 300, density=0.05,
                               format="csr", random_state=i,
                               dtype=np.float32), "rowwise"))
    for i in range(4):
        reqs.append(("spjlt", lambda M, C, i=i: M.JLT(200, 16, C(60 + i)),
                     sp.random(200, int(rng.integers(5, 30)), density=0.05,
                               format="csr", random_state=10 + i,
                               dtype=np.float32), "columnwise"))
    return reqs


def _submit(ex, M, C, req):
    kind, make, A, dim = req
    T = make(M, C)
    d = {"rowwise": M.ROWWISE, "columnwise": M.COLUMNWISE, None: None}[dim]
    if kind == "ff":
        return ex.submit_fastfood(T, A)
    if kind.startswith("sp"):
        return ex.submit_sparse(T, A, dimension=d)
    return ex.submit_sketch(T, A, dimension=d)


def _storm(ex, M, C, reqs, threads=4):
    futs = [None] * len(reqs)

    def worker(t):
        for i in range(t, len(reqs), threads):
            futs[i] = _submit(ex, M, C, reqs[i])

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return [np.asarray(f.result(timeout=120)) for f in futs]


@pytest.fixture(scope="module")
def reference():
    reqs = _requests()
    ex = jengine.MicrobatchExecutor(max_batch=4, linger_us=20000,
                                    kernel="xla")
    try:
        out = _storm(ex, jsk, JContext, reqs)
        stats = ex.stats()
    finally:
        ex.shutdown()
    return reqs, out, stats


def _cpu(**kw):
    return engine.MicrobatchExecutor(device="cpu", **kw)


def test_executor_matches_the_reference(reference):
    reqs, want, jstats = reference
    with _cpu(max_batch=4, linger_us=20000) as ex:
        got = _storm(ex, sk, Context, reqs)
        st = ex.stats()
    assert st["completed"] == len(reqs) == jstats["completed"]
    assert st["failed"] == 0 and st["submitted"] == len(reqs)
    for (kind, *_), g, w in zip(reqs, got, want):
        assert g.shape == w.shape, kind
        if kind in ("cwt", "spcwt"):
            assert np.array_equal(g, w), kind
        else:
            assert np.abs(g - w).max() <= ORACLE * np.abs(w).max(), kind
    # the CPU executor runs the plain programs, declining nothing
    assert set(st["kernel"]["by_backend"]) == {"plain"}
    assert st["kernel"]["by_reason"] == {}
    assert st["sparse"]["submits"] == 9 and st["sparse"]["densified"] == 0


def test_requests_coalesce():
    reqs = [r for r in _requests() if r[0] == "jlt"]
    with _cpu(max_batch=8, linger_us=200_000) as ex:
        futs = [_submit(ex, sk, Context, r) for r in reqs]
        for f in futs:
            f.result(timeout=60)
        st = ex.stats()
    assert st["flushes"] < len(reqs)
    assert st["coalesced"] >= 2
    assert sum(st["cohort_size_hist"].values()) == st["flushes"]
    assert st["padding_waste_ratio"] is not None
    assert st["latency_s"]["n"] == len(reqs)
    by_bucket = st["by_bucket"].values()
    assert sum(b["completed"] for b in by_bucket) == len(reqs)
    assert sum(b["flushes"] for b in by_bucket) == st["flushes"]


def test_every_lane_equals_its_capacity_one_flush():
    reqs = _requests()
    with _cpu(max_batch=8, linger_us=20000) as ex8, \
            _cpu(max_batch=1) as ex1:
        got = _storm(ex8, sk, Context, reqs)
        alone = [np.asarray(_submit(ex1, sk, Context, r).result(timeout=60))
                 for r in reqs]
    for (kind, *_), g, a in zip(reqs, got, alone):
        assert np.array_equal(g, a), kind


@pytest.mark.parametrize("endpoint", ["sketch_apply", "fastfood_features",
                                      "sparse_sketch_apply"])
def test_request_statics_match_the_reference(endpoint):
    rng = np.random.default_rng(1)
    if endpoint == "sketch_apply":
        A = rng.standard_normal((37, 100)).astype(np.float32)
        for make in (lambda M, C: M.JLT(100, 16, C(1)),
                     lambda M, C: M.CT(100, 16, C(1), C=2.0),
                     lambda M, C: M.CWT(100, 16, C(1))):
            kw = dict(A=A, dimension="rowwise")
            assert (engine.request_statics(
                endpoint, transform=make(sk, Context), **kw)
                == jengine.request_statics(
                    endpoint, transform=make(jsk, JContext), **kw))
        A = rng.standard_normal((256, 9)).astype(np.float32)
        assert (engine.request_statics(
            endpoint, transform=sk.FJLT(256, 32, Context(2), fut="wht"), A=A)
            == jengine.request_statics(
                endpoint, transform=jsk.FJLT(256, 32, JContext(2),
                                             fut="wht"), A=A))
    elif endpoint == "fastfood_features":
        A = rng.standard_normal((13, 60)).astype(np.float32)
        assert (engine.request_statics(
            endpoint, transform=sk.FastGaussianRFT(60, 40, Context(1),
                                                   sigma=2.0), A=A)
            == jengine.request_statics(
                endpoint, transform=jsk.FastGaussianRFT(60, 40, JContext(1),
                                                        sigma=2.0), A=A))
    else:
        A = sp.random(30, 300, density=0.05, format="csr", random_state=2,
                      dtype=np.float32)
        for make in (lambda M, C: M.CWT(300, 16, C(1)),
                     lambda M, C: M.JLT(300, 16, C(1))):
            assert (engine.request_statics(
                endpoint, transform=make(sk, Context), A=A,
                dimension="rowwise")
                == jengine.request_statics(
                    endpoint, transform=make(jsk, JContext), A=A,
                    dimension="rowwise"))


def test_backpressure_raises_overloaded():
    A = np.ones((4, 100), np.float32)
    T = sk.JLT(100, 16, Context(0))
    with _cpu(max_batch=8, max_queue=2, linger_us=5_000_000) as ex:
        futs = [ex.submit_sketch(T, A, dimension=sk.ROWWISE)
                for _ in range(2)]
        t0 = time.monotonic()
        with pytest.raises(engine.ServeOverloadedError):
            ex.submit_sketch(T, A, dimension=sk.ROWWISE, timeout=0.05)
        assert time.monotonic() - t0 < 2.0
        assert ex.stats()["rejected"] == 1
        ex.flush()
        assert all(f.done() for f in futs)


@pytest.mark.parametrize("density", [0.24, 0.25, 0.3])
def test_sparse_auto_densify_at_a_quarter(density):
    rng = np.random.default_rng(int(density * 100))
    A = np.zeros((20, 40), np.float32)
    cells = rng.choice(800, int(round(density * 800)), replace=False)
    A.flat[cells] = rng.standard_normal(cells.size)
    T = sk.CWT(40, 8, Context(3))
    with _cpu(max_batch=2) as ex:
        got = ex.submit_sparse(T, sp.csr_matrix(A),
                               dimension=sk.ROWWISE).result(timeout=60)
        st = ex.stats()
    assert st["sparse"]["densified"] == (1 if density >= 0.25 else 0)
    assert torch.equal(got, T.apply(A, sk.ROWWISE, device="cpu"))
    with pytest.raises(TypeError):
        engine.MicrobatchExecutor(device="cpu").submit_sparse(T, A)


def test_a_failing_lane_is_isolated(monkeypatch):
    """One poison request, whose lane makes the flush program raise, fails
    alone; its cohort-mates succeed with the bits of a clean flush."""
    rng = np.random.default_rng(4)
    ops = [rng.standard_normal((6, 100)).astype(np.float32) for _ in range(8)]
    transforms = [sk.JLT(100, 16, Context(70 + i)) for i in range(8)]
    poison = transforms[5].allocation.key
    real = serve.run_flush

    def flaky(ctx, route, kd, scale, arrays):
        if any(np.array_equal(k, poison) for k in kd):
            raise RuntimeError("poisoned lane")
        return real(ctx, route, kd, scale, arrays)

    with _cpu(max_batch=8, linger_us=5_000_000) as clean:
        want = [clean.submit_sketch(T, A, dimension=sk.ROWWISE)
                for T, A in zip(transforms, ops)]
    monkeypatch.setattr(serve, "run_flush", flaky)
    with _cpu(max_batch=8, linger_us=5_000_000) as ex:
        futs = [ex.submit_sketch(T, A, dimension=sk.ROWWISE)
                for T, A in zip(transforms, ops)]
        for i, f in enumerate(futs):
            if i == 5:
                with pytest.raises(RuntimeError, match="poisoned"):
                    f.result(timeout=60)
            else:
                assert torch.equal(f.result(timeout=60),
                                   want[i].result(timeout=60))
        st = ex.stats()
    assert st["failed"] == 1 and st["poisoned"] == 1
    assert st["completed"] == 7 and st["isolation_retries"] >= 2
    assert st["flush_failures"] >= 2


def test_a_flush_exception_reaches_the_futures(monkeypatch):
    def broken(*a, **k):
        raise ValueError("flush program broke")

    monkeypatch.setattr(serve, "run_flush", broken)
    T = sk.CWT(100, 16, Context(0))
    with _cpu(max_batch=2) as ex:
        futs = [ex.submit_sketch(T, np.ones((100, 3), np.float32))
                for _ in range(3)]
        for f in futs:
            with pytest.raises(ValueError, match="broke"):
                f.result(timeout=60)
        assert ex.stats()["failed"] == 3


def test_a_lane_whose_unpad_raises_counts_as_failed(monkeypatch):
    """A flush that ran but could not hand one lane its result counts that
    lane failed, not completed: completed + failed == submitted."""
    real = serve._unpad

    def unpad(endpoint, out, lane, r):
        if lane == 1:
            raise ValueError("unpad broke")
        return real(endpoint, out, lane, r)

    monkeypatch.setattr(serve, "_unpad", unpad)
    T = sk.JLT(100, 16, Context(0))
    with _cpu(max_batch=4, linger_us=5_000_000) as ex:
        futs = [ex.submit_sketch(T, np.ones((4, 100), np.float32),
                                 dimension=sk.ROWWISE) for _ in range(4)]
        for i, f in enumerate(futs):
            if i == 1:
                with pytest.raises(ValueError, match="unpad"):
                    f.result(timeout=60)
            else:
                assert f.result(timeout=60).shape == (4, 16)
        st = ex.stats()
    assert st["completed"] == 3 and st["failed"] == 1
    assert st["completed"] + st["failed"] == st["submitted"] == 4


def test_drain_resolves_everything_and_stops_intake():
    T = sk.JLT(100, 16, Context(0))
    A = np.ones((4, 100), np.float32)
    ex = _cpu(max_batch=8, linger_us=5_000_000)
    futs = [ex.submit_sketch(T, A, dimension=sk.ROWWISE) for _ in range(3)]
    assert ex.state == serve.SERVING
    assert ex.drain(timeout=30) is True
    assert all(f.done() and f.exception() is None for f in futs)
    assert ex.state == serve.STOPPED
    with pytest.raises(engine.ServeOverloadedError):
        ex.submit_sketch(T, A, dimension=sk.ROWWISE)


def test_kernel_choice_is_checked_at_construction():
    with pytest.raises(errors.UnsupportedError):
        engine.MicrobatchExecutor(device="cpu", kernel="cuda")
    with pytest.raises(ValueError):
        engine.MicrobatchExecutor(device="cpu", kernel="xla")
    with _cpu(kernel="plain") as ex:
        out = ex.submit_sketch(sk.CWT(100, 8, Context(0)),
                               np.ones((100, 2), np.float32)).result(60)
    assert out.shape == (8, 2)


def test_a_cuda_executor_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(errors.UnsupportedError):
        engine.MicrobatchExecutor()


def test_qualification_declines_with_a_reason():
    ok, why = serve.qualify({"endpoint": "sketch_apply", "dtype": "float64",
                             "family": "JLT", "s_dim": 16, "rowwise": True,
                             "padded": (8, 128), "dist": None})
    assert not ok and "float64" in why
    ok, why = serve.qualify({"endpoint": "fastfood_features",
                             "dtype": "float32", "fut": "dct", "n_dim": 60,
                             "s_dim": 40})
    assert not ok and "dct" in why
    from libskylark_tpu_torch.base import randgen

    ok, why = serve.qualify({"endpoint": "sketch_apply", "dtype": "float32",
                             "family": "SRHT", "s_dim": 16, "rowwise": True,
                             "padded": (8, 64), "dist": None})
    assert not ok and "SRHT" in why
    for family, dist in (("JLT", randgen.Normal()), ("CT", randgen.Cauchy()),
                         ("CWT", None)):
        assert serve.qualify({"endpoint": "sparse_sketch_apply",
                              "dtype": "float32", "family": family,
                              "s_dim": 16, "rowwise": False,
                              "padded": (512, 8), "dist": dist}) == (True,
                                                                     "ok")
    assert jax.default_backend() == "cpu" and math.isfinite(ORACLE)


def test_many_threads_under_a_short_switch_interval():
    """More submitting threads than cores, the interpreter switching
    threads every microsecond: every request completes exactly once with
    its own bits, and the counters add up."""
    import sys

    T = [sk.CWT(64, 8, Context(i)) for i in range(4)]
    rng = np.random.default_rng(9)
    ops = [rng.standard_normal((64, int(rng.integers(1, 9)))).astype(
        np.float32) for _ in range(96)]
    want = [T[i % 4].apply(A, device="cpu") for i, A in enumerate(ops)]
    futs = [None] * len(ops)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu(max_batch=4, linger_us=500, workers=3) as ex:
            def worker(t):
                for i in range(t, len(ops), 16):
                    futs[i] = ex.submit_sketch(T[i % 4], ops[i])

            ts = [threading.Thread(target=worker, args=(t,))
                  for t in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            got = [f.result(timeout=60) for f in futs]
            st = ex.stats()
    finally:
        sys.setswitchinterval(old)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert st["submitted"] == st["completed"] == len(ops)
    assert st["failed"] == 0 and st["queued"] == 0
    assert sum(k * v for k, v in st["cohort_size_hist"].items()) == len(ops)
