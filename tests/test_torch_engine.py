"""The port's executable cache and compiled wrapper
(libskylark_tpu_torch/engine/cache.py, compiled.py) held to the contracts
of the reference's tests/test_engine.py, on the CPU, where an executable
is the body itself, keyed and counted as a captured graph is on the card.

The oracle is the port's own behaviour (its counters, its body's calls),
never the reference's compile counters (ROADMAP C3).
"""

from __future__ import annotations

import json
import threading
import warnings

import pytest
import torch

from libskylark_tpu_torch import engine, sketch as sk
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.engine.cache import CacheEntry, ExecutableCache
from libskylark_tpu_torch.resilience import faults


@pytest.fixture()
def fresh_engine():
    engine.reset()
    yield
    engine.reset()


class TestCompiledWrapper:
    def test_hit_miss_counters(self, fresh_engine):
        @engine.compiled(static_argnames=("k",))
        def f(A, *, k):
            return A.sum() * k

        A = torch.ones((8, 8))
        assert float(f(A, k=3)) == 192.0
        assert float(f(A, k=3)) == 192.0
        s = engine.stats()
        assert (s.misses, s.hits, s.recompiles, s.compiles) == (1, 1, 0, 1)
        assert s.executions == 2 and f.stats.hits == 1

    def test_static_and_shape_changes_key_separately(self, fresh_engine):
        @engine.compiled(static_argnames=("k",))
        def f(A, *, k):
            return A * k

        f(torch.ones(4), k=1)
        f(torch.ones(4), k=2)                       # static: new key
        f(torch.ones(8), k=1)                       # shape: new key
        f(torch.ones(4, dtype=torch.float64), k=1)  # dtype too
        s = engine.stats()
        assert s.misses == 4 and s.hits == 0 and s.recompiles == 0

    def test_dynamic_kwargs_rejected(self, fresh_engine):
        @engine.compiled(static_argnames=("k",))
        def f(A, *, k):
            return A * k

        with pytest.raises(TypeError, match="positional"):
            f(A=torch.ones(4), k=1)

    def test_numbers_are_inputs_not_keys(self, fresh_engine):
        @engine.compiled
        def f(A, lam):
            return A * lam

        assert torch.equal(f(torch.ones(3), 2.0), torch.full((3,), 2.0))
        assert torch.equal(f(torch.ones(3), 5.0), torch.full((3,), 5.0))
        assert engine.stats().misses == 1 and engine.stats().hits == 1

    def test_key_fn_extras_distinguish_closures(self, fresh_engine):
        def make(scale):
            def f(A):
                return A * scale

            return engine.compiled(f, name="scaled",
                                   key_fn=lambda *a: (scale,))

        A = torch.ones(4)
        assert float(make(2.0)(A)[0]) == 2.0
        assert float(make(3.0)(A)[0]) == 3.0   # another extra: a miss
        assert float(make(2.0)(A)[0]) == 2.0   # same extra, new wrapper
        s = engine.stats()
        assert s.misses == 2 and s.hits == 1

    def test_transforms_key_by_signature_not_seed(self, fresh_engine):
        @engine.compiled
        def f(A, T):
            return T.apply(A, sk.COLUMNWISE, device=A.device)

        A = torch.ones((64, 3))
        ctx = Context(9)
        T1, T2 = sk.JLT(64, 8, ctx), sk.JLT(64, 8, ctx)
        assert torch.equal(f(A, T1), T1.apply(A, sk.COLUMNWISE, device="cpu"))
        assert torch.equal(f(A, T2), T2.apply(A, sk.COLUMNWISE, device="cpu"))
        f(A, sk.JLT(64, 16, ctx))              # another signature: a miss
        f(A, sk.CWT(64, 8, ctx))
        s = engine.stats()
        assert s.misses == 3 and s.hits == 1

    def test_a_seed_read_outside_a_seeded_method_raises(self, fresh_engine):
        """A body that makes a per-seed value from a key itself would bake
        it into a captured graph: the CPU body runs under the same binding
        and sealed keys as a capture, so it raises here too."""
        from libskylark_tpu_torch.base import errors, randgen

        @engine.compiled
        def f(A, T):
            return A + randgen.stream_slice(T.subkey(7), randgen.Normal(),
                                            0, A.shape[0])

        with pytest.raises(errors.UnsupportedError, match="@seeded"):
            f(torch.ones(8), sk.JLT(8, 4, Context(1)))
        sk.JLT(8, 4, Context(1)).subkey(7)   # unsealed outside the body

    def test_pinned_operator_is_keyed_and_an_input(self, fresh_engine):
        """A pinned operator changes the route: it is part of the
        signature, and inside the body an input made per call, so a
        second pinned transform gets its own operator, not the first's."""
        @engine.compiled
        def f(A, T):
            return T.apply(A, sk.COLUMNWISE, device=A.device)

        A = torch.ones((64, 3), dtype=torch.float64)
        ctx = Context(10)
        T1 = sk.JLT(64, 8, ctx).materialize(torch.float64, "cpu")
        T2 = sk.JLT(64, 8, ctx).materialize(torch.float64, "cpu")
        T3 = sk.JLT(64, 8, ctx)
        assert sk.transform.signature(T1) != sk.transform.signature(T3)
        for T in (T1, T2, T3):
            assert torch.equal(f(A, T), T.apply(A, sk.COLUMNWISE,
                                                device="cpu"))
        assert not torch.equal(f(A, T1), f(A, T2))
        s = engine.stats()
        assert s.misses == 2 and s.hits == 3

    def test_other_arguments_refused(self, fresh_engine):
        @engine.compiled
        def f(A, x):
            return A

        with pytest.raises(TypeError, match="positional arguments"):
            f(torch.ones(2), "text")

    def test_donation_explicit_consumes_operand(self, fresh_engine):
        @engine.compiled(donate_argnums=(0,))
        def f(A):
            return A + 1

        A = torch.ones(32)
        assert torch.equal(f(A), torch.full((32,), 2.0))
        assert A.numel() == 0
        with pytest.raises(RuntimeError):
            A.view(4, 8)

    def test_auto_donation_off_by_default(self, fresh_engine, monkeypatch):
        monkeypatch.delenv("SKYLARK_ENGINE_DONATE", raising=False)

        @engine.compiled(donate_argnums=(0,), donate="auto")
        def f(A):
            return A + 1

        A = torch.ones(32)
        f(A)
        assert torch.equal(A + 1, torch.full((32,), 2.0))  # still alive

    def test_auto_donation_opt_in(self, fresh_engine, monkeypatch):
        @engine.compiled(donate_argnums=(0,), donate="auto")
        def f(A):
            return A + 1

        f(torch.ones(32))
        monkeypatch.setenv("SKYLARK_ENGINE_DONATE", "1")
        assert engine.donation_enabled() and engine.maybe_donate((0,)) == (0,)
        A = torch.ones(32)
        f(A)  # the donation flag is part of the key: a new entry
        with pytest.raises(RuntimeError):
            A.view(4, 8)
        s = engine.stats()
        assert s.misses == 2 and s.recompiles == 0

    def test_digest_tracks_serialization(self):
        ctx = Context(seed=9)
        t1 = sk.JLT(64, 8, Context(seed=9))
        t2 = sk.JLT(64, 8, Context(seed=9))
        t3, t4 = sk.JLT(64, 8, ctx), sk.JLT(64, 8, ctx)
        assert engine.digest(t1) == engine.digest(t2)
        assert engine.digest(t3) != engine.digest(t4)

    def test_stats_dump_atomic(self, fresh_engine, tmp_path):
        @engine.compiled
        def f(A):
            return A + 1

        f(torch.ones(4))
        path = tmp_path / "engine_stats.json"
        engine.dump_stats(str(path))
        doc = json.loads(path.read_text())
        assert doc["stats"]["misses"] == 1 and doc["cache_size"] == 1
        assert doc["entries"][0]["calls"] == 1
        assert doc["lifetime"]["misses"] >= 1
        assert [p.name for p in tmp_path.iterdir()] == ["engine_stats.json"]

    def test_fingerprints(self):
        assert engine.plan_fingerprint() == "no-plan-cache"
        assert engine.code_version(TestCompiledWrapper.test_fingerprints)


class TestExecutableCacheLRU:
    def _entry(self, name="e"):
        return CacheEntry(executable=None, name=name, compile_seconds=0.0)

    def test_eviction_and_thrash_counter(self):
        c = ExecutableCache(maxsize=2)
        for k in ("a", "b"):
            assert c.lookup(k) is None
            c.insert(k, self._entry(k))
        assert c.lookup("a") is not None        # refresh a: b is LRU
        assert c.lookup("c") is None
        c.insert("c", self._entry("c"))         # evicts b
        assert c.stats.evictions == 1
        assert c.lookup("b") is None            # thrash: seen before
        assert c.stats.recompiles == 1
        assert len(c) == 2

    @pytest.mark.parametrize("sizes,budget,kept", [
        ((30, 30, 30), 100, 3), ((40, 40, 40), 100, 2),
        ((10, 200, 10), 100, 1), ((60, 60, 60, 60), 60, 1)])
    def test_byte_budget_evicts_least_recent(self, sizes, budget, kept):
        """Past the byte budget the least recently used entries go, never
        the newest, however large."""
        class Exe:
            def __init__(self, nbytes):
                self.nbytes = nbytes

        c = ExecutableCache(maxsize=16)
        for i, n in enumerate(sizes):
            c.acquire(i)
            c.insert(i, CacheEntry(executable=Exe(n), name=str(i),
                                   compile_seconds=0.0))
            c.trim(budget)
            assert c.nbytes() <= budget or len(c) == 1
        assert c.keys() == list(range(len(sizes)))[-kept:]
        assert c.stats.evictions == len(sizes) - kept

    def test_graph_copy_in_skips_the_same_unchanged_tensor(self):
        """A hit copies an argument into its static buffer unless it is
        the tensor copied in last time at the same version."""
        from libskylark_tpu_torch.engine.compiled import _Graph

        g = object.__new__(_Graph)
        a, b = torch.ones(4), torch.ones(4)
        g._sources = [_Graph._source(a), None]
        assert g._holds(0, a) and not g._holds(0, b)
        assert not g._holds(1, a)
        a.add_(1)
        assert not g._holds(0, a)
        g._sources[0] = _Graph._source(a)
        a[1:].mul_(2)                          # a write through a view
        assert not g._holds(0, a)
        with torch.inference_mode():
            c = torch.ones(4)
        assert _Graph._source(c) is None       # no version: copied in

    def test_reset_clears_seen_and_keeps_lifetime(self):
        c = ExecutableCache(maxsize=4)
        c.lookup("a")
        c.insert("a", self._entry())
        c.reset()
        assert c.lookup("a") is None
        assert c.stats.recompiles == 0          # a fresh slate
        assert c.lifetime.misses == 1


class TestCacheThreadSafety:
    def test_concurrent_calls_single_flight(self, fresh_engine):
        calls = []

        @engine.compiled
        def f(A):
            calls.append(1)
            return A * 2.0 + 1.0

        A = torch.ones((32, 32))
        n_threads, per = 8, 25
        barrier = threading.Barrier(n_threads)
        errs = []

        def worker():
            try:
                barrier.wait()
                for _ in range(per):
                    f(A)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errs and not any(t.is_alive() for t in threads)
        s = engine.stats()
        total = n_threads * per
        assert s.misses == 1 and s.compiles == 1    # one materialization
        assert s.hits == total - 1 and s.executions == total
        assert len(calls) == total and len(engine.cache()) == 1

    def test_concurrent_distinct_keys_lru_integrity(self):
        c = ExecutableCache(maxsize=4)
        n_threads, per, n_keys = 8, 200, 16
        barrier = threading.Barrier(n_threads)

        def worker(tid):
            barrier.wait()
            for i in range(per):
                k = (tid * per + i) % n_keys
                if c.acquire(k) is None:
                    c.insert(k, CacheEntry(executable=None, name=str(k),
                                           compile_seconds=0.0))

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert len(c) <= 4
        s = c.stats
        assert s.hits + s.misses == n_threads * per
        assert s.evictions == s.misses - len(c)

    def test_compile_fault_releases_waiters(self, fresh_engine):
        @engine.compiled
        def f(A):
            return A + 1

        A = torch.ones(8)
        n_threads = 6
        barrier = threading.Barrier(n_threads)
        outcomes = []
        plan = {"faults": [{"site": "engine.compile", "error": "ValueError",
                            "prob": 1.0}]}

        def worker():
            barrier.wait()
            try:
                f(A)
                outcomes.append("ok")
            except ValueError:
                outcomes.append("raised")

        with faults.fault_plan(plan) as active:
            threads = [threading.Thread(target=worker)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        # an aborted materialization releases its waiters, each of which
        # inherits it and fails the same way; nothing enters `seen`
        assert not any(t.is_alive() for t in threads)
        assert outcomes == ["raised"] * n_threads
        assert len(active.fired) == n_threads
        assert engine.stats().recompiles == 0 and len(engine.cache()) == 0
        assert float(f(A)[0]) == 2.0            # serviceable afterwards


class TestPersistentCache:
    def test_nothing_to_wire(self, tmp_path, monkeypatch):
        monkeypatch.delenv("SKYLARK_EXEC_CACHE_DIR", raising=False)
        assert not engine.enable_persistent_cache("0")
        assert not engine.enable_persistent_cache("")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert not engine.enable_persistent_cache(str(tmp_path))
        assert list(tmp_path.iterdir()) == []
