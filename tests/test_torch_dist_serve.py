"""The port's dist-serve tier (libskylark_tpu_torch/dist/serve.py and the
executor's dist endpoints) against the JAX package's on the CPU.

- ``IncrementalMerger`` is ``torch.equal`` to ``merge_partials`` in any
  arrival order and at any fan-in, and at partial coverage;
- ``dist_request_digest`` is the reference's hex, so cache keys agree;
- the three endpoints against the local factor of ``sketch_local``'s
  sketch; an identical resubmit is a cache hit;
- the class gates: a standard request below its gate is refused with
  ``SketchCoverageError``, an interactive one resolves early and
  degraded, and a degraded result is never cached;
- every ``dist.shard_task`` span is parented under its ``serve.submit``.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from libskylark_tpu.dist import plan as rp
from libskylark_tpu.dist import serve as rserve
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.dist import plan as dp
from libskylark_tpu_torch.dist import serve as dserve
from libskylark_tpu_torch.engine.serve import MicrobatchExecutor

N, D, S_DIM = 128, 8, 24


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((N, D)).astype(np.float32)
    return A, (A @ rng.standard_normal((D, 1))
               + 0.05 * rng.standard_normal((N, 1))).astype(np.float32)


def _plan(kind, **kw):
    base = dict(kind=kind, n=N, s_dim=S_DIM, d=D, seed=3, targets=1,
                shard_rows=16)
    base.update(kw)
    return dp.ShardPlan(**base).validate()


@pytest.mark.parametrize("kind", ("cwt", "jlt", "srht", "ust"))
def test_the_incremental_merger_is_the_canonical_merge(data, kind):
    A, Y = data
    plan = _plan(kind, shard_rows=13)          # 10 shards, a ragged tail
    src = dp.ArraySource(A, Y)
    parts = {i: dp.compute_shard(plan, i, src, device="cpu")
             for i, _, _ in plan.shards()}
    want = dp.build_result(plan, parts)
    rng = np.random.default_rng(1)
    orders = [list(range(plan.num_shards)),
              list(reversed(range(plan.num_shards)))]
    orders += [rng.permutation(plan.num_shards).tolist() for _ in range(4)]
    for order, fanin in itertools.product(orders, (1, 2, 8)):
        m = dserve.IncrementalMerger(plan, fanin=fanin)
        for i in order:
            m.add(i, parts[i])
            m.add(i, parts[i])                 # a hedge twin: ignored
        got = m.result()
        assert torch.equal(got.SX, want.SX) and torch.equal(got.SY, want.SY)
        assert got.coverage == 1.0 and not got.degraded
    m = dserve.IncrementalMerger(plan, fanin=1)
    for i in (6, 0, 3, 2):
        m.add(i, parts[i])
    got = m.result()
    part = dp.build_result(plan, {i: parts[i] for i in (0, 2, 3, 6)})
    assert isinstance(got, dp.DegradedSketchResult)
    assert torch.equal(got.SX, part.SX) and got.missing == part.missing
    assert dserve.IncrementalMerger(plan, device="cpu").result().coverage \
        == 0.0


def test_the_request_digest_is_the_reference_hex(data, tmp_path):
    A, Y = data
    kw = dict(kind="cwt", n=N, s_dim=S_DIM, d=D, seed=3, targets=1,
              shard_rows=16)
    plan, rplan = dp.ShardPlan(**kw), rp.ShardPlan(**kw)
    for src, rsrc in ((dp.ArraySource(A, Y), rp.ArraySource(A, Y)),
                      (dp.ArraySource(A, batch_rows=7),
                       rp.ArraySource(A, batch_rows=7)),
                      (dp.LibsvmSource(path=str(tmp_path / "x.svm"), n=N,
                                       d=D),
                       rp.LibsvmSource(path=str(tmp_path / "x.svm"), n=N,
                                       d=D))):
        for endpoint, extra in (("dist_sketch", ()),
                                ("dist_svd", (("rank", 4), ("gate", 1.0)))):
            assert dserve.dist_request_digest(endpoint, plan, src, extra) \
                == rserve.dist_request_digest(endpoint, rplan, rsrc, extra)
    assert dserve.dist_request_digest(
        "dist_sketch", plan, dp.ArraySource(torch.from_numpy(A), Y)) == \
        dserve.dist_request_digest("dist_sketch", plan, dp.ArraySource(A, Y))
    for cls in ("interactive", "standard", "best_effort", "custom"):
        assert dserve.class_min_coverage(cls) == \
            rserve.class_min_coverage(cls)


def test_the_three_endpoints_equal_the_local_factor(data):
    A, Y = data
    src = dp.ArraySource(A, Y)
    with MicrobatchExecutor(name="d-ep", device="cpu") as ex:
        for kind in ("cwt", "jlt", "srht", "ust"):
            plan = _plan(kind)
            got = ex.submit_dist_sketch(plan, src).result(timeout=60)
            want = dp.sketch_local(plan, src, device="cpu")
            assert torch.equal(got.SX, want.SX)
            assert torch.equal(got.SY, want.SY)
        out = ex.submit_dist_lstsq(src, s_dim=S_DIM, shard_rows=16,
                                   seed=3).result(timeout=60)
        local = dserve.solve_lstsq(dp.sketch_local(_plan("cwt"), src,
                                                   device="cpu"))
        # the sketch is the same bits; LAPACK on another thread may round
        # the small solve differently
        assert float((out["coef"] - local["coef"]).abs().max()) <= \
            1e-4 * float(local["coef"].abs().max())
        assert out["coverage"] == 1.0 and out["missing"] == []
        out = ex.submit_dist_svd(dp.ArraySource(A), 4, s_dim=S_DIM,
                                 shard_rows=16, seed=3).result(timeout=60)
        local = dserve.solve_svd(dp.sketch_local(
            _plan("jlt", targets=0), dp.ArraySource(A), device="cpu"), 4)
        assert float((out["singular_values"]
                      - local["singular_values"]).abs().max()) <= \
            1e-4 * float(local["singular_values"].max())
        s = ex.stats()["dist"]
    assert s["jobs"] == 6 and s["completed"] == 6 and s["failed"] == 0
    assert s["by_replica"]["<local>"]["shard_tasks"] == 6 * 8
    life = dserve.dist_serve_stats()
    assert life["jobs"] >= 6 and life["merge_depth_peak"] >= 3


def test_an_identical_resubmit_is_a_cache_hit(data):
    A, Y = data
    src = dp.ArraySource(A, Y)
    plan = _plan("cwt")
    with MicrobatchExecutor(name="d-cache", device="cpu", cache=True) as ex:
        first = ex.submit_dist_sketch(plan, src).result(timeout=60)
        second = ex.submit_dist_sketch(plan, dp.ArraySource(A.copy(), Y))
        assert second.done()
        got = second.result()
        c = ex.stats()["cache"]["by_class"]["standard"]
        tasks = ex.stats()["dist"]["by_replica"]["<local>"]["shard_tasks"]
    assert torch.equal(got.SX, first.SX) and got.SX is not first.SX
    assert c["hits"] == 1 and c["misses"] == 1 and c["insertions"] == 1
    assert tasks == plan.num_shards


class _LosesShard(dp.ShardSource):
    """Rows in memory whose shard at ``bad`` always fails to read."""

    def __init__(self, A, Y, bad):
        self.inner = dp.ArraySource(A, Y)
        self.n, self.d, self.targets = self.inner.n, self.inner.d, 1
        self.bad = bad

    def read(self, lo, hi):
        if lo == self.bad:
            raise RuntimeError("this shard's storage is gone")
        return self.inner.read(lo, hi)


def test_class_gates_and_degraded_results_are_never_cached(data):
    A, Y = data
    plan = _plan("cwt")
    src = _LosesShard(A, Y, bad=32)
    with MicrobatchExecutor(name="d-gates", device="cpu", cache=True) as ex:
        with pytest.raises(errors.SketchCoverageError) as ei:
            ex.submit_dist_sketch(plan, src,
                                  qos_class="standard").result(timeout=60)
        assert ei.value.missing == ((32, 48),)
        for _ in range(2):
            res = ex.submit_dist_sketch(
                plan, src, qos_class="interactive",
                min_coverage=0.5).result(timeout=60)
            assert isinstance(res, dp.DegradedSketchResult)
            assert res.coverage == 112 / 128 and res.missing == ((32, 48),)
        c = ex.stats()["cache"]["by_class"]["interactive"]
        s = ex.stats()["dist"]
    assert c["insertions"] == 0 and c["hits"] == 0 and c["misses"] == 2
    assert s["failed"] == 1 and s["completed"] == 2
    want = dp.build_result(plan, {i: dp.compute_shard(plan, i, src,
                                                      device="cpu")
                                  for i in range(8) if i != 2})
    assert torch.equal(res.SX, want.SX)


def test_shard_spans_are_parented_under_the_submit(data):
    from libskylark_tpu_torch.telemetry import metrics as tel
    from libskylark_tpu_torch.telemetry import trace

    A, Y = data
    was = tel.enabled()
    tel.set_enabled(True)
    trace.clear_finished()
    try:
        with MicrobatchExecutor(name="d-spans", device="cpu") as ex:
            ex.submit_dist_sketch(_plan("jlt"), dp.ArraySource(A, Y),
                                  request_id="req-dist").result(timeout=60)
        spans = trace.finished_spans()
    finally:
        tel.set_enabled(was)
        trace.clear_finished()
    submit = [s for s in spans if s.name == "serve.submit"
              and s.request_id == "req-dist"]
    shards = [s for s in spans if s.name == "dist.shard_task"]
    assert len(submit) == 1 and len(shards) == 8
    assert {s.parent_id for s in shards} == {submit[0].span_id}
    assert {s.request_id for s in shards} == {"req-dist"}
    assert {s.attrs["outcome"] for s in shards} == {"settled"}
    assert sorted(s.attrs["index"] for s in shards) == list(range(8))
