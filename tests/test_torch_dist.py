"""Distributed sketching of the port (libskylark_tpu_torch/dist/ and
fleet/ring.py) against the JAX package's dist/ on the CPU.

- ``ShardPlan`` geometry and its fingerprint hex; ``HashRing`` owners
  and preference orders for 1,000 keys;
- the partials and the merged sketch against the reference's: ``cwt``
  and ``ust`` ``torch.equal``, ``jlt`` and ``srht`` within
  1e-4·max|reference|;
- merge-order invariance over permutations, ``torch.equal``;
- degraded accounting and missing ranges equal to the reference's; the
  coverage gate; ingest resume at the consumed offset; the ``dist.shard``,
  ``dist.ingest`` and ``dist.merge`` fault sites;
- the coordinator locally and on in-process stub replicas: retries,
  reassignment, abandonment, and a hedge (the straggler a future that
  waits on an event, so the test does not depend on timing);
- ``randomized_svd`` and ``sketched_lstsq``.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from libskylark_tpu.dist import algorithms as ralg
from libskylark_tpu.dist import plan as rp
from libskylark_tpu.fleet.ring import HashRing as RRing
from libskylark_tpu_torch import dist
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.dist import plan as dp
from libskylark_tpu_torch.fleet import HashRing
from libskylark_tpu_torch.fleet.ring import key_point, ring_hash
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience.policy import RetryPolicy

KINDS = ("cwt", "jlt", "srht", "ust")
N, D, S_DIM, TARGETS = 64, 8, 16, 2


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((N, TARGETS)).astype(np.float32))


def _kw(kind, **kw):
    base = dict(kind=kind, n=N, s_dim=S_DIM, d=D, seed=5, targets=TARGETS,
                shard_rows=10)
    base.update(kw)
    return base


def _plan(kind, **kw):
    return dp.ShardPlan(**_kw(kind, **kw)).validate()


def _partials(plan, src):
    return {i: dp.compute_shard(plan, i, src, device="cpu")
            for i, _, _ in plan.shards()}


def _close(got: torch.Tensor, want, kind: str) -> None:
    want = np.asarray(want)
    if kind in ("cwt", "ust"):
        assert torch.equal(got, torch.from_numpy(np.array(want)))
    else:
        assert float(np.max(np.abs(got.numpy() - want))) <= \
            1e-4 * float(np.max(np.abs(want)))


# -- the plan and the ring -------------------------------------------------


def test_plan_geometry_and_fingerprint(monkeypatch):
    p = _plan("cwt")
    assert p.num_shards == 7 and p.shard_range(6) == (60, 64)
    assert p.shards()[0] == (0, 0, 10)
    with pytest.raises(errors.InvalidParametersError):
        p.shard_range(7)
    for kind in KINDS:
        for extra in ({}, {"shard_rows": 0}, {"replace": False, "seed": 9}):
            kw = _kw(kind, **extra)
            got, want = dp.ShardPlan(**kw), rp.ShardPlan(**kw)
            assert got.to_dict() == want.to_dict()
            assert got.fingerprint() == want.fingerprint()
            assert dp.ShardPlan.from_dict(got.to_dict()) == \
                dp.ShardPlan(**dict(kw, shard_rows=got.rows_per_shard))
    monkeypatch.setenv("SKYLARK_DIST_SHARD_ROWS", "16")
    assert _plan("jlt", shard_rows=0).num_shards == 4
    for bad in ({"kind": "fjlt"}, {"n": 0}, {"kind": "srht", "n": 60},
                {"shard_rows": -1}):
        with pytest.raises(errors.InvalidParametersError):
            _plan(**dict({"kind": "cwt"}, **bad))


def test_hash_ring_places_keys_as_the_reference():
    members = [f"replica-{i}" for i in range(5)]
    got, want = HashRing(members, vnodes=32), RRing(members, vnodes=32)
    keys = [("fp", i) for i in range(1000)]
    assert [got.owner(k) for k in keys] == [want.owner(k) for k in keys]
    assert [list(got.preference(k)) for k in keys[:100]] == \
        [list(want.preference(k)) for k in keys[:100]]
    got.remove("replica-2")
    want.remove("replica-2")
    got.add("replica-2")
    got.remove("replica-2")
    assert [got.owner(k) for k in keys] == [want.owner(k) for k in keys]
    assert len(got) == 4 and "replica-2" not in got
    assert ring_hash("x") == int.from_bytes(__import__("hashlib").blake2b(
        b"x", digest_size=8).digest(), "big")
    assert key_point(("a", 1)) == ring_hash(repr(("a", 1)))
    with pytest.raises(LookupError):
        HashRing().owner("k")
    with pytest.raises(ValueError):
        HashRing(vnodes=0)


# -- partials and merges ----------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_partials_and_merge_match_the_reference(data, kind):
    A, Y = data
    plan, rplan = _plan(kind), rp.ShardPlan(**_kw(kind))
    src = dp.ArraySource(A, Y, batch_rows=4)
    rsrc = rp.ArraySource(A, Y, batch_rows=4)
    parts = _partials(plan, src)
    for i in (0, 3, 6):
        want = rp.compute_shard(rplan, i, rsrc)
        assert set(parts[i]) == set(want)
        for k in want:
            if k == "out_idx":
                np.testing.assert_array_equal(parts[i][k].numpy(), want[k])
            else:
                _close(parts[i][k], want[k], kind)
    got, want = dp.sketch_local(plan, src, device="cpu"), \
        rp.sketch_local(rplan, rsrc)
    assert got.SX.device == torch.device("cpu")
    _close(got.SX, want.SX, kind)
    _close(got.SY, want.SY, kind)
    assert (got.coverage, got.missing, got.shards) == \
        (want.coverage, want.missing, want.shards)
    # re-execution is bit-equal; a cwt partial is also independent of
    # the batching inside the shard
    again = dp.compute_shard(plan, 3, src, device="cpu")
    assert all(torch.equal(again[k], parts[3][k]) for k in parts[3])
    if kind == "cwt":
        again = dp.compute_shard(plan, 3, dp.ArraySource(
            A, Y, batch_rows=3), device="cpu")
        assert all(torch.equal(again[k], parts[3][k]) for k in parts[3])


@pytest.mark.parametrize("kind", KINDS)
def test_merge_order_is_invariant(data, kind):
    A, Y = data
    plan = _plan(kind)
    parts = _partials(plan, dp.ArraySource(A, Y))
    ref = dp.merge_partials(plan, parts)
    rng = np.random.default_rng(0)
    for _ in range(6):
        order = rng.permutation(plan.num_shards).tolist()
        got = dp.merge_partials(plan, {i: parts[i] for i in order})
        assert torch.equal(got["SX"], ref["SX"])
        assert torch.equal(got["SY"], ref["SY"])
    for order in itertools.islice(itertools.permutations(range(4)), 8):
        sub = {i: parts[i] for i in order}
        assert torch.equal(dp.merge_partials(plan, sub)["SX"],
                           dp.merge_partials(plan, dict(sorted(
                               sub.items())))["SX"])


def test_degraded_accounting_equals_the_reference(data):
    A, Y = data
    plan, rplan = _plan("cwt"), rp.ShardPlan(**_kw("cwt"))
    parts = _partials(plan, dp.ArraySource(A, Y))
    rparts = {i: rp.compute_shard(rplan, i, rp.ArraySource(A, Y))
              for i in range(plan.num_shards)}
    for drop in ((2, 3, 6), (0,), (1, 5)):
        kept = {i: p for i, p in parts.items() if i not in drop}
        rkept = {i: p for i, p in rparts.items() if i not in drop}
        got, want = dp.build_result(plan, kept), rp.build_result(rplan,
                                                                 rkept)
        assert isinstance(got, dp.DegradedSketchResult) and got.degraded
        assert (got.rows_merged, got.coverage, got.missing, got.shards,
                got.shards_merged) == (want.rows_merged, want.coverage,
                                       want.missing, want.shards,
                                       want.shards_merged)
        assert dp.missing_ranges(plan, kept) == \
            rp.missing_ranges(rplan, rkept)
        _close(got.SX, want.SX, "cwt")
    empty = dp.build_result(plan, {}, device="cpu")
    assert empty.coverage == 0.0 and not torch.any(empty.SX)


def test_the_coverage_gate(data):
    A, Y = data
    plan = _plan("ust")
    parts = _partials(plan, dp.ArraySource(A, Y))
    del parts[5]
    res = dp.build_result(plan, parts)
    assert res.require(0.8) is res
    with pytest.raises(errors.SketchCoverageError) as ei:
        res.require(1.0)
    assert ei.value.coverage == res.coverage
    assert ei.value.missing == ((50, 60),)


# -- ingest and the fault sites ------------------------------------------


class _FlakyOnce(dp.ShardSource):
    """A source whose first read raises after ``ok_batches`` batches, the
    transient transport loss mid-shard; it records every read's start."""

    def __init__(self, inner, ok_batches):
        self.inner = inner
        self.n, self.d, self.targets = inner.n, inner.d, inner.targets
        self.ok_batches = ok_batches
        self.read_offsets = []
        self._tripped = False

    def read(self, lo, hi):
        self.read_offsets.append(lo)
        for k, item in enumerate(self.inner.read(lo, hi)):
            if not self._tripped and k == self.ok_batches:
                self._tripped = True
                raise errors.IOError_("injected transport loss")
            yield item


def _no_wait(attempts=4):
    return RetryPolicy(max_attempts=attempts, base_delay=0.0,
                       max_delay=0.0, jitter="none", sleep=lambda s: None)


def test_ingest_resumes_at_the_consumed_offset(data):
    A, _ = data
    plan = _plan("cwt", targets=0, shard_rows=20)
    flaky = _FlakyOnce(dp.ArraySource(A, batch_rows=4), 2)
    out = dp.compute_shard(plan, 1, flaky, retry=_no_wait(), device="cpu")
    ref = dp.compute_shard(plan, 1, dp.ArraySource(A, batch_rows=4),
                           device="cpu")
    assert torch.equal(out["SX"], ref["SX"])
    assert flaky.read_offsets == [20, 28]
    reads = []

    class Short(dp.ShardSource):
        n, d, targets = N, D, 0

        def read(self, lo, hi):
            reads.append(lo)
            yield lo, A[lo:hi - 2], None

    with pytest.raises(errors.IOError_):
        dp.compute_shard(plan, 0, Short(), retry=_no_wait(3), device="cpu")
    assert len(reads) == 3
    assert list(dp._grid_spans(3, 10, 4)) == [(3, 4), (4, 8), (8, 10)]


def test_the_three_fault_sites(data):
    A, Y = data
    plan = _plan("jlt", targets=0, shard_rows=20)
    src = dp.ArraySource(A, batch_rows=4)
    ref = dp.compute_shard(plan, 0, src, device="cpu")
    with faults.fault_plan({"seed": 1, "faults": [
            {"site": "dist.ingest", "error": "IOError_", "on_hit": 3}]}) \
            as p:
        out = dp.compute_shard(plan, 0, src, retry=_no_wait(),
                               device="cpu")
    assert [f[0] for f in p.fired] == ["dist.ingest"]
    assert torch.equal(out["SX"], ref["SX"])
    with faults.fault_plan({"seed": 1, "faults": [
            {"site": "dist.shard", "error": "IOError_", "on_hit": 1}]}):
        with pytest.raises(errors.IOError_):
            dp.compute_shard(plan, 0, src, device="cpu")
    with faults.fault_plan({"seed": 1, "faults": [
            {"site": "dist.merge", "error": "SketchError"}]}):
        with pytest.raises(errors.SketchError):
            dp.merge_partials(plan, {0: ref})


def test_file_sources_read_ranges(data, tmp_path):
    import h5py

    rng = np.random.default_rng(3)
    A = rng.integers(1, 5, size=(N, D)).astype(np.float32)
    y = rng.integers(0, 2, size=N)
    path = tmp_path / "rows.svm"
    with open(path, "w") as f:
        for i in range(N):
            feats = " ".join(f"{j + 1}:{A[i, j]:.1f}" for j in range(D))
            f.write(f"{y[i]} {feats}\n")
    src = dp.LibsvmSource(path=str(path), n=N, d=D, targets=1,
                          batch_rows=10)
    got = np.concatenate([X for _, X, _ in src.read(15, 40)])
    np.testing.assert_array_equal(got, A[15:40])
    plan = dp.ShardPlan(kind="cwt", n=N, s_dim=S_DIM, d=D, seed=5,
                        targets=1, shard_rows=10)
    ref = dp.sketch_local(plan, dp.ArraySource(A, y.astype(np.float32),
                                               batch_rows=10), device="cpu")
    res = dp.sketch_local(plan, src, device="cpu")
    assert torch.equal(res.SX, ref.SX) and torch.equal(res.SY, ref.SY)
    h5 = tmp_path / "rows.h5"
    with h5py.File(h5, "w") as f:
        f["X"] = A
        f["Y"] = y.astype(np.float32)
    hsrc = dp.HDF5Source.probe(str(h5), batch_rows=10)
    assert (hsrc.n, hsrc.d, hsrc.targets) == (N, D, 1)
    res = dp.sketch_local(plan, hsrc, device="cpu")
    assert torch.equal(res.SX, ref.SX) and torch.equal(res.SY, ref.SY)
    wire = dp.source_to_wire(dp.ArraySource(A, batch_rows=10).subrange(
        20, 30))
    back = dp.source_from_wire(wire)
    np.testing.assert_array_equal(
        np.concatenate([X for _, X, _ in back.read(20, 30)]), A[20:30])
    assert dp.source_from_wire(src) is src


# -- the coordinator -------------------------------------------------------


class _Replica:
    """An in-process replica computing shard tasks on a worker thread on
    the CPU. ``stall`` holds the first task's future on an event.
    ``inline`` computes every other task before ``shard`` returns, so its
    future is already settled: no such attempt is ever in flight, however
    loaded the machine, and only the stalled one can age into a hedge."""

    def __init__(self, name, stall=None, inline=False):
        self.name = name
        self.stall = stall
        self.inline = inline
        self.tasks = []
        self._tpe = ThreadPoolExecutor(1)

    def state(self):
        return "SERVING"

    def shard(self, task):
        self.tasks.append(int(task["index"]))
        if self.stall is not None and len(self.tasks) == 1:
            fut: Future = Future()
            ev = self.stall

            def later():
                ev.wait(30)
                fut.set_result(dp.execute_task(task, device="cpu"))

            threading.Thread(target=later, daemon=True).start()
            return fut
        if self.inline:
            fut = Future()
            try:
                fut.set_result(dp.execute_task(task, device="cpu"))
            except Exception as e:  # noqa: BLE001 — the attempt's failure
                fut.set_exception(e)
            return fut
        return self._tpe.submit(dp.execute_task, task, "cpu")


def test_the_coordinator_locally(data):
    A, Y = data
    plan = _plan("srht")
    src = dp.ArraySource(A, Y)
    ref = dp.sketch_local(plan, src, device="cpu")
    co = dist.DistSketchCoordinator(device="cpu")
    res = co.sketch(plan, src)
    assert torch.equal(res.SX, ref.SX) and torch.equal(res.SY, ref.SY)
    st = co.stats()
    assert st["dispatched"] == plan.num_shards and st["merges"] == 1
    assert st["by_replica"] == {"<local>": plan.num_shards}
    life = dist.dist_stats()
    assert life["merges"] >= 1 and life["last_coverage"] == 1.0
    with pytest.raises(errors.InvalidParametersError):
        co.sketch(_plan("srht", n=2 * N), src)


def test_replicas_retry_and_reassign_bit_equal(data):
    A, Y = data
    plan = _plan("cwt")
    src = dp.ArraySource(A, Y)
    ref = dp.sketch_local(plan, src, device="cpu")
    reps = [_Replica("r0"), _Replica("r1")]
    co = dist.DistSketchCoordinator(replicas=reps, retries=3,
                                    max_inflight=1)
    with faults.fault_plan({"seed": 7, "faults": [
            {"site": "dist.shard", "error": "IOError_", "every": 3}]}) \
            as p:
        res = co.sketch(plan, src)
    assert p.fired and res.coverage == 1.0
    assert torch.equal(res.SX, ref.SX) and torch.equal(res.SY, ref.SY)
    st = co.stats()
    assert st["retried"] == len(p.fired)
    assert st["reassigned"] >= 1 and st["abandoned"] == 0
    assert sum(len(r.tasks) for r in reps) == st["dispatched"]
    # the first attempts follow the ring's owners
    ring = HashRing(["r0", "r1"])
    owners = [ring.owner((plan.fingerprint(), i))
              for i in range(plan.num_shards)]
    assert owners.count("r0") + owners.count("r1") == plan.num_shards


def test_an_exhausted_budget_gates_and_degrades(data):
    A, Y = data
    plan = _plan("ust")
    src = dp.ArraySource(A, Y)
    kill = {"seed": 7, "faults": [
        {"site": "dist.shard", "error": "IOError_", "after": 2}]}
    co = dist.DistSketchCoordinator(replicas=[_Replica("a")], retries=1,
                                    max_inflight=1)
    with faults.fault_plan(kill):
        with pytest.raises(errors.SketchCoverageError):
            co.sketch(plan, src)
    co2 = dist.DistSketchCoordinator(replicas=[_Replica("a")], retries=1,
                                     max_inflight=1)
    with faults.fault_plan(kill):
        res = co2.sketch(plan, src, min_coverage=0.2)
    assert isinstance(res, dp.DegradedSketchResult)
    assert res.rows_merged == 20 and res.missing == ((20, 64),)
    assert co2.stats()["abandoned"] == 5
    want = dp.build_result(plan, {i: dp.compute_shard(plan, i, src,
                                                      device="cpu")
                                  for i in (0, 1)})
    assert torch.equal(res.SX, want.SX)


def test_a_hedge_rescues_a_straggler(data):
    A, Y = data
    plan = _plan("cwt")
    src = dp.ArraySource(A, Y)
    ref = dp.sketch_local(plan, src, device="cpu")
    release = threading.Event()
    # every attempt but the stalled one settles inside its dispatch, so
    # the straggler is the only attempt that can age past the delay: the
    # hedge count is exact under any load
    reps = [_Replica("slow", stall=release, inline=True),
            _Replica("fast", inline=True)]
    co = dist.DistSketchCoordinator(replicas=reps, retries=2, hedge=True,
                                    hedge_delay_s=0.01)
    try:
        res = co.sketch(plan, src)
    finally:
        release.set()
    assert co.stats()["hedged"] == 1
    stalled = reps[0].tasks[0]
    assert stalled in reps[1].tasks
    # the stalled shard is the one mirrored: "fast" ran it as a hedge
    assert reps[1].tasks.count(stalled) == 1
    assert torch.equal(res.SX, ref.SX) and torch.equal(res.SY, ref.SY)


# -- the algorithms --------------------------------------------------------


def test_randomized_svd_and_sketched_lstsq_match_the_reference(data):
    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((96, 6)))
    V, _ = np.linalg.qr(rng.standard_normal((12, 6)))
    A = (U * np.array([9.0, 7.0, 5.0, 3.0, 2.0, 1.0]) @ V.T).astype(
        np.float32)
    src, rsrc = dp.ArraySource(A), rp.ArraySource(A)
    got = dist.randomized_svd(src, 4, s_dim=32, shard_rows=16, seed=2,
                              device="cpu")
    want = ralg.randomized_svd(rsrc, 4, s_dim=32, shard_rows=16, seed=2)
    np.testing.assert_allclose(got["singular_values"].numpy(),
                               want["singular_values"], rtol=1e-4)
    assert got["coverage"] == 1.0 and not got["degraded"]
    x = rng.standard_normal((12, 1)).astype(np.float32)
    Y = A @ x + 0.01 * rng.standard_normal((96, 1)).astype(np.float32)
    got = dist.sketched_lstsq(dp.ArraySource(A, Y), s_dim=48,
                              shard_rows=16, seed=3, device="cpu")
    want = ralg.sketched_lstsq(rp.ArraySource(A, Y), s_dim=48,
                               shard_rows=16, seed=3)
    assert float(np.max(np.abs(got["coef"].numpy() - want["coef"]))) <= \
        1e-4 * float(np.max(np.abs(want["coef"])))
    with pytest.raises(errors.InvalidParametersError):
        dist.sketched_lstsq(src, s_dim=8, device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        dist.svd_plan(src, 0)
