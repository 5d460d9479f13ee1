"""Process replicas of the port's fleet (``libskylark_tpu_torch/fleet/
replica.py``, ``pool.py``) on the CPU, against the reference's contracts
(``tests/test_fleet.py``'s process tier, ``tests/test_fleet_shm.py``'s
replica tier, the crash reap of ``docs/fleet``).

One module-scoped pool of two spawned children (shared-memory transport
on) and one child with the transport off serve every test; they boot
together, and the tests run in file order: the SIGTERM and ``kill -9``
tests come last because they take the children down.

Oracles:

- *results*: through a router over the process pool, and through the
  transport-off child, each result is a tensor on the pool's device,
  ``torch.equal`` to one in-process executor's and to a thread replica's;
  operands and results above the minimum size rode the rings both ways;
- *boot*: the child applied the parent's propagated environment, reports
  its kernel launch counters (``boot_info()["launches"]``, a key of the
  port only) and its buckets' routes;
- *residency, dist, sessions* through the rings: a registered operand
  serves by reference; a dist cwt sketch over the process pool is
  ``torch.equal`` to ``sketch_local``; a cwt session through the router
  equals the one-shot CWT;
- *preemption*: a real SIGTERM to one child drains it (every in-flight
  future resolves equal, its hook fires once, the hub publishes DRAINING
  then STOPPED, the router sheds to the peer with no failover);
- *crash*: a ``kill -9``'d child fails its in-flight futures with
  ``ServeOverloadedError``, is reaped (``crashed_names``), and no
  ``/dev/shm`` entry is left.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from libskylark_tpu_torch import Context, engine, fleet
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.dist import plan as dp
from libskylark_tpu_torch.resilience import health

DEV = "cpu"

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/dev/shm"),
    reason="POSIX shared memory filesystem not available")


def _until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The process pool (shm on), its router, and a transport-off
    child, booted together."""
    sdir = str(tmp_path_factory.mktemp("sessions"))
    old = os.environ.get("SKYLARK_SESSION_DIR")
    os.environ["SKYLARK_SESSION_DIR"] = sdir
    out = {"sdir": sdir}

    def boot_plain():
        out["plain"] = fleet.ProcessReplica("plain", shm=False,
                                            device=DEV, max_batch=8,
                                            linger_us=1000)

    t = threading.Thread(target=boot_plain)
    t.start()
    pool = fleet.ReplicaPool(2, backend="process", device=DEV,
                             max_batch=8, linger_us=1000)
    t.join()
    router = fleet.Router(pool)
    out.update(pool=pool, router=router)
    try:
        yield out
    finally:
        router.close()
        pool.shutdown()
        out["plain"].shutdown()
        if old is None:
            os.environ.pop("SKYLARK_SESSION_DIR", None)
        else:
            os.environ["SKYLARK_SESSION_DIR"] = old
        assert fleet.shm_entries(pid=os.getpid()) == []


def _executor_results(reqs):
    ex = engine.MicrobatchExecutor(max_batch=8, linger_us=500, device=DEV)
    try:
        return [ex.submit_sketch(T, A, dim).result(timeout=60)
                for T, A, dim in reqs]
    finally:
        ex.shutdown()


def _requests(seed=0):
    """JLT 256 → 32 rowwise on 33–64 rows (tensors, one transposed, and
    arrays: 33–65 KB, on the rings) and CWT 128 → 32 columnwise on 200
    columns (25.6 KB results, on the rings back)."""
    rng = np.random.default_rng(seed)
    T = sk.JLT(256, 32, Context(seed=seed + 1))
    C = sk.CWT(128, 32, Context(seed=seed + 2))
    reqs = []
    for i, rows in enumerate((33, 40, 48, 64)):
        A = rng.standard_normal((rows, 256)).astype(np.float32)
        if i == 1:
            A = torch.from_numpy(A)
        elif i == 2:
            A = torch.from_numpy(np.ascontiguousarray(A.T)).T
        reqs.append((T, A, sk.ROWWISE))
    for _ in range(3):
        reqs.append((C, rng.standard_normal((128, 200)).astype(np.float32),
                     sk.COLUMNWISE))
    return reqs


def test_results_equal_in_process_with_shm_on_and_off(procs):
    pool, router, plain = procs["pool"], procs["router"], procs["plain"]
    reqs = _requests()
    want = _executor_results(reqs)
    sends0 = {r.name: r.transport_stats()["sends"]
              for r in pool.replicas()}
    got = [router.submit_sketch(T, A, dim) for T, A, dim in reqs]
    off = [plain.submit("sketch_apply", transform=T, A=A, dimension=dim)
           for T, A, dim in reqs]
    thread = fleet.ThreadReplica("t0", device=DEV, max_batch=8,
                                 linger_us=1000)
    try:
        th = [thread.submit("sketch_apply", transform=T, A=A,
                            dimension=dim) for T, A, dim in reqs]
        for futs in (got, off, th):
            for f, w in zip(futs, want):
                out = f.result(timeout=120)
                assert isinstance(out, torch.Tensor)
                assert out.device == torch.device(DEV)
                assert torch.equal(out, w)
    finally:
        thread.shutdown()
    st = router.stats()
    assert st["routed"] >= len(reqs) and st["failover"] == 0
    sent = sum(r.transport_stats()["sends"] - sends0[r.name]
               for r in pool.replicas())
    assert sent >= len(reqs)              # every operand rode a slot
    back = sum((r.boot_info()["shm"] or {}).get("sends", 0)
               for r in pool.replicas())
    assert back >= 3                      # the CWT results rode back
    assert plain.transport_stats() is None
    assert plain.boot_info()["shm"] is None
    assert fleet.shm_entries(pid=os.getpid()) == []


def test_boot_info_env_launches_and_routes(procs):
    pool = procs["pool"]
    for r in pool.replicas():
        info = r.boot_info()
        assert info["env"]["SKYLARK_SESSION_DIR"] == procs["sdir"]
        assert set(info["env"]) == set(fleet.PROPAGATED_ENV)
        launches = info["launches"]
        assert {"dense_batched_rowwise", "hash_batched",
                "hash_accumulate"} <= set(launches)
        # on the CPU every flush takes the plain program: no launch
        assert all(v == 0 for v in launches.values())
        for bucket in r.stats()["by_bucket"].values():
            assert bucket["route"] == "plain"
        assert r.boot_seconds and r.boot_seconds > 0


def test_operand_residency_over_the_rings(procs):
    router = procs["router"]
    T = sk.JLT(256, 32, Context(seed=9))
    A = np.random.default_rng(9).standard_normal(
        (50, 256)).astype(np.float32)
    want = _executor_results([(T, A, sk.ROWWISE)])[0]
    ref = router.register_operand(A)
    assert torch.equal(
        router.submit_sketch(T, ref, sk.ROWWISE).result(timeout=60), want)
    assert router.unregister_operand(ref) == 2


def test_dist_sketch_over_process_replicas(procs):
    """Shard rows cross to the children over the rings, partials come
    back as host arrays and merge on the pool's device: bit-equal to
    ``sketch_local``, and the children ran the shards."""
    router = procs["router"]
    rng = np.random.default_rng(4)
    X = rng.standard_normal((512, 9)).astype(np.float32)
    Y = rng.standard_normal((512, 1)).astype(np.float32)
    plan = dp.ShardPlan(kind="cwt", n=512, s_dim=32, d=9, seed=5,
                        targets=1, shard_rows=64)
    src = dp.ArraySource(X, Y)
    want = dp.sketch_local(plan, src, device=DEV)
    got = router.submit_dist_sketch(plan, src).result(timeout=120)
    assert got.coverage == 1.0
    assert torch.equal(got.SX, want.SX) and torch.equal(got.SY, want.SY)
    by = router.stats()["dist_coordinator"]["by_replica"]
    assert set(by) <= set(procs["pool"].names()) and sum(by.values()) >= 8


def test_session_through_the_router(procs):
    router = procs["router"]
    rng = np.random.default_rng(6)
    X = rng.standard_normal((96, 7)).astype(np.float32)
    sid = router.open_sketch_session("cwt", n=96, s_dim=16, d=7, seed=3)
    for seq, lo in enumerate(range(0, 96, 32), start=1):
        router.session_append(sid, torch.from_numpy(X[lo:lo + 32]),
                              seq=seq).result(timeout=60)
    out = router.session_finalize(sid).result(timeout=60)
    want = sk.CWT(96, 16, Context(seed=3)).apply(
        X, sk.COLUMNWISE, device=DEV)
    assert isinstance(out["SX"], torch.Tensor)
    assert torch.equal(out["SX"], want)


def test_sigterm_drains_one_child(procs):
    pool, router = procs["pool"], procs["router"]
    reqs = _requests(seed=3)[4:]          # one CWT class
    want = _executor_results(reqs)
    T, A, dim = reqs[0]
    victim = router.owner_of("sketch_apply", transform=T, A=A,
                             dimension=dim)
    seen, fired = [], []
    unsub = health.subscribe(
        lambda src, old, new: seen.append(new)
        if src is pool.get(victim) else None)
    pool.on_replica_drain(victim, lambda: fired.append(victim))
    try:
        futs = [router.submit_sketch(T, A, dim) for T, A, dim in reqs]
        assert pool.preempt_replica(victim, timeout=90)
        for f, w in zip(futs, want):
            assert torch.equal(f.result(timeout=60), w)
        assert fired == [victim]
        assert seen[-2:] == ["DRAINING", "STOPPED"]
        assert victim not in router.routable()
        fo = router.stats()["failover"]
        futs = [router.submit_sketch(T, A, dim) for T, A, dim in reqs]
        for f, w in zip(futs, want):
            assert torch.equal(f.result(timeout=60), w)
        assert router.stats()["failover"] == fo   # the ring had updated
        assert pool.crashed_names() == []
    finally:
        unsub()


def test_kill_9_reaped_and_no_leak(procs):
    """The last live child, ``kill -9``'d: its in-flight request fails
    (never hangs), the pool reaps it, and no segment is left (the
    autoscaler's replacement of a reaped child is phase 4l's, rehearsed
    in ``tests/test_torch_fleet_chip_phase.py``)."""
    pool = procs["pool"]
    live = [n for n in pool.names() if pool.get(n).state() != "STOPPED"]
    assert len(live) == 1
    victim = pool.get(live[0])
    T, A, dim = _requests(seed=5)[4]
    fut = victim.submit("sketch_apply", transform=T, A=A, dimension=dim)
    os.kill(victim._proc.pid, signal.SIGKILL)
    try:
        fut.result(timeout=60)
    except engine.ServeOverloadedError:
        pass             # in flight at the kill: failed, never left hanging
    assert _until(lambda: pool.crashed_names() == [victim.name])
    assert victim.name not in pool.names()
    assert victim.unexpected_exit
    assert fleet.shm_entries(pid=os.getpid()) == []
