"""DistSketchCoordinator: fault-tolerant shard-task dispatch (the port of
libskylark_tpu/dist/coordinator.py).

The coordinator turns a :class:`~libskylark_tpu_torch.dist.plan.ShardPlan`
into shard tasks and drives them across replicas, failure handling
first:

- **deterministic placement**: shard ``i`` hashes onto the consistent-hash
  ring at ``(plan fingerprint, i)``; the ring's preference order is the
  failover sequence, so a retry lands on a deterministic next replica
  (``dist.shards_reassigned``);
- **retries are re-executions**: a shard task is idempotent (its partial
  is a function of the plan alone), so a failed attempt is recomputed
  under the ``SKYLARK_DIST_RETRIES`` budget;
- **stragglers are mirrored**: with ``SKYLARK_DIST_HEDGE`` on, a shard
  unresolved past ``SKYLARK_DIST_HEDGE_DELAY_MS`` is dispatched again to
  the next preference replica and the first result wins, safe because
  both compute identical bits;
- **loss is gated, never silent**: shards that exhaust the budget are
  abandoned (``dist.shards_abandoned``) and the merge returns a
  :class:`~libskylark_tpu_torch.dist.plan.DegradedSketchResult` with the
  exact coverage; below the caller's ``min_coverage`` (default
  ``SKYLARK_DIST_MIN_COVERAGE``) the coordinator raises
  :class:`~libskylark_tpu_torch.base.errors.SketchCoverageError`.

Replicas are an explicit list of objects answering ``shard(payload) ->
Future`` and ``state()`` (in-process replicas, or stubs); with none the
coordinator computes every shard locally on its ``device``. The replica
pool of fleet/ comes with a later slice (ROADMAP A7).
"""

from __future__ import annotations

import time
from concurrent.futures import FIRST_COMPLETED, Future, wait
from typing import Dict, List, Optional

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.dist import plan as _plan
from libskylark_tpu_torch.resilience.policy import Deadline
from libskylark_tpu_torch.telemetry import metrics as _metrics

# Instruments declared in telemetry/names.py, created here once; the
# "dist" collector below carries the process-lifetime rollup into every
# snapshot, telemetry on or off.
_DISPATCHED = _metrics.counter(
    "dist.shards_dispatched",
    "Shard-task dispatches (first attempts, retries and hedges)")
_RETRIED = _metrics.counter(
    "dist.shards_retried", "Shard-task re-executions after a failure")
_REASSIGNED = _metrics.counter(
    "dist.shards_reassigned",
    "Shard retries that moved to a different replica")
_ABANDONED = _metrics.counter(
    "dist.shards_abandoned",
    "Shards that exhausted their retry budget (degraded merges)")
_MERGES = _metrics.counter(
    "dist.merges", "Partial-sketch merges performed")
_COVERAGE = _metrics.gauge(
    "dist.coverage", "Coverage fraction of the most recent merge")

_LIFE_LOCK = _locks.make_lock("dist.lifetime")
_LIFE = {"dispatched": 0, "retried": 0, "reassigned": 0,
         "abandoned": 0, "hedged": 0, "merges": 0,
         "last_coverage": None}


def _life(**deltas) -> None:
    with _LIFE_LOCK:
        for k, v in deltas.items():
            if k == "last_coverage":
                _LIFE[k] = v
            else:
                _LIFE[k] += v


def dist_stats() -> dict:
    """Process-lifetime distributed-sketching rollup (the ``dist``
    telemetry collector)."""
    with _LIFE_LOCK:
        return dict(_LIFE)


_metrics.register_collector("dist", dist_stats)


class _Attempt:
    __slots__ = ("index", "future", "replica", "attempt", "t0", "hedge")

    def __init__(self, index, future, replica, attempt, hedge=False):
        self.index = index
        self.future = future
        self.replica = replica
        self.attempt = attempt
        self.t0 = time.monotonic()
        self.hedge = hedge


class DistSketchCoordinator:
    """Dispatch/retry/merge driver over replicas (module doc).

    ``pool`` is a replica pool (live membership: reaped members leave the
    candidate set; fleet/'s ``ReplicaPool`` comes with a later slice);
    ``replicas`` an explicit list of replica objects. With neither,
    every shard computes locally in dispatch order on ``device``
    (default: the package default) —
    :func:`~libskylark_tpu_torch.dist.plan.sketch_local` semantics with
    the same retry accounting.

    ``max_inflight`` bounds concurrently outstanding shard tasks
    (default ``2 ×`` fleet size; memory bound = inflight × partial
    size) — hedge mirrors count against the same bound, so a
    saturated window defers mirroring until a slot frees (and
    ``max_inflight=1`` effectively disables hedging).
    ``max_inflight=1`` serializes dispatch, which makes the sequence of
    ``dist.shard`` firings deterministic.
    """

    def __init__(self, pool=None, *, replicas: Optional[List] = None,
                 retries: Optional[int] = None,
                 min_coverage: Optional[float] = None,
                 hedge: Optional[bool] = None,
                 hedge_delay_s: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 vnodes: int = 64, device=None):
        from libskylark_tpu_torch.fleet.ring import HashRing

        if pool is not None and replicas is not None:
            raise errors.InvalidParametersError(
                "pass a pool OR explicit replicas, not both")
        self._pool = pool
        self.device = device
        self._replicas = ({r.name: r for r in replicas}
                          if replicas else None)
        self._vnodes = int(vnodes)
        self._ring = HashRing(self._names(), vnodes=self._vnodes)
        self.retries = (int(_env.DIST_RETRIES.get())
                        if retries is None else int(retries))
        self.min_coverage = (float(_env.DIST_MIN_COVERAGE.get())
                             if min_coverage is None
                             else float(min_coverage))
        self.hedge = (bool(_env.DIST_HEDGE.get())
                      if hedge is None else bool(hedge))
        self.hedge_delay_s = (
            float(_env.DIST_HEDGE_DELAY_MS.get()) / 1000.0
            if hedge_delay_s is None else float(hedge_delay_s))
        self._max_inflight = max_inflight
        self._lock = _locks.make_lock("dist.coordinator")
        self._stats = {"dispatched": 0, "retried": 0, "reassigned": 0,
                       "abandoned": 0, "hedged": 0, "merges": 0,
                       "last_coverage": None, "by_replica": {}}

    # -- membership -----------------------------------------------------

    def _names(self) -> List[str]:
        if self._pool is not None:
            return list(self._pool.names())
        if self._replicas is not None:
            return list(self._replicas)
        return []

    def _get(self, name: str):
        if self._pool is not None:
            return self._pool.get(name)
        return self._replicas[name]

    def _live_names(self) -> List[str]:
        out = []
        for name in self._names():
            try:
                if self._get(name).state() not in ("STOPPED",
                                                   "DRAINING"):
                    out.append(name)
            except Exception:  # noqa: BLE001 — reaped mid-iteration
                continue
        return out

    def _sync_ring(self) -> List[str]:
        """Fold live membership into the ring (crash-reaped members
        leave; autoscaled arrivals join) and return it."""
        live = self._live_names()
        for name in set(self._ring.members()) - set(live):
            self._ring.remove(name)
        for name in live:
            self._ring.add(name)
        return live

    def _candidates(self, fingerprint: str, index: int,
                    avoid=()) -> List[str]:
        """Deterministic placement/failover order of shard ``index``:
        ring preference at ``(plan fingerprint, index)``, members the
        attempt history says to avoid rotated to the tail."""
        live = self._sync_ring()
        if not live:
            return []
        pref = list(self._ring.preference((fingerprint, index)))
        avoid = [a for a in avoid if a in pref]
        return [n for n in pref if n not in avoid] + list(avoid)

    # -- the storm ------------------------------------------------------

    def sketch(self, plan: _plan.ShardPlan, source: _plan.ShardSource,
               *, min_coverage: Optional[float] = None,
               deadline=None) -> _plan.DistSketchResult:
        """Run the full shard storm and merge.

        Returns a full-coverage :class:`DistSketchResult` (bit-equal
        to :func:`~libskylark_tpu_torch.dist.plan.sketch_local` of the same
        plan+source) or, when shards were abandoned, a
        :class:`DegradedSketchResult` — gated by ``min_coverage``
        (default: the coordinator's, default
        ``SKYLARK_DIST_MIN_COVERAGE``). Logic errors (bad plan/source)
        propagate immediately; everything else is retried/abandoned
        per the budget."""
        plan.validate()
        if source.n < plan.n:
            raise errors.InvalidParametersError(
                f"source holds {source.n} rows < plan.n={plan.n}")
        gate = (self.min_coverage if min_coverage is None
                else float(min_coverage))
        deadline = Deadline.coerce(deadline)
        pending = [i for i, _, _ in plan.shards()]
        tried: Dict[int, List[str]] = {i: [] for i in pending}
        attempts: Dict[int, int] = {i: 0 for i in pending}
        last_ran: Dict[int, str] = {}     # replica of the last ACCEPTED
        #                                   attempt (reassignment truth)
        inflight: Dict[Future, _Attempt] = {}
        settled: Dict[int, dict] = {}
        abandoned: List[int] = []
        hedged: set = set()
        cap = self._max_inflight or max(2, 2 * max(1, len(self._names())))
        # invariant for the whole storm — compute once, not per attempt
        plan_doc = plan.to_dict()
        fingerprint = plan.fingerprint()

        def task_payload(index: int) -> dict:
            lo, hi = plan.shard_range(index)
            return {"plan": plan_doc, "index": index,
                    "source": _plan.source_to_wire(
                        source.subrange(lo, hi))}

        def dispatch(index: int, *, hedge: bool = False,
                     exclude: Optional[str] = None) -> bool:
            """One attempt; False when no replica accepted (counts as
            a failed attempt for the budget). ``exclude`` drops a
            member outright (a hedge mirror must not land on the very
            replica whose slowness triggered it)."""
            cands = self._candidates(fingerprint, index,
                                     avoid=tried[index])
            if exclude is not None:
                cands = [n for n in cands if n != exclude]
            for name in cands:
                try:
                    fut = self._get(name).shard(task_payload(index))
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:  # noqa: BLE001 — a refusal
                    # of ANY class (dead member KeyError, overload,
                    # pipe loss, an unpicklable payload) is one failed
                    # candidate, never an uncaught storm crash; logic
                    # errors still fail fast below
                    if not _retryable(e):
                        raise
                    if name not in tried[index]:
                        tried[index].append(name)
                    continue
                prev = last_ran.get(index)
                last_ran[index] = name
                if name not in tried[index]:
                    tried[index].append(name)
                att = _Attempt(index, fut, name,
                               attempts[index], hedge=hedge)
                inflight[fut] = att
                self._account("dispatched", name)
                if not hedge and attempts[index] > 0:
                    self._account("retried", name)
                    if prev is not None and prev != name:
                        self._account("reassigned", name)
                return True
            if not cands and self._pool is None \
                    and self._replicas is None:
                # no fleet: compute here, now (sketch_local semantics
                # with the same retry/abandon accounting)
                fut: Future = Future()
                att = _Attempt(index, fut, "<local>", attempts[index],
                               hedge=hedge)
                inflight[fut] = att
                self._account("dispatched", "<local>")
                if not hedge and attempts[index] > 0:
                    self._account("retried", "<local>")
                try:
                    fut.set_result(_plan.execute_task(
                        task_payload(index), device=self.device))
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:  # noqa: BLE001
                    fut.set_exception(e)
                return True
            return False

        def note_failure(index: int, exc: Optional[BaseException]
                         ) -> None:
            if exc is not None and not _retryable(exc):
                raise exc
            attempts[index] += 1
            if attempts[index] > self.retries:
                abandoned.append(index)
                self._account("abandoned", None)
            else:
                # the retried attempt is a fresh straggler candidate
                hedged.discard(index)
                pending.append(index)

        # refused-dispatch pacing: when NO replica accepts (a fleet
        # momentarily empty — the last member crashed and its
        # autoscaled replacement is still booting), the budget must
        # not burn in a zero-delay spin; each refusal pass sleeps a
        # growing, bounded delay so a recovering fleet gets its shot
        # before shards are abandoned
        refusal_streak = 0
        while pending or inflight:
            if deadline is not None and deadline.expired:
                # out of budget: whatever is unresolved is abandoned —
                # the degraded accounting (and the gate below) reports
                # it rather than hanging past the caller's deadline
                for fut, att in list(inflight.items()):
                    if att.index not in settled \
                            and att.index not in abandoned:
                        abandoned.append(att.index)
                        self._account("abandoned", None)
                inflight.clear()
                for index in pending:
                    if index not in abandoned:
                        abandoned.append(index)
                        self._account("abandoned", None)
                pending = []
                break
            while pending and len(inflight) < cap:
                index = pending.pop(0)
                if index in settled or index in abandoned:
                    continue
                if dispatch(index):
                    refusal_streak = 0
                else:
                    note_failure(index, None)
                    refusal_streak += 1
                    break           # one refusal ends this fill pass
            if not inflight:
                if pending:
                    if refusal_streak:
                        delay = min(0.05 * refusal_streak, 1.0)
                        if deadline is not None:
                            delay = min(delay,
                                        max(deadline.remaining(), 0.0))
                        time.sleep(delay)
                    continue
                break
            # without hedging or a deadline there is no timer to
            # service — block until something completes instead of
            # waking 20x/s for nothing
            poll = (0.05 if self.hedge or deadline is not None
                    else None)
            done, _ = wait(list(inflight), timeout=poll,
                           return_when=FIRST_COMPLETED)
            now = time.monotonic()
            if self.hedge and not done:
                for fut, att in list(inflight.items()):
                    if len(inflight) >= cap:
                        break       # mirrors honor the inflight bound
                    if (not att.hedge and att.index not in hedged
                            and now - att.t0 >= self.hedge_delay_s):
                        # mark only a mirror that actually launched —
                        # a refused hedge leaves the shard eligible
                        # for mirroring on a later tick. The straggling
                        # primary's own replica is excluded outright:
                        # doubling its load is not straggler protection
                        if dispatch(att.index, hedge=True,
                                    exclude=att.replica):
                            hedged.add(att.index)
                            self._account("hedged", None)
            for fut in done:
                # tolerate a future already purged this round: when a
                # hedge pair completes within one wait window, the
                # first-processed winner pops its twin from inflight
                # and the twin still sits in `done`
                att = inflight.pop(fut, None)
                if att is None:
                    continue
                if att.index in settled or att.index in abandoned:
                    continue            # a hedge twin already decided
                exc = fut.exception()
                if exc is None:
                    settled[att.index] = fut.result()["partial"]
                    # stop waiting on hedge twins of a settled shard:
                    # the loser thread finishes in the background and
                    # its (bit-identical) result is simply dropped
                    for f2 in [f for f, a in inflight.items()
                               if a.index == att.index]:
                        inflight.pop(f2)
                else:
                    # a hedge twin may still be running; only charge
                    # the budget when no other attempt is in flight
                    twins = [a for a in inflight.values()
                             if a.index == att.index]
                    if not twins:
                        note_failure(att.index, exc)

        result = self._merge(plan, settled)
        return result.require(gate)

    def _merge(self, plan, settled) -> _plan.DistSketchResult:
        result = _plan.build_result(plan, settled, self.device)
        _MERGES.inc()
        _COVERAGE.set(result.coverage)
        _life(merges=1, last_coverage=result.coverage)
        with self._lock:
            self._stats["merges"] += 1
            self._stats["last_coverage"] = result.coverage
        return result

    def _account(self, what: str, replica: Optional[str]) -> None:
        metric = {"dispatched": _DISPATCHED, "retried": _RETRIED,
                  "reassigned": _REASSIGNED, "abandoned": _ABANDONED,
                  "hedged": None}[what]
        if metric is not None:
            if replica is not None:
                metric.inc(replica=replica)
            else:
                metric.inc()
        _life(**{what: 1})
        with self._lock:
            self._stats[what] += 1
            if what == "dispatched" and replica is not None:
                by = self._stats["by_replica"]
                by[replica] = by.get(replica, 0) + 1

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["by_replica"] = dict(out["by_replica"])
            return out


def _retryable(exc: BaseException) -> bool:
    """Whether a shard-task failure is worth re-executing: everything
    except plan/source logic errors (which would fail identically on
    every replica forever) and interpreter-exit signals."""
    if isinstance(exc, (errors.InvalidParametersError,
                        errors.UnsupportedError)):
        return False
    return not isinstance(exc, (KeyboardInterrupt, SystemExit))


__all__ = ["DistSketchCoordinator", "dist_stats"]
