"""Pipelined dist-serve jobs: shard fan-out as a serve path (the port of
libskylark_tpu/dist/serve.py).

``submit_dist_sketch`` / ``submit_dist_lstsq`` / ``submit_dist_svd`` on
:class:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor` drive a
:class:`DistServeJob`, which keeps the coordinator's placement, retry,
hedge and accounting semantics but

- **merges incrementally as partials land** (:class:`IncrementalMerger`:
  the canonical pairwise tree evaluated node by node, as soon as both
  children exist), so ingest, shard compute and merging overlap;
- **bills retries and hedges to the owning tenant's token bucket**: the
  admission covers every first attempt, each re-execution or straggler
  mirror charges one more token, and an empty bucket stops further
  attempts (the shard is abandoned into the degraded accounting) rather
  than failing the job;
- **honors per-class ``min_coverage`` gates**: an interactive job may
  resolve early with a quantified
  :class:`~libskylark_tpu_torch.dist.plan.DegradedSketchResult` once its
  coverage reaches the gate and every unresolved shard has failed at
  least once; standard and best-effort jobs run to the end and gate the
  final merge (``SKYLARK_DIST_SERVE_MIN_COVERAGE_*``);
- **parents every shard task's span** under the originating
  ``serve.submit`` request id (``dist.shard_task`` spans) and counts
  dispatch by replica (``dist.shard_tasks``).

Determinism: a full-coverage job returns the bits of
:func:`~libskylark_tpu_torch.dist.plan.sketch_local`: the eager tree adds
exactly the pairs, in exactly the association order, of
:func:`~libskylark_tpu_torch.dist.plan.merge_partials` over the full
shard set. A degraded additive merge takes the canonical one-shot merge
over the surviving partials; ``ust`` placement is exact at any coverage.
``SKYLARK_DIST_SERVE_MERGE_FANIN`` schedules the combines and never
changes bits. Partials, merges and results are tensors on the
coordinator's device.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, wait
from typing import Dict, List, Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.dist import plan as _plan
from libskylark_tpu_torch.dist.coordinator import (_COVERAGE, _MERGES,
                                             DistSketchCoordinator, _life,
                                             _retryable)
from libskylark_tpu_torch.engine import resultcache as _rcache
from libskylark_tpu_torch.qos import tenants as _qtenants
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience.policy import Deadline
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

# Instruments declared in telemetry/names.py, created here once.
# ``dist.shard_tasks`` counts by replica, so placement skew shows;
# ``dist.coverage`` and ``dist.merges`` belong to the coordinator module
# (one creation site per name) and are updated through its instruments.
_SHARD_TASKS = _metrics.counter(
    "dist.shard_tasks",
    "Dist-serve shard-task dispatches, disaggregated by replica")
_MERGE_DEPTH = _metrics.gauge(
    "dist.merge_depth",
    "Tree depth of the most recent incremental dist-serve merge")
_JOBS = _metrics.counter(
    "dist.jobs", "Dist-serve jobs started (all endpoints)")
_EARLY = _metrics.counter(
    "dist.early_resolves",
    "Interactive dist-serve jobs resolved early at their coverage gate")

_SS_LOCK = _locks.make_lock("dist.serve.lifetime")
_SS = {"jobs": 0, "shard_tasks": 0, "early_resolves": 0,
       "retries_billed": 0, "hedges_billed": 0, "quota_stopped": 0,
       "merge_depth_peak": 0, "last_coverage": None,
       "by_replica": {}}


def _ss(**deltas) -> None:
    with _SS_LOCK:
        for k, v in deltas.items():
            if k == "last_coverage":
                _SS[k] = v
            elif k == "merge_depth_peak":
                _SS[k] = max(_SS[k], v)
            elif k == "by_replica":
                by = _SS["by_replica"]
                for name, n in v.items():
                    by[name] = by.get(name, 0) + n
            else:
                _SS[k] += v


def dist_serve_stats() -> dict:
    """Process-lifetime dist-serve rollup (the ``dist_serve`` telemetry
    collector): jobs, shard-task dispatch (with ``by_replica``
    disaggregation), early resolves, retry/hedge billing."""
    with _SS_LOCK:
        out = dict(_SS)
        out["by_replica"] = dict(_SS["by_replica"])
        return out


_metrics.register_collector("dist_serve", dist_serve_stats)


def class_min_coverage(qos_class: Optional[str]) -> float:
    """The per-class default ``min_coverage`` gate
    (``SKYLARK_DIST_SERVE_MIN_COVERAGE_*``). Unknown or custom class
    names gate at 1.0: relaxed coverage is always an explicit opt-in."""
    cls = _qtenants.coerce_class(qos_class)
    var = {
        _qtenants.INTERACTIVE: _env.DIST_SERVE_MIN_COVERAGE_INTERACTIVE,
        _qtenants.STANDARD: _env.DIST_SERVE_MIN_COVERAGE_STANDARD,
        _qtenants.BEST_EFFORT: _env.DIST_SERVE_MIN_COVERAGE_BEST_EFFORT,
    }.get(cls)
    return float(var.get()) if var is not None else 1.0


# ---------------------------------------------------------------------------
# content identity: dist results are pure functions of
# (source digest, plan fingerprint, seed) — digested once, at the
# front door, so the router's single-flight and the owning executor's
# result cache share one key without re-hashing anywhere downstream
# ---------------------------------------------------------------------------


def source_digest_parts(source: _plan.ShardSource) -> list:
    """Digest parts identifying a shard source. In-memory sources are
    content-addressed (the rows ARE the identity); descriptor sources
    are addressed by descriptor — the path names the content on shared
    storage, and re-digesting terabytes through the front door would
    defeat the ship-the-sketch economics (callers who need content
    addressing for mutable files should version the path)."""
    if type(source) is _plan.ArraySource:
        parts = [("source_kind", "array"), ("X", source._X)]
        if source._Y is not None:
            parts.append(("Y", source._Y))
        parts.append(("offset", str(source._off)))
        parts.append(("batch_rows", str(source.batch_rows)))
        return parts
    fields = {"source_kind": type(source).__name__,
              "n": int(source.n), "d": int(source.d),
              "targets": int(source.targets)}
    for k in ("path", "batch_rows"):
        v = getattr(source, k, None)
        if v is not None:
            fields[k] = v
    return [("source", json.dumps(fields, sort_keys=True, default=str))]


def dist_request_digest(endpoint: str, plan: _plan.ShardPlan,
                        source: _plan.ShardSource, extra=()) -> str:
    """The content digest of one dist-serve request. The plan's
    serialized identity pins kind/dims/seed/shard grid; the source
    parts pin the data; ``extra`` carries endpoint statics (e.g. the
    SVD rank) that change the answer without changing the sketch."""
    parts = [("endpoint", str(endpoint)),
             ("plan", json.dumps(plan.to_dict(), sort_keys=True))]
    parts += source_digest_parts(source)
    parts += [(str(k), str(v)) for k, v in extra]
    return _rcache.operand_digest(parts)


# ---------------------------------------------------------------------------
# incremental merge: the canonical tree, evaluated as partials land
# ---------------------------------------------------------------------------


class IncrementalMerger:
    """Eager evaluation of :func:`~libskylark_tpu_torch.dist.plan.
    merge_partials`' canonical pairwise tree.

    The tree over the full shard set has a fixed shape (leaf ``i`` at
    position ``i``; each level pairs adjacent nodes, an odd tail passes
    through), so a node combines as soon as both children exist. The
    leaves and the combine are ``merge_partials``' own, so the
    full-coverage root is bit-equal to the one-shot merge (and to
    ``sketch_local``).

    A degraded additive merge compacts to the surviving shards, a tree
    shape unknown until the abandonments are, so :meth:`result` then
    takes the one-shot merge over the kept partials (sketch-sized; the
    rare path). ``ust`` placement is exact and incremental at any
    coverage.

    ``fanin`` bounds the ready combines folded per :meth:`add` (burst
    control on the driver thread); the rest drain on later adds or at
    :meth:`result`. It never changes the tree, so never the bits. The
    merge runs on the partials' device (``device``, default the package
    default, when none arrived)."""

    def __init__(self, plan: _plan.ShardPlan, fanin: Optional[int] = None,
                 device=None):
        from libskylark_tpu_torch.io.streaming import compute_dtype

        self.plan = plan
        self.device = device
        self.fanin = max(1, int(fanin if fanin is not None
                                else _env.DIST_SERVE_MERGE_FANIN.get()))
        self.partials: Dict[int, dict] = {}
        self.rows = 0
        self.merge_ops = 0
        self.depth = 0
        self._dt = compute_dtype(np.dtype(plan.dtype))
        self._additive = plan.kind in _plan.ADDITIVE_KINDS
        sizes = [plan.num_shards]
        while sizes[-1] > 1:
            sizes.append(-(-sizes[-1] // 2))
        self._sizes = sizes
        if self._additive:
            self._vals: dict = {}          # (level, pos) -> (SX, SY|None)
            self._ready: collections.deque = collections.deque()
        else:
            self._sx = self._sy = None     # made on the first partial's
            #                                device

    @property
    def coverage(self) -> float:
        return self.rows / self.plan.n

    def _place_zeros(self, device) -> None:
        plan = self.plan

        def zeros(width):
            return torch.zeros((plan.s_dim, width), dtype=self._dt,
                               device=device)

        self._sx = zeros(plan.d)
        self._sy = zeros(plan.targets) if plan.targets else None

    def add(self, index: int, partial: dict) -> None:
        index = int(index)
        if index in self.partials:
            return                        # hedge twin: identical bits
        self.partials[index] = partial
        lo, hi = self.plan.shard_range(index)
        self.rows += hi - lo
        if not self._additive:            # ust: disjoint placement
            if self._sx is None:
                self._place_zeros(partial["rows_x"].device)
            idx = partial["out_idx"].to(self._sx.device)
            self._sx[idx] = partial["rows_x"].to(self._sx.device, self._dt)
            if self._sy is not None:
                self._sy[idx] = partial["rows_y"].to(self._sx.device,
                                                     self._dt)
            return
        sx = partial["SX"].to(dtype=self._dt)
        sy = (partial["SY"].to(dtype=self._dt) if self.plan.targets
              else None)
        self._vals[(0, index)] = (sx, sy)
        self._note_ready(0, index)
        self._drain(self.fanin)

    def _note_ready(self, level: int, pos: int) -> None:
        # climb pass-through tails at once (an unpaired node at the end
        # of an odd-length level IS its parent in the canonical tree);
        # queue a real combine once the sibling exists
        while level + 1 < len(self._sizes):
            if pos % 2 == 0 and pos + 1 >= self._sizes[level]:
                self._vals[(level + 1, pos // 2)] = \
                    self._vals.pop((level, pos))
                level, pos = level + 1, pos // 2
                self.depth = max(self.depth, level)
                continue
            if (level, pos ^ 1) in self._vals:
                self._ready.append((level + 1, pos // 2))
            return

    def _drain(self, budget: Optional[int]) -> None:
        while self._ready and (budget is None or budget > 0):
            level, pos = self._ready.popleft()
            left = self._vals.pop((level - 1, 2 * pos), None)
            right = self._vals.pop((level - 1, 2 * pos + 1), None)
            if left is None or right is None:   # already folded upward
                continue
            sx = left[0] + right[0]
            sy = (left[1] + right[1] if left[1] is not None else None)
            self._vals[(level, pos)] = (sx, sy)
            self.merge_ops += 1
            self.depth = max(self.depth, level)
            if budget is not None:
                budget -= 1
            self._note_ready(level, pos)

    def result(self) -> _plan.DistSketchResult:
        """The merged result over every partial added so far, with the
        exact coverage accounting of :func:`~libskylark_tpu_torch.dist.
        plan.build_result`."""
        from libskylark_tpu_torch.base.device import resolve_device

        plan = self.plan
        full = len(self.partials) == plan.num_shards
        if self._additive and not full:
            # the canonical fallback (it fires the dist.merge site
            # itself): the survivors' tree shape exists only now
            merged = _plan.merge_partials(plan, self.partials,
                                          self.device)
        else:
            faults.check(
                "dist.merge",
                detail=f"{plan.kind}:{len(self.partials)} partials")
            if self._additive:
                self._drain(None)
                root = self._vals[(len(self._sizes) - 1, 0)]
                merged = {"SX": root[0]}
                if plan.targets:
                    merged["SY"] = root[1]
            else:
                if self._sx is None:
                    self._place_zeros(resolve_device(self.device))
                merged = {"SX": self._sx}
                if self._sy is not None:
                    merged["SY"] = self._sy
        missing = _plan.missing_ranges(plan, self.partials.keys())
        cls = (_plan.DistSketchResult if self.rows == plan.n
               else _plan.DegradedSketchResult)
        return cls(kind=plan.kind, SX=merged["SX"], SY=merged.get("SY"),
                   rows_merged=self.rows, coverage=self.rows / plan.n,
                   missing=missing, shards=plan.num_shards,
                   shards_merged=len(self.partials))


# ---------------------------------------------------------------------------
# the pipelined job
# ---------------------------------------------------------------------------


class _JobAttempt:
    __slots__ = ("index", "future", "replica", "attempt", "t0", "hedge",
                 "span_cm", "span")

    def __init__(self, index, future, replica, attempt, hedge=False):
        self.index = index
        self.future = future
        self.replica = replica
        self.attempt = attempt
        self.t0 = time.monotonic()
        self.hedge = hedge
        self.span_cm = None
        self.span = None


class DistServeJob:
    """One pipelined dist-serve job: the coordinator's dispatch loop with
    incremental merging, per-class coverage gates, early resolve and
    tenant-billed retries and hedges (module doc). Placement, failover
    order, retry budget and hedging come from ``coordinator`` (shared
    across jobs, so its accounting sums their shard traffic); a
    coordinator with no replicas computes shards on a private thread
    pool on its device, so ingest, compute and merge still overlap on
    one host.

    Run :meth:`run` on a worker thread (the executor/router endpoints
    do) — it blocks until the job resolves."""

    def __init__(self, plan: _plan.ShardPlan, source: _plan.ShardSource,
                 *, coordinator: Optional[DistSketchCoordinator] = None,
                 qos_class: Optional[str] = None, tenant: str = "",
                 registry=None, min_coverage: Optional[float] = None,
                 deadline=None, pipeline: Optional[int] = None,
                 fanin: Optional[int] = None,
                 request_id: Optional[str] = None, parent_ctx=None):
        plan.validate()
        if source.n < plan.n:
            raise errors.InvalidParametersError(
                f"source holds {source.n} rows < plan.n={plan.n}")
        self.plan = plan
        self.source = source
        self.co = coordinator if coordinator is not None \
            else DistSketchCoordinator()
        self.qos_class = _qtenants.coerce_class(qos_class)
        self.tenant = str(tenant) if tenant else ""
        self.registry = registry
        self.gate = (class_min_coverage(self.qos_class)
                     if min_coverage is None else float(min_coverage))
        self.deadline = Deadline.coerce(deadline)
        depth = int(pipeline if pipeline is not None
                    else _env.DIST_SERVE_PIPELINE.get())
        self.cap = depth if depth > 0 else (
            self.co._max_inflight
            or max(2, 2 * max(1, len(self.co._names()))))
        self.fanin = fanin
        self.rid = request_id
        self.parent = parent_ctx
        # interactive is the only class whose latency SLO buys early
        # resolution; a gate of 1.0 makes "early" meaningless anyway
        self._early_ok = (self.qos_class == _qtenants.INTERACTIVE
                          and self.gate < 1.0)
        self._tpe = None
        self.stats = {"shard_tasks": 0, "retries_billed": 0,
                      "hedges_billed": 0, "quota_stopped": 0,
                      "early_resolved": False, "merge_depth": 0,
                      "merge_ops": 0, "coverage": None,
                      "by_replica": {}}

    # -- billing --------------------------------------------------------

    def _bill(self, what: str) -> bool:
        """Charge one token for a retry/hedge attempt. ``True`` =
        proceed; ``False`` = the tenant's bucket is empty — the extra
        attempt is refused (never raises: quota exhaustion degrades
        the job, it does not crash it)."""
        if self.registry is None or not self.tenant:
            return True
        try:
            self.registry.admit(self.tenant)
        except errors.TenantQuotaError:
            self.stats["quota_stopped"] += 1
            _ss(quota_stopped=1)
            return False
        key = "retries_billed" if what == "retry" else "hedges_billed"
        self.stats[key] += 1
        _ss(**{key: 1})
        return True

    # -- span plumbing --------------------------------------------------

    def _open_span(self, att: _JobAttempt) -> None:
        if self.rid is None and self.parent is None:
            return
        cm = _trace.span(
            "dist.shard_task",
            attrs={"index": att.index, "replica": att.replica,
                   "attempt": att.attempt, "hedge": att.hedge},
            parent=self.parent, request_id=self.rid)
        att.span_cm = cm
        try:
            att.span = cm.__enter__()
        except Exception:      # noqa: BLE001 — tracing must not kill jobs
            att.span_cm = None

    def _close_span(self, att: _JobAttempt, outcome: str,
                    error=None) -> None:
        if att.span_cm is None:
            return
        if att.span is not None:
            att.span.set_attr("outcome", outcome)
            if error is not None:
                att.span.set_attr("error", repr(error))
        try:
            att.span_cm.__exit__(None, None, None)
        except Exception:      # noqa: BLE001
            pass
        att.span_cm = None

    # -- the pipelined storm --------------------------------------------

    def run(self) -> _plan.DistSketchResult:
        plan, source, co = self.plan, self.source, self.co
        merger = IncrementalMerger(plan, self.fanin, device=co.device)
        pending = [i for i, _, _ in plan.shards()]
        tried: Dict[int, List[str]] = {i: [] for i in pending}
        attempts: Dict[int, int] = {i: 0 for i in pending}
        last_ran: Dict[int, str] = {}
        inflight: Dict[Future, _JobAttempt] = {}
        abandoned: List[int] = []
        hedged: set = set()
        plan_doc = plan.to_dict()
        fingerprint = plan.fingerprint()
        deadline = self.deadline
        _JOBS.inc()
        _ss(jobs=1)

        def task_payload(index: int) -> dict:
            lo, hi = plan.shard_range(index)
            return {"plan": plan_doc, "index": index,
                    "source": _plan.source_to_wire(
                        source.subrange(lo, hi))}

        def record(index: int, fut, name: str, hedge: bool) -> None:
            prev = last_ran.get(index)
            last_ran[index] = name
            if name not in tried[index]:
                tried[index].append(name)
            att = _JobAttempt(index, fut, name, attempts[index],
                              hedge=hedge)
            self._open_span(att)
            inflight[fut] = att
            co._account("dispatched", name)
            _SHARD_TASKS.inc(replica=name)
            _ss(shard_tasks=1, by_replica={name: 1})
            self.stats["shard_tasks"] += 1
            by = self.stats["by_replica"]
            by[name] = by.get(name, 0) + 1
            if not hedge and attempts[index] > 0:
                co._account("retried", name)
                if prev is not None and prev != name:
                    co._account("reassigned", name)

        def dispatch(index: int, *, hedge: bool = False,
                     exclude: Optional[str] = None) -> bool:
            with co._lock:        # jobs share the coordinator's ring
                cands = co._candidates(fingerprint, index,
                                       avoid=tried[index])
            if exclude is not None:
                cands = [n for n in cands if n != exclude]
            for name in cands:
                try:
                    fut = co._get(name).shard(task_payload(index))
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:  # noqa: BLE001 — a refusal
                    if not _retryable(e):
                        raise
                    if name not in tried[index]:
                        tried[index].append(name)
                    continue
                record(index, fut, name, hedge)
                return True
            if not cands and co._pool is None and co._replicas is None:
                # no fleet: shard compute runs on the job's own pool —
                # pipelined even on one host (ingest overlaps folds)
                if self._tpe is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._tpe = ThreadPoolExecutor(
                        max_workers=max(1, min(self.cap, 8)),
                        thread_name_prefix="skylark-dist-serve")
                fut = self._tpe.submit(_plan.execute_task,
                                       task_payload(index), co.device)
                record(index, fut, "<local>", hedge)
                return True
            return False

        def note_failure(index: int, exc: Optional[BaseException],
                         bill: bool = True) -> None:
            if exc is not None and not _retryable(exc):
                raise exc
            attempts[index] += 1
            if attempts[index] > co.retries or (
                    bill and not self._bill("retry")):
                if index not in abandoned:
                    abandoned.append(index)
                    co._account("abandoned", None)
            else:
                hedged.discard(index)
                pending.append(index)

        refusal_streak = 0
        try:
            while pending or inflight:
                if deadline is not None and deadline.expired:
                    for fut, att in list(inflight.items()):
                        self._close_span(att, "deadline")
                        if att.index not in merger.partials \
                                and att.index not in abandoned:
                            abandoned.append(att.index)
                            co._account("abandoned", None)
                    inflight.clear()
                    for index in pending:
                        if index not in abandoned:
                            abandoned.append(index)
                            co._account("abandoned", None)
                    pending = []
                    break
                while pending and len(inflight) < self.cap:
                    index = pending.pop(0)
                    if index in merger.partials or index in abandoned:
                        continue
                    if dispatch(index):
                        refusal_streak = 0
                    else:
                        # a refusal burns budget but bills nothing —
                        # no replica executed anything
                        note_failure(index, None, bill=False)
                        refusal_streak += 1
                        break
                if not inflight:
                    if pending:
                        if refusal_streak:
                            delay = min(0.05 * refusal_streak, 1.0)
                            if deadline is not None:
                                delay = min(delay, max(
                                    deadline.remaining(), 0.0))
                            time.sleep(delay)
                        continue
                    break
                poll = (0.05 if co.hedge or deadline is not None
                        else None)
                done, _ = wait(list(inflight), timeout=poll,
                               return_when=FIRST_COMPLETED)
                now = time.monotonic()
                if co.hedge and not done:
                    for fut, att in list(inflight.items()):
                        if len(inflight) >= self.cap:
                            break
                        if (not att.hedge and att.index not in hedged
                                and now - att.t0 >= co.hedge_delay_s):
                            # mirrors are extra capacity: billed before
                            # launch, and an empty bucket simply skips
                            # this tick (the shard stays eligible)
                            if not self._bill("hedge"):
                                continue
                            if dispatch(att.index, hedge=True,
                                        exclude=att.replica):
                                hedged.add(att.index)
                                co._account("hedged", None)
                for fut in done:
                    att = inflight.pop(fut, None)
                    if att is None:
                        continue
                    if att.index in merger.partials \
                            or att.index in abandoned:
                        self._close_span(att, "dropped")
                        continue
                    exc = fut.exception()
                    if exc is None:
                        self._close_span(att, "settled")
                        merger.add(att.index, _plan.partial_on(
                            fut.result()["partial"], co.device))
                        for f2 in [f for f, a in inflight.items()
                                   if a.index == att.index]:
                            self._close_span(inflight.pop(f2), "dropped")
                    else:
                        self._close_span(att, "failed", error=exc)
                        twins = [a for a in inflight.values()
                                 if a.index == att.index]
                        if not twins:
                            note_failure(att.index, exc)
                if self._early_ok and merger.rows >= self.gate * plan.n:
                    unsettled = [i for i in attempts
                                 if i not in merger.partials
                                 and i not in abandoned]
                    if unsettled and all(attempts[i] >= 1
                                         for i in unsettled):
                        # coverage met, every holdout already failed
                        # once: resolve now — the missing ranges ride
                        # the DegradedSketchResult, quantified
                        for i in unsettled:
                            abandoned.append(i)
                            co._account("abandoned", None)
                        for f2, a2 in list(inflight.items()):
                            self._close_span(a2, "early_resolve")
                        inflight.clear()
                        pending = []
                        self.stats["early_resolved"] = True
                        _EARLY.inc()
                        _ss(early_resolves=1)
                        break
        finally:
            for att in inflight.values():
                self._close_span(att, "aborted")
            if self._tpe is not None:
                self._tpe.shutdown(wait=False)
        result = merger.result()
        _MERGES.inc()
        _COVERAGE.set(result.coverage)
        _life(merges=1, last_coverage=result.coverage)
        with co._lock:
            co._stats["merges"] += 1
            co._stats["last_coverage"] = result.coverage
        _MERGE_DEPTH.set(merger.depth)
        _ss(merge_depth_peak=merger.depth,
            last_coverage=result.coverage)
        self.stats["merge_depth"] = merger.depth
        self.stats["merge_ops"] = merger.merge_ops
        self.stats["coverage"] = result.coverage
        return result.require(self.gate)


def run_job_into(job: DistServeJob, fut: Future, *, solve=None,
                 on_done=None) -> threading.Thread:
    """Run ``job`` on a daemon thread, resolving ``fut`` with its
    result (through ``solve`` when given — the local lstsq/SVD factor
    step of the dist algorithms). ``on_done(job, fut)`` runs after the
    future settles, before any caller-visible callback fires."""
    def _run():
        try:
            res = job.run()
            value = solve(res) if solve is not None else res
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — resolve, don't leak
            if on_done is not None:
                try:
                    on_done(job, e)
                except Exception:  # noqa: BLE001
                    pass
            fut.set_exception(e)
            return
        if on_done is not None:
            try:
                on_done(job, None)
            except Exception:  # noqa: BLE001
                pass
        fut.set_result(value)

    t = threading.Thread(target=_run, name="skylark-dist-serve-job",
                         daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# local factor steps (shared with dist/algorithms.py)
# ---------------------------------------------------------------------------


def solve_lstsq(result: _plan.DistSketchResult) -> dict:
    """``min_w ||X w - Y||`` from the merged joint sketch (the
    ``sketched_lstsq`` factor step), at the solver precision, on the
    sketch's device."""
    from libskylark_tpu_torch.base.precision import solver_precision

    with solver_precision():
        w = torch.linalg.lstsq(result.SX, result.SY).solution
    return {"coef": w, "coverage": result.coverage,
            "missing": list(result.missing),
            "degraded": result.degraded}


def solve_svd(result: _plan.DistSketchResult, rank: int) -> dict:
    """Top-``rank`` factorization of the merged row sketch (the
    ``randomized_svd`` factor step), on the sketch's device."""
    _, sv, Vt = torch.linalg.svd(result.SX, full_matrices=False)
    k = min(int(rank), int(result.SX.shape[0]), int(result.SX.shape[1]))
    return {"singular_values": sv[:k], "Vt": Vt[:k],
            "coverage": result.coverage, "missing": list(result.missing),
            "degraded": result.degraded}


__all__ = [
    "DistServeJob", "IncrementalMerger", "class_min_coverage",
    "dist_request_digest", "dist_serve_stats", "run_job_into",
    "solve_lstsq", "solve_svd", "source_digest_parts",
]
