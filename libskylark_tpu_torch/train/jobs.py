"""Training jobs: preemptible, crash-survivable solver runs inside the
serve tier (the port of libskylark_tpu/train/jobs.py).

The manager joins three parts of the system:

- **durability**: a job is a session of kind ``"train"``
  (:mod:`libskylark_tpu_torch.train.state`): every slice is journaled
  before it is acknowledged, the state is checkpointed on a cadence, and
  the lease generation fences a stale owner, so a killed process loses
  nothing past the last acknowledged slice and a peer resumes bit-equal;
- **scheduling**: slices are best-effort work. The executor's flusher
  offers the :class:`~libskylark_tpu_torch.qos.scheduler.DeficitScheduler`
  a train entry only when no higher class has pending work, so training
  fills idle slots and gives way at slice boundaries, never mid-step;
- **reporting**: per-job progress and residual gauges, the job counters
  in ``stats()["train"]`` and the ``train`` telemetry collector, and a
  terminal :class:`~libskylark_tpu_torch.base.errors.
  TrainBudgetExhaustedError` carrying the exact iterations completed.

Threading: the flusher calls :meth:`TrainManager.has_runnable`,
:meth:`~TrainManager.claim_next` and :meth:`~TrainManager.note_deferred`
under the serve lock (lock order ``serve.state → train.manager``);
:meth:`~TrainManager.run_slice` runs on a dispatch worker with no serve
lock held and takes the manager lock only for queue bookkeeping, never
across the solver step or a session verb, so ``train.manager`` sits
above the ``sessions.*`` locks in the order graph.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import uuid
import weakref
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.ml.coding import host_array
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.train import slices as _slices
from libskylark_tpu_torch.train import state as _tstate

_JOBS = _metrics.counter(
    "train.jobs_submitted", "Training jobs submitted to the serve tier")
_SLICES = _metrics.counter(
    "train.slices_run", "Training slices executed (journaled and "
    "acked)")
_PREEMPTIONS = _metrics.counter(
    "train.preemptions", "Training slices displaced at a slice "
    "boundary by higher-class pressure (one per deferral episode)")
_RESUMES = _metrics.counter(
    "train.resumes", "Training jobs resumed from disk on a surviving "
    "replica (drain handoff or crash replay)")
_BUDGET = _metrics.counter(
    "train.budget_exhausted", "Training jobs terminated by iteration "
    "budget or wall-clock deadline before convergence")
_PROGRESS = _metrics.gauge(
    "train.progress", "Per-job training progress: solver iterations "
    "completed over the iteration budget, in [0, 1]")
_RESIDUAL = _metrics.gauge(
    "train.residual", "Per-job most recent convergence signal "
    "(solver-specific residual)")


@dataclasses.dataclass(frozen=True)
class TrainJobSpec:
    """Everything a replica needs to run — or resume — a training job.

    ``solver`` names a slice engine (:data:`libskylark_tpu_torch.train.
    slices.SOLVERS`); ``hyper`` its hyperparameters (including the
    seed every transform derives from). Budgets speak the QoS
    vocabulary: ``budget_iters`` is the iteration budget (the
    session's declared extent — slices past it refuse),
    ``deadline_s`` the wall-clock budget measured from
    ``submitted_at`` (stamped at submit, so a resume on another
    replica enforces the ORIGINAL deadline, not a fresh one). ``None``
    knobs fall back to their ``SKYLARK_TRAIN_*`` defaults at use."""

    solver: str
    hyper: dict = dataclasses.field(default_factory=dict)
    budget_iters: int = 256
    slice_iters: Optional[int] = None
    deadline_s: Optional[float] = None
    retry_budget: Optional[int] = None
    checkpoint_every: Optional[int] = None
    tenant: str = ""
    ttl_s: Optional[float] = None
    submitted_at: Optional[float] = None
    operand_digests: dict = dataclasses.field(default_factory=dict)

    def validate(self) -> "TrainJobSpec":
        if self.solver not in _slices.SOLVERS:
            raise errors.InvalidParametersError(
                f"unknown train solver {self.solver!r}; expected one "
                f"of {_slices.SOLVERS}")
        if self.budget_iters < 1:
            raise errors.InvalidParametersError(
                f"budget_iters must be positive, got "
                f"{self.budget_iters}")
        if self.slice_iters is not None and self.slice_iters < 1:
            raise errors.InvalidParametersError(
                f"slice_iters must be positive, got {self.slice_iters}")
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainJobSpec":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)
                      if f.name in d}).validate()

    # effective knobs (env-defaulted)

    @property
    def eff_slice_iters(self) -> int:
        return int(self.slice_iters
                   if self.slice_iters is not None
                   else _env.TRAIN_SLICE_ITERS.get())

    @property
    def eff_deadline_s(self) -> float:
        return float(self.deadline_s
                     if self.deadline_s is not None
                     else _env.TRAIN_DEADLINE_S.get())

    @property
    def eff_retry_budget(self) -> int:
        return int(self.retry_budget
                   if self.retry_budget is not None
                   else _env.TRAIN_RETRY_BUDGET.get())

    @property
    def eff_checkpoint_every(self) -> int:
        return int(self.checkpoint_every
                   if self.checkpoint_every is not None
                   else _env.TRAIN_CKPT_EVERY.get())


class TrainJobHandle:
    """What ``submit_train_job`` returns: the job/session id plus a
    future resolving to the trained model dict (``iterations``,
    ``residual``, ``converged`` included) or the terminal error."""

    __slots__ = ("job_id", "session_id", "future")

    def __init__(self, job_id: str, future: Future):
        self.job_id = job_id
        self.session_id = job_id
        self.future = future

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)


class _Job:
    """Mutable runtime record of one job on THIS replica. Queue/state
    transitions happen under the manager lock; slice-local fields
    (``slices_done``, ``rows``, ``residual``) are touched only by the
    single in-flight slice runner (at most one slice of a job runs at
    a time, by construction)."""

    __slots__ = ("sid", "spec", "future", "slices_done", "rows",
                 "retries_left", "running", "queued", "done",
                 "deferred", "tags", "residual", "resumed")

    def __init__(self, sid: str, spec: TrainJobSpec,
                 slices_done: int = 0, rows: int = 0,
                 resumed: bool = False):
        self.sid = sid
        self.spec = spec
        self.future: Future = Future()
        self.slices_done = int(slices_done)
        self.rows = int(rows)
        self.retries_left = spec.eff_retry_budget
        self.running = False
        self.queued = False
        self.done = False
        self.deferred = False
        self.tags = faults.current_tags()
        self.residual: Optional[float] = None
        self.resumed = bool(resumed)

    @property
    def deadline_exceeded(self) -> bool:
        t0 = self.spec.submitted_at
        return (t0 is not None
                and time.time() - float(t0) > self.spec.eff_deadline_s)


class TrainManager:
    """Per-executor training job manager (built lazily by
    :attr:`MicrobatchExecutor.train_jobs`)."""

    def __init__(self, executor):
        self._ex = weakref.proxy(executor)
        self._lock = _locks.make_lock("train.manager")
        self._jobs: Dict[str, _Job] = {}
        self._queue: "collections.deque[_Job]" = collections.deque()
        self._counts = {"jobs_submitted": 0, "slices_run": 0,
                        "preemptions": 0, "resumes": 0,
                        "budget_exhausted": 0, "completed": 0,
                        "failed": 0, "retries": 0}
        _MANAGERS.add(self)

    # -- submission ------------------------------------------------------

    def _resolve_operands(self, operands: dict) -> tuple:
        """Host arrays of the operands: a residency reference
        (``OperandRef``) takes the executor's resident operand, an array
        or a tensor passes through. Returns ``(arrays, digests)``; the
        digests ride the spec as the job's operand identity."""
        from libskylark_tpu_torch.engine import resultcache as _rcache
        from libskylark_tpu_torch.utility.checkpoint import sample_digest

        arrays, digests = {}, {}
        for name, val in (operands or {}).items():
            if _rcache.is_ref(val):
                ref = _rcache.as_ref(val)
                val = self._ex._residency.host(ref.digest)
                digests[name] = str(ref.digest)
            arr = host_array(val)
            digests.setdefault(name, sample_digest(arr))
            arrays[name] = arr
        return arrays, digests

    def submit(self, spec, operands: Optional[dict] = None,
               session_id: Optional[str] = None) -> TrainJobHandle:
        """Open the job's session (operands persisted durably FIRST,
        then the session with the spec in ``extra``), pin it against
        TTL eviction for the job's lifetime, and enqueue the first
        slice. Returns immediately; the handle's future resolves when
        the job converges, exhausts its budget, or fails terminally."""
        from libskylark_tpu_torch.sessions.state import SessionSpec

        if isinstance(spec, dict):
            spec = TrainJobSpec.from_dict(spec)
        spec.validate()
        sid = str(session_id) if session_id \
            else f"train-{uuid.uuid4().hex[:12]}"
        arrays, digests = self._resolve_operands(operands)
        if not arrays:
            raise errors.InvalidParametersError(
                "train jobs need operands (solver inputs)")
        spec = dataclasses.replace(
            spec,
            submitted_at=(spec.submitted_at
                          if spec.submitted_at is not None
                          else time.time()),
            operand_digests=digests)
        reg = self._ex.sessions
        _tstate.save_operands(reg.directory, sid, arrays, digests)
        sspec = SessionSpec(kind="train", n=int(spec.budget_iters),
                            s_dim=1, d=1,
                            seed=int(spec.hyper.get("seed", 0)),
                            ttl_s=spec.ttl_s, extra=spec.to_dict())
        try:
            reg.open(sspec, session_id=sid)
        except BaseException:
            _tstate.remove_operands(reg.directory, sid)
            raise
        reg.pin(sid)
        job = _Job(sid, spec)
        with self._lock:
            self._jobs[sid] = job
            self._enqueue_locked(job)
            self._counts["jobs_submitted"] += 1
        _JOBS.inc(solver=spec.solver)
        self._ex._wake_flusher()
        return TrainJobHandle(sid, job.future)

    def resume(self, session_id: str) -> TrainJobHandle:
        """Adopt a job from its on-disk session (drain handoff or
        crash replay): the registry resume rebuilds the solver state
        bit-equal from checkpoint + journal tail; the job continues
        from its last acked slice under its ORIGINAL deadline. A job
        already live on this manager returns its existing handle (the
        router's failover may race a redundant resume)."""
        sid = str(session_id)
        with self._lock:
            existing = self._jobs.get(sid)
            if existing is not None and not existing.done:
                return TrainJobHandle(sid, existing.future)
        reg = self._ex.sessions
        desc = reg.describe(sid)            # triggers the disk resume
        extra = (desc.get("spec") or {}).get("extra")
        if not extra:
            raise errors.InvalidParametersError(
                f"session {sid!r} is not a train session")
        spec = TrainJobSpec.from_dict(extra)
        reg.pin(sid)
        job = _Job(sid, spec, slices_done=int(desc.get("seq", 0)),
                   rows=int(desc.get("rows", 0)), resumed=True)
        info = desc.get("info") or {}
        job.residual = info.get("residual")
        with self._lock:
            raced = self._jobs.get(sid)
            if raced is not None and not raced.done:
                reg.unpin(sid)
                return TrainJobHandle(sid, raced.future)
            self._jobs[sid] = job
            self._enqueue_locked(job)
            self._counts["resumes"] += 1
        _RESUMES.inc()
        self._ex._wake_flusher()
        return TrainJobHandle(sid, job.future)

    def status(self, session_id: str) -> dict:
        """Progress snapshot of a job known to this manager."""
        sid = str(session_id)
        with self._lock:
            job = self._jobs.get(sid)
            if job is None:
                raise errors.SessionEvictedError(
                    f"train job {sid!r} is not live on this replica")
            return {
                "job_id": sid,
                "solver": job.spec.solver,
                "slices_done": job.slices_done,
                "iterations_requested": job.rows,
                "budget_iters": job.spec.budget_iters,
                "residual": job.residual,
                "queued": job.queued,
                "running": job.running,
                "done": job.done,
                "retries_left": job.retries_left,
            }

    # -- scheduling hooks (called by the flusher under the serve lock) --

    def _enqueue_locked(self, job: _Job) -> None:
        if not job.queued and not job.done:
            job.queued = True
            self._queue.append(job)

    def has_runnable(self) -> bool:
        with self._lock:
            return bool(self._queue)

    def claim_next(self) -> Optional[_Job]:
        """Pop the next runnable job and mark its slice in flight."""
        with self._lock:
            while self._queue:
                job = self._queue.popleft()
                job.queued = False
                if job.done:
                    continue
                job.running = True
                job.deferred = False
                return job
        return None

    def note_deferred(self) -> None:
        """Runnable training work yielded its slot to higher-class
        pressure — the preemption counter's boundary event. Counted
        once per deferral EPISODE (per queued job), not once per
        flusher pass, so a long interactive storm reads as one
        preemption per displaced job rather than thousands."""
        n = 0
        with self._lock:
            for job in self._queue:
                if not job.deferred:
                    job.deferred = True
                    n += 1
            if n:
                self._counts["preemptions"] += n
        if n:
            _PREEMPTIONS.inc(n)

    # -- slice execution (dispatch worker; NO serve lock held) -----------

    def run_slice(self, job: _Job) -> None:
        """Execute one slice of ``job``: fault seam → journaled append
        (the fold runs the solver) → gauges → cadence checkpoint →
        terminal/requeue decision. Every error path resolves the job
        future or requeues — a slice never leaves the job wedged."""
        reg = self._ex.sessions
        sid = job.sid
        try:
            if job.deadline_exceeded:
                self._exhaust(job, reason=(
                    f"wall-clock deadline "
                    f"{job.spec.eff_deadline_s:.6g}s exceeded"))
                return
            k = min(job.spec.eff_slice_iters,
                    job.spec.budget_iters - job.rows)
            if k <= 0:
                self._exhaust(job, reason=(
                    f"iteration budget {job.spec.budget_iters} "
                    "exhausted before convergence"))
                return
            target = job.slices_done + 1
            # the crash seam fires before the append: a ``crash`` spec
            # kills the process with the slice not yet durable, so the
            # resume replays exactly the acknowledged prefix
            faults.check("train.slice", tags=job.tags,
                         detail=f"{sid}#{target}")
            seq, rows = reg.append(
                sid, np.asarray([[k]], dtype=np.int64), seq=target,
                tags=job.tags)
            job.slices_done, job.rows = int(seq), int(rows)
            with self._lock:
                self._counts["slices_run"] += 1
            _SLICES.inc(solver=job.spec.solver)
            desc = reg.describe(sid)
            info = desc.get("info") or {}
            job.residual = info.get("residual")
            _PROGRESS.set(
                min(1.0, job.rows / max(1, job.spec.budget_iters)),
                job=sid)
            if job.residual is not None:
                _RESIDUAL.set(float(job.residual), job=sid)
            if job.slices_done % job.spec.eff_checkpoint_every == 0:
                reg.checkpoint(sid)
            if info.get("converged"):
                result = reg.finalize(sid)
                self._finish(job, result=result)
            elif job.rows >= job.spec.budget_iters:
                self._exhaust(job, reason=(
                    f"iteration budget {job.spec.budget_iters} "
                    "exhausted before convergence"))
            else:
                self._requeue(job)
        except errors.SessionEvictedError as e:
            # fenced (a peer adopted the job) or evicted: terminal
            # HERE — retrying would ping-pong the lease with the new
            # owner. The future only errors if no peer will resolve
            # it (the router resolves the client future through
            # whichever replica finishes the job).
            self._finish(job, error=e)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — contain, retry
            self._retry_or_fail(job, e)

    # -- terminal transitions -------------------------------------------

    def _settle(self, job: _Job) -> None:
        with self._lock:
            job.running = False
            job.queued = False
            job.done = True

    def _finish(self, job: _Job, result=None, error=None) -> None:
        self._settle(job)
        self._ex.sessions.unpin(job.sid)
        with self._lock:
            self._jobs.pop(job.sid, None)
            if error is None:
                self._counts["completed"] += 1
            else:
                self._counts["failed"] += 1
        if not job.future.done():
            if error is None:
                job.future.set_result(result)
            else:
                job.future.set_exception(error)

    def _exhaust(self, job: _Job, reason: str) -> None:
        """Terminal budget/deadline exhaustion: checkpoint what we
        have (the caller may resubmit with a larger budget against a
        fresh id), evict the session, and report EXACT progress —
        never a silent failure."""
        reg = self._ex.sessions
        iterations = job.rows
        residual = job.residual
        try:
            desc = reg.describe(job.sid)
            info = desc.get("info") or {}
            iterations = int(info.get("iterations", iterations))
            residual = info.get("residual", residual)
        except errors.SkylarkError:
            pass
        err = errors.TrainBudgetExhaustedError(
            f"train job {job.sid!r} ({job.spec.solver}): {reason}; "
            f"{iterations} iterations over {job.slices_done} slices "
            f"completed, last residual {residual}",
            iterations=iterations, residual=residual,
            slices=job.slices_done)
        with self._lock:
            self._counts["budget_exhausted"] += 1
        _BUDGET.inc(solver=job.spec.solver)
        try:
            reg.evict(job.sid, reason="train_budget")
        except errors.SkylarkError:
            pass
        self._finish(job, error=err)

    def _retry_or_fail(self, job: _Job, exc: BaseException) -> None:
        job.retries_left -= 1
        if job.retries_left >= 0:
            with self._lock:
                self._counts["retries"] += 1
            self._requeue(job)
            return
        try:
            self._ex.sessions.evict(job.sid, reason="train_failed")
        except errors.SkylarkError:
            pass
        self._finish(job, error=exc)

    def _requeue(self, job: _Job) -> None:
        with self._lock:
            job.running = False
            self._enqueue_locked(job)
        self._ex._wake_flusher()

    def release_jobs(self, message: str) -> None:
        """Stop owning every live job WITHOUT deciding its outcome —
        the drain/shutdown path. The sessions stay on disk (the drain
        hook already checkpointed them) and the pins release; each
        unresolved job future breaks with
        :class:`~libskylark_tpu_torch.base.errors.CommunicationError`, the
        signal a fleet router's resume chain treats as "re-home the
        job on a surviving replica"."""
        with self._lock:
            jobs = list(self._jobs.values())
            self._queue.clear()
            self._jobs.clear()
            for j in jobs:
                j.queued = False
                j.done = True
        for j in jobs:
            try:
                self._ex.sessions.unpin(j.sid)
            except Exception:  # noqa: BLE001 — teardown must finish
                pass
            if not j.future.done():
                j.future.set_exception(
                    errors.CommunicationError(
                        f"train job {j.sid!r}: {message}"))

    # -- stats -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["active"] = len(self._jobs)
            out["queued"] = len(self._queue)
            out["by_job"] = {
                sid: {"solver": j.spec.solver,
                      "slices_done": j.slices_done,
                      "iterations_requested": j.rows,
                      "budget_iters": j.spec.budget_iters,
                      "residual": j.residual,
                      "running": j.running,
                      "queued": j.queued}
                for sid, j in self._jobs.items()}
        return out


_MANAGERS: "weakref.WeakSet[TrainManager]" = weakref.WeakSet()

_SUM_KEYS = ("jobs_submitted", "slices_run", "preemptions", "resumes",
             "budget_exhausted", "completed", "failed", "retries",
             "active", "queued")


def train_stats() -> dict:
    """Aggregate train counters over every live manager (the ``train``
    telemetry collector block)."""
    agg = {"managers": 0}
    for k in _SUM_KEYS:
        agg[k] = 0
    for mgr in list(_MANAGERS):
        try:
            s = mgr.stats()
        except ReferenceError:   # executor proxy died mid-iteration
            continue
        agg["managers"] += 1
        for k in _SUM_KEYS:
            agg[k] += int(s.get(k, 0))
    return agg


_metrics.register_collector("train", train_stats)


__all__ = ["TrainJobSpec", "TrainJobHandle", "TrainManager",
           "train_stats"]
