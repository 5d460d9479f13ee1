"""Fleet replicas: one submit surface over thread- or process-backed
microbatch executors (the port of libskylark_tpu/fleet/replica.py).

A *replica* is one unit of serving capacity the router can address: a
name (its ring identity and telemetry label), a future-returning
``submit`` mirroring :meth:`~libskylark_tpu_torch.engine.serve.
MicrobatchExecutor.submit`, a live queue-depth signal, the health states,
and the drain lifecycle.

Two backings:

- :class:`ThreadReplica`: an in-process
  :class:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor`. The
  router calls straight into the executor, which shares the process's
  executable cache, and its health transitions reach the hub directly.
- :class:`ProcessReplica`: a spawned child process hosting its own
  executor behind a pipe. The child is a real preemption domain: it
  installs :func:`~libskylark_tpu_torch.resilience.
  install_preemption_handler`, so a SIGTERM to the child alone drains its
  executor (in-flight futures resolve and their results still flow back)
  while the router sheds new traffic to peers. With ``coordinator`` kwargs
  the child joins a process group through
  :func:`~libskylark_tpu_torch.parallel.multihost.initialize_distributed`
  before serving. Spawn, never fork: a forked child would inherit the
  parent's CUDA context, which it cannot use.

Process-replica protocol (one duplex pipe): parent → child ``("submit",
rid, endpoint, tags, kwargs)`` / ``("session"|"train", rid, op, kwargs)`` /
``("shard", rid, task)`` / ``("register", rid, kwargs)`` /
``("unregister", rid, ref)`` / ``("stats"|"env"|"depth"|"flush", rid)`` /
``("drain", rid, timeout)`` / ``("shutdown", rid)``; child → parent
``("result", rid, value)`` / ``("error"|"refused", rid, exception)`` /
``("rpc", rid, value)`` / ``("state", None, new_state)``, the last
forwarded from the child's health hub so that the parent's hub (and a
subscribed router) sees the child's transitions with the
:class:`ProcessReplica` as the source. Both directions also carry ``("shmfree", None, [slots])`` acks of
the shared-memory transport (:mod:`~libskylark_tpu_torch.fleet.shm`,
default on; ``SKYLARK_FLEET_SHM=0`` turns it off).

QoS: ``submit`` kwargs carry the router-resolved ``tenant=``/
``qos_class=`` pair as they are, so every replica's executor schedules a
request in the class the front door admitted it in; a replica never
charges the tenant's token bucket again.

Where the port departs (ROADMAP C28):

- **Device.** A pool passes ``device=`` to every replica's executor; a
  child's device comes from it alone (no platform variable is read), and
  the child's ``CUDA_VISIBLE_DEVICES`` from ``env_overrides``, applied
  before anything in the child touches CUDA. Replicas on one card share
  it, each child with a CUDA context of its own.
- **What crosses the pipe.** No message holds a tensor
  (:func:`~libskylark_tpu_torch.fleet.shm.pipe_dumps`): operands and
  results travel as host arrays, in shm slots or pickled. The child reads
  its operands as host arrays. The parent resolves a ``result`` to what
  the thread replica's executor would hand back: each value that left
  the child as a tensor becomes a tensor on the replica's ``device``, by
  one copy from its slot, and the slot is released after the copy. A
  shard task's partial comes back as host arrays; the dist coordinator
  merges it on its own device.
- **Fault tags.** A submit carries the calling thread's fault tags
  (:func:`~libskylark_tpu_torch.resilience.faults.tag`), and the child
  submits under them, so that a tag-pinned fault plan in the child's
  environment fires on that request as it would in one process.
- **Refusals.** A submit the child's executor refuses at intake (a SIGTERM
  drain that began after the request left the parent) resolves to
  :class:`ReplicaRefusedError`, on which the router fails over as it does
  on a thread replica's refusal in ``submit``.
- **Launch counters.** A kernel wrapper counts its launches in the
  process that launches it. :meth:`ProcessReplica.boot_info` adds the
  child's counters under ``"launches"`` (a key of the port only).
"""

from __future__ import annotations

import functools
import itertools
import os
import signal
import threading
import time
import warnings
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.engine.serve import ServeOverloadedError
from libskylark_tpu_torch.fleet import shm as _shm

# Environment a replica child must agree with its parent on: the capture
# record store, the tune plan cache, the telemetry switches, the session
# directory. Propagated explicitly through the spawn arguments and applied
# at child entry, not left to what ``os.environ`` held when
# ``Process.start()`` ran. Derived from the typed registry (every
# ``propagate=True`` declaration in base/env.py), so a newly declared
# variable cannot miss propagation.
PROPAGATED_ENV = _env.propagated_names()


def propagated_env() -> dict:
    """Snapshot of :data:`PROPAGATED_ENV` in this process (``None`` marks
    a variable to unset in the child)."""
    return _env.snapshot_propagated()


def _apply_env(env: Optional[dict]) -> None:
    """Apply a parent's snapshot in the child (set present values, delete
    absent ones), then re-arm the readers that already ran at import
    time: telemetry's enable gate and its JSONL exporter."""
    if env is None:
        return
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        from libskylark_tpu_torch import telemetry

        telemetry.set_enabled(bool(_env.TELEMETRY.get())
                              or bool(_env.TELEMETRY_DIR.get()))
        if _env.TELEMETRY_DIR.get():
            telemetry.install_exporter()
    except Exception:  # noqa: BLE001 — telemetry must not block boot
        pass


def _launch_counts() -> dict:
    """This process's kernel launch counters, by counter name."""
    from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood,
                                             cuda_fwht, cuda_hash,
                                             cuda_sparse)

    return {k: int(v) for c in (cuda_dense.launches, cuda_hash.launches,
                                cuda_fwht.launches, cuda_fastfood.launches,
                                cuda_sparse.launches)
            for k, v in c.items()}


class Replica:
    """The surface the router programs against (see module doc)."""

    name: str

    def submit(self, endpoint: str, /, **kwargs) -> Future:
        raise NotImplementedError

    def session(self, op: str, /, **kwargs) -> Future:
        """Stateful-session verb: ``op`` is ``open`` / ``append`` /
        ``finalize`` with the matching ``MicrobatchExecutor`` session
        method's kwargs. Returns a future (``open`` resolves to the
        session id, ``append`` to ``(seq, rows)``, ``finalize`` to the
        result dict)."""
        raise NotImplementedError

    def train(self, op: str, /, **kwargs) -> Future:
        """Training-job verb: ``op`` is ``submit`` / ``resume`` /
        ``status`` with the matching ``MicrobatchExecutor`` train
        method's kwargs. ``submit`` and ``resume`` resolve to the job's
        terminal result (the trained model dict, or the terminal error);
        ``status`` to a progress snapshot."""
        raise NotImplementedError

    def shard(self, task: dict) -> Future:
        """Distributed-sketch shard task: the payload of
        :func:`libskylark_tpu_torch.dist.plan.execute_task` (a serialized
        plan, the shard index, a range-readable source). Resolves to the
        task's ``{"index", "rows", "partial"}`` dict. Idempotent (the
        partial is a function of the plan), so the coordinator retries by
        calling this on the next ring-preference replica."""
        raise NotImplementedError

    def register_operand(self, A, transform=None, dimension=None,
                         **kwargs) -> Future:
        """Operand residency: pin ``A`` resident on this replica (and its
        sketch when ``transform`` is given), so that later submits
        reference it by digest. Resolves to its ref string
        (``ref:<digest>``)."""
        raise NotImplementedError

    def unregister_operand(self, ref) -> Future:
        """Drop a resident operand (and its pinned sketches); resolves to
        whether this replica held it."""
        raise NotImplementedError

    def queue_depth(self) -> int:
        raise NotImplementedError

    def state(self) -> str:
        raise NotImplementedError

    def stats(self) -> dict:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError

    def latency_quantile(self, q: float = 0.99) -> Optional[float]:
        """One quantile of the replica's request latencies (seconds;
        ``None`` when unknown), the router's hedge-delay seed. A process
        replica returns ``None`` rather than pay a pipe round trip on the
        submit path."""
        return None


def _future_of(fn) -> Future:
    """A future resolved with ``fn()`` or its exception."""
    fut: Future = Future()
    try:
        fut.set_result(fn())
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:  # noqa: BLE001 — resolve, don't leak
        fut.set_exception(e)
    return fut


def _future_in_thread(fn, name: str) -> Future:
    """A future resolved with ``fn()`` or its exception on a one-shot
    daemon thread."""
    fut: Future = Future()

    def _run():
        try:
            fut.set_result(fn())
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — resolve
            fut.set_exception(e)

    threading.Thread(target=_run, name=name, daemon=True).start()
    return fut


class ThreadReplica(Replica):
    """In-process replica: a named ``MicrobatchExecutor`` and the thin
    identity layer the router needs."""

    backend = "thread"

    def __init__(self, name: str, warmup_pack: Optional[str] = None,
                 **executor_kwargs):
        from libskylark_tpu_torch import engine

        self.name = str(name)
        self.executor = engine.MicrobatchExecutor(name=self.name,
                                                  **executor_kwargs)
        self.device = self.executor.device
        self.warmup_report: Optional[dict] = None
        if warmup_pack:
            # before any traffic by construction: the pool builds its
            # replicas before the router exists
            self.warmup_report = self.executor.load_warmup_pack(
                warmup_pack)

    def submit(self, endpoint: str, /, **kwargs) -> Future:
        return self.executor.submit(endpoint, **kwargs)

    def session(self, op: str, /, **kwargs) -> Future:
        if op == "append":
            return self.executor.session_append(**kwargs)
        if op == "finalize":
            return self.executor.session_finalize(**kwargs)

        def _open():
            if op != "open":
                raise ValueError(f"unknown session op {op!r}")
            return self.executor.open_sketch_session(**kwargs)

        return _future_of(_open)

    def train(self, op: str, /, **kwargs) -> Future:
        if op in ("submit", "resume"):
            try:
                if op == "submit":
                    handle = self.executor.submit_train_job(
                        kwargs.pop("spec"),
                        operands=kwargs.pop("operands", None), **kwargs)
                else:
                    handle = self.executor.resume_train_job(**kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — resolve
                fut: Future = Future()
                fut.set_exception(e)
                return fut
            return handle.future

        def _status():
            if op != "status":
                raise ValueError(f"unknown train op {op!r}")
            return self.executor.train_job_status(**kwargs)

        return _future_of(_status)

    def shard(self, task: dict) -> Future:
        # a one-shot thread, not the executor queue: shard compute is
        # ingest and folds, which must not stall serve cohorts
        from libskylark_tpu_torch.dist.plan import execute_task

        return _future_in_thread(
            lambda: execute_task(task, device=self.device),
            f"{self.name}-shard")

    def register_operand(self, A, transform=None, dimension=None,
                         **kwargs) -> Future:
        # a one-shot thread: with a transform the pin waits for its
        # precompute flush, and the router broadcasts a registration to
        # every replica at once
        return _future_in_thread(
            lambda: str(self.executor.register_operand(
                A, transform=transform, dimension=dimension, **kwargs)),
            f"{self.name}-register")

    def unregister_operand(self, ref) -> Future:
        return _future_of(lambda: self.executor.unregister_operand(ref))

    def queue_depth(self) -> int:
        return self.executor.queue_depth()

    def state(self) -> str:
        return self.executor.state

    def stats(self) -> dict:
        return self.executor.stats()

    def flush(self) -> None:
        self.executor.flush()

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        return self.executor.drain(timeout=timeout)

    def shutdown(self) -> None:
        self.executor.shutdown()

    def latency_quantile(self, q: float = 0.99) -> Optional[float]:
        return self.executor.latency_quantile(q)

    def owns_source(self, source: object) -> bool:
        """Whether a health-hub event source is this replica (the
        executor publishes for thread replicas)."""
        return source is self.executor or source is self


# ---------------------------------------------------------------------------
# process-backed replica
# ---------------------------------------------------------------------------


class ReplicaRefusedError(ServeOverloadedError):
    """A process replica's child refused a request at intake (it was
    draining, stopped or shedding when the request came off the pipe): the
    request never ran there. A thread replica refuses inside ``submit``
    and the router fails over at once; a process replica's refusal comes
    back after ``submit`` returned, as this error, and the router fails
    over then."""


def _send_exception(send, rid, e: BaseException,
                    kind: str = "error") -> None:
    try:
        send((kind, rid, e))
    except Exception:  # an unpicklable exception: its repr instead
        send((kind, rid, RuntimeError(repr(e))))


def _resolve(fut: Future, result=None, exception=None) -> None:
    """Resolve a parent-side future, tolerating one already resolved: a
    hedge winner cancels the loser, whose result may still arrive."""
    try:
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except Exception:  # noqa: BLE001 — already done or cancelled
        pass


def _worker_main(conn, name: str, executor_kwargs: dict,
                 coordinator: Optional[dict],
                 env: Optional[dict] = None,
                 warmup_pack: Optional[str] = None,
                 shm_spec: Optional[dict] = None) -> None:
    """Child entry point (module level: spawn pickles it by name)."""
    # the parent's environment first: everything below, the first CUDA
    # call included (it reads CUDA_VISIBLE_DEVICES), sees the snapshot
    _apply_env(env)
    # attach the rings before the executor is built: the parent unlinks
    # the names once our liveness reply arrives, and the attach keeps the
    # mapping alive past that
    transport = None
    if shm_spec is not None:
        transport = _shm.ShmTransport.attach(shm_spec)
    from libskylark_tpu_torch import engine, resilience
    from libskylark_tpu_torch.resilience import faults
    from libskylark_tpu_torch.resilience import health as _health

    if coordinator:
        from libskylark_tpu_torch.parallel import multihost

        multihost.initialize_distributed(**coordinator)

    # SIGTERM drains this executor and runs its hooks, the in-process
    # preemption contract scoped to this replica
    resilience.install_preemption_handler()
    ex = engine.MicrobatchExecutor(name=name, **executor_kwargs)
    warmup_report = None
    if warmup_pack:
        # before the message loop: the parent's liveness RPC resolves only
        # after this, so a packed child is warm before any traffic
        try:
            warmup_report = ex.load_warmup_pack(warmup_pack)
        except Exception as e:  # noqa: BLE001 — a bad pack boots cold
            warmup_report = {"skipped": f"load failed: {e!r}"}

    send_lock = _locks.make_lock("fleet.replica_send")

    def send(msg) -> None:
        data = _shm.pipe_dumps(msg)
        with send_lock:
            conn.send_bytes(data)

    def flush_acks() -> None:
        """Ship the slots of collected operand views back to the parent
        (the p2c ring's writer); a dead pipe means the pair is going down
        anyway."""
        if transport is None:
            return
        acks = transport.drain_acks()
        if acks:
            try:
                send(("shmfree", None, acks))
            except Exception:  # noqa: BLE001 — parent gone
                pass

    def forward_state(source, old, new) -> None:
        if source is ex:
            try:
                send(("state", None, new))
            except Exception:  # parent gone mid-teardown
                pass

    _health.subscribe(forward_state)

    def incoming(payload):
        """A payload's operands as host arrays (slots recovered when it
        is refused)."""
        if transport is None:
            return _shm.from_wire(payload)
        try:
            return transport.decode(payload)
        except Exception:
            transport.recover(payload)
            flush_acks()
            raise

    def reply(rid, fut: Future) -> None:
        try:
            value = fut.result()
        except BaseException as e:  # noqa: BLE001 — the future's error
            _send_exception(send, rid, e)
            return
        try:
            if transport is None:
                send(("result", rid, _shm.to_wire(value)))
            else:
                # the result's bytes go straight into a ring slot (a
                # tensor on the card copied off it once)
                payload, claimed = transport.encode(value)
                try:
                    send(("result", rid, payload))
                except BaseException:
                    transport.unclaim(claimed)
                    raise
        except BaseException as e:  # noqa: BLE001 — containment
            _send_exception(send, rid, e)

    def rpc_in_thread(rid, fn, label: str) -> None:
        """``fn()``'s value as an ``rpc`` reply from a one-shot thread:
        session opens and train starts run fsyncs, shard tasks ingest and
        fold, registrations wait for a flush; none may stall the loop."""

        def _run():
            try:
                send(("rpc", rid, _shm.to_wire(fn())))
            except Exception as e:  # noqa: BLE001
                _send_exception(send, rid, e)

        threading.Thread(target=_run, name=f"{name}-{label}",
                         daemon=True).start()

    while True:
        flush_acks()
        try:
            if not conn.poll(0.1):
                if (resilience.preemption_requested()
                        and resilience.wait_for_preemption_teardown(0.0)):
                    break            # drained by SIGTERM; the parent's
                #                      reader sees our STOPPED event
                continue
            msg = _shm.pipe_recv(conn)
        except (EOFError, OSError):
            break
        kind, rid = msg[0], msg[1]
        if kind == "shmfree":
            if transport is not None:
                transport.release(msg[2])
            continue
        try:
            if kind == "submit":
                endpoint, tags, kwargs = msg[2], msg[3], incoming(msg[4])
                try:
                    with faults.tag(*tags):
                        fut = ex.submit(endpoint, **kwargs)
                except ServeOverloadedError as e:
                    # refused at intake: the router may send it elsewhere
                    _send_exception(send, rid, e, kind="refused")
                    continue
                fut.add_done_callback(functools.partial(reply, rid))
            elif kind == "session":
                # append operands ride the pickle pipe: the batch is
                # journaled to disk at once, a slot view buys nothing
                op, kwargs = msg[2], _shm.from_wire(msg[3])
                if op == "open":
                    rpc_in_thread(
                        rid, functools.partial(ex.open_sketch_session,
                                               **kwargs), "session-open")
                elif op == "append":
                    fut = ex.session_append(**kwargs)
                    fut.add_done_callback(functools.partial(reply, rid))
                elif op == "finalize":
                    fut = ex.session_finalize(**kwargs)
                    fut.add_done_callback(functools.partial(reply, rid))
                else:
                    raise ValueError(f"unknown session op {op!r}")
            elif kind == "train":
                # submit/resume start on a one-shot thread (the operand
                # persist and the session open run fsyncs); the reply
                # fires at the job's terminal future
                op, kwargs = msg[2], _shm.from_wire(msg[3])
                if op == "status":
                    send(("rpc", rid, ex.train_job_status(**kwargs)))
                elif op in ("submit", "resume"):
                    def _train_start(rid=rid, op=op, kwargs=kwargs):
                        try:
                            if op == "submit":
                                h = ex.submit_train_job(
                                    kwargs.pop("spec"),
                                    operands=kwargs.pop("operands", None),
                                    **kwargs)
                            else:
                                h = ex.resume_train_job(**kwargs)
                            h.future.add_done_callback(
                                functools.partial(reply, rid))
                        except Exception as e:  # noqa: BLE001
                            _send_exception(send, rid, e)

                    threading.Thread(target=_train_start,
                                     name=f"{name}-train",
                                     daemon=True).start()
                else:
                    raise ValueError(f"unknown train op {op!r}")
            elif kind == "shard":
                # a shard task on the child's device; its rows rode the
                # rings (dist.plan.source_to_wire), its partial goes back
                # as host arrays. The ``dist.shard`` fault site fires in
                # this process: a ``crash`` spec kills this child
                from libskylark_tpu_torch.dist.plan import execute_task

                rpc_in_thread(rid, functools.partial(
                    execute_task, incoming(msg[2]), device=ex.device),
                    "shard")
            elif kind == "register":
                # the operand rides the rings like submit kwargs; the pin
                # keeps its own copy on the device, so the slot releases
                # once the view drops
                rpc_in_thread(rid, lambda kw=incoming(msg[2]): str(
                    ex.register_operand(**kw)), "register")
            elif kind == "unregister":
                send(("rpc", rid, ex.unregister_operand(msg[2])))
            elif kind == "stats":
                send(("rpc", rid, ex.stats()))
            elif kind == "env":
                # boot introspection: the applied environment, the pack
                # report, the engine counters, the transport's counters
                # and this process's kernel launches
                send(("rpc", rid, {
                    "env": _env.snapshot_propagated(),
                    "warmup": warmup_report,
                    "engine": engine.stats().to_dict(),
                    "shm": (transport.stats()
                            if transport is not None else None),
                    "launches": _launch_counts(),
                }))
            elif kind == "depth":
                send(("rpc", rid, ex.queue_depth()))
            elif kind == "flush":
                ex.flush()
                send(("rpc", rid, True))
            elif kind == "drain":
                send(("rpc", rid, ex.drain(timeout=msg[2])))
            elif kind == "shutdown":
                ex.shutdown()
                send(("rpc", rid, True))
                break
        except Exception as e:  # noqa: BLE001 — per-message containment
            _send_exception(send, rid, e)
    try:
        ex.shutdown()
    except Exception:
        pass
    conn.close()


class ProcessReplica(Replica):
    """A replica in its own spawned process (see module doc). Slow to
    boot (a fresh interpreter and CUDA context per child) but a true
    preemption domain: :meth:`preempt` delivers a real SIGTERM. Its
    rings are sized by ``SKYLARK_FLEET_SHM_SLOTS`` /
    ``SKYLARK_FLEET_SHM_SLOT_BYTES`` as this constructor reads them."""

    backend = "process"

    def __init__(self, name: str, coordinator: Optional[dict] = None,
                 start_timeout: float = 120.0,
                 warmup_pack: Optional[str] = None,
                 env: Optional[dict] = None,
                 env_overrides: Optional[dict] = None,
                 shm: Optional[bool] = None, **executor_kwargs):
        import multiprocessing as mp

        from libskylark_tpu_torch.base.device import resolve_device

        self.name = str(name)
        # where results resolve: the executor's device, resolved here too
        # (a CUDA device with no card raises before any child starts)
        self.device = resolve_device(executor_kwargs.get("device"))
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe(duplex=True)
        # the environment rides the spawn args: snapshot now, apply at
        # child entry. ``env_overrides`` layers on top: the device-pinning
        # seat (CUDA_VISIBLE_DEVICES) without touching the parent's
        self._env = dict(env) if env is not None else propagated_env()
        if env_overrides:
            self._env.update({str(k): (None if v is None else str(v))
                              for k, v in env_overrides.items()})
        if shm is None:
            shm = bool(_env.FLEET_SHM.get())
        self._transport = None
        shm_spec = None
        if shm:
            # made before spawn so that the names ride the args; unlinked
            # once the liveness probe proves the child attached
            self._transport = _shm.ShmTransport.create(self.name)
            shm_spec = self._transport.child_spec()
        self._lock = _locks.make_lock("fleet.replica")  # send, bookkeeping
        self._rids = itertools.count()
        self._futures: "dict[int, Future]" = {}
        self._state = "SERVING"
        self._closed = False
        # set by the reader's tail when the child died without announcing
        # STOPPED through the drain flow: the pool's crash reap reads it
        self.unexpected_exit = False
        self.boot_seconds: Optional[float] = None
        t0 = time.perf_counter()
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child_conn, self.name, dict(executor_kwargs),
                  coordinator, self._env, warmup_pack, shm_spec),
            name=f"skylark-replica-{self.name}", daemon=True)
        try:
            self._proc.start()
        except BaseException:
            if self._transport is not None:
                self._transport.destroy()
            raise
        child_conn.close()
        self._reader = threading.Thread(
            target=self._reader_loop,
            name=f"skylark-replica-{self.name}-reader", daemon=True)
        self._reader.start()
        # prove liveness before the router trusts this replica: a stats
        # round trip takes the child through its imports and executor
        # construction, or surfaces its crash now
        if self._rpc("stats", timeout=start_timeout) is None:
            self.shutdown()
            raise ServeOverloadedError(
                f"process replica {self.name!r} failed to come up "
                f"within {start_timeout}s")
        self.boot_seconds = time.perf_counter() - t0
        if self._transport is not None:
            # the child holds its own mapping: drop the /dev/shm names
            # now, so that no kill on either side can leak them
            self._transport.unlink()

    # -- child → parent ------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One value the child sent as a tensor: a tensor on this
        replica's device, by one copy from the host array (a slot view is
        released once the caller drops it)."""
        with warnings.catch_warnings():
            # a slot view is read-only; the copy below never writes it
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(arr)
        return src.to(self.device, copy=True)

    def _reader_loop(self) -> None:
        from libskylark_tpu_torch.resilience import health as _health

        while True:
            try:
                msg = _shm.pipe_recv(self._conn)
            except (EOFError, OSError):
                break
            kind, rid, payload = msg[0], msg[1], msg[2]
            if kind == "state":
                old, self._state = self._state, payload
                _health.publish(self, old, payload)
                continue
            if kind == "shmfree":
                if self._transport is not None:
                    self._transport.release(payload)
                continue
            with self._lock:
                fut = self._futures.pop(rid, None)
            if fut is None:
                continue
            if kind == "error":
                _resolve(fut, exception=payload)
            elif kind == "refused":
                err = ReplicaRefusedError(
                    f"replica {self.name!r} refused the request: "
                    f"{payload}")
                err.__cause__ = payload
                _resolve(fut, exception=err)
            else:
                # a "result" resolves as the thread replica's executor
                # would (tensors on the device); an "rpc" keeps its host
                # arrays (a shard's partial)
                tensors = self._to_device if kind == "result" else None
                try:
                    if self._transport is not None:
                        payload = self._transport.decode(payload, tensors)
                    else:
                        payload = _shm.from_wire(payload, tensors)
                except Exception as e:  # noqa: BLE001 — torn slot
                    # the request is lost, its slots are not
                    if self._transport is not None:
                        self._transport.recover(payload)
                    _resolve(fut, exception=ServeOverloadedError(
                        f"replica {self.name!r} result decode failed: "
                        f"{e!r}"))
                    self._flush_shm_acks()
                    continue
                _resolve(fut, result=payload)
                del payload
            # result views released since the last turnaround free their
            # slots on the child (the c2p ring's writer)
            self._flush_shm_acks()
        # child gone: nothing pending can resolve and nothing can arrive
        # over the rings, so the transport goes down with it
        with self._lock:
            dead = list(self._futures.values())
            self._futures.clear()
        for fut in dead:
            if not fut.done():
                fut.set_exception(ServeOverloadedError(
                    f"replica process {self.name!r} exited with "
                    f"requests in flight"))
        if self._state != "STOPPED":
            # a graceful drain forwards DRAINING -> STOPPED before the
            # EOF; landing here with a live state means the process died
            # under us (kill -9, OOM, a ``crash`` fault), unless the
            # parent tore the pipe down itself
            old, self._state = self._state, "STOPPED"
            self.unexpected_exit = not self._closed
            _health.publish(self, old, "STOPPED")
        if self._transport is not None:
            self._transport.destroy()

    def _flush_shm_acks(self) -> None:
        """The ``shmfree`` turnaround for released result views (parent
        side); a dead pipe is fine, the pair is going down."""
        if self._transport is None:
            return
        acks = self._transport.drain_acks()
        if not acks:
            return
        try:
            data = _shm.pipe_dumps(("shmfree", None, acks))
            with self._lock:
                self._conn.send_bytes(data)
        except Exception:  # noqa: BLE001 — child gone
            pass

    # -- parent → child ------------------------------------------------

    def _send(self, kind: str, *payload) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed or not self._proc.is_alive():
                raise ServeOverloadedError(
                    f"replica process {self.name!r} is not serving")
            rid = next(self._rids)
            self._futures[rid] = fut
            try:
                self._conn.send_bytes(
                    _shm.pipe_dumps((kind, rid) + payload))
            except (OSError, ValueError) as e:
                self._futures.pop(rid, None)
                raise ServeOverloadedError(
                    f"replica process {self.name!r} pipe closed") from e
            except BaseException:
                # e.g. an unpicklable payload: the message never left, so
                # the rid must not wait for a reply that cannot come
                self._futures.pop(rid, None)
                raise
        return fut

    def _rpc(self, kind: str, *payload, timeout: float = 30.0):
        try:
            return self._send(kind, *payload).result(timeout=timeout)
        except Exception:  # noqa: BLE001 — callers treat None as down
            return None

    def _send_encoded(self, kind: str, *head, payload) -> Future:
        """Send ``payload`` (the last field) through the rings when the
        transport is up, else as its pipe form."""
        if self._transport is None:
            return self._send(kind, *head, _shm.to_wire(payload))
        self._flush_shm_acks()
        enc, claimed = self._transport.encode(payload)
        try:
            return self._send(kind, *head, enc)
        except BaseException:
            # the header never left: the child will never ack these
            self._transport.unclaim(claimed)
            raise

    def submit(self, endpoint: str, /, **kwargs) -> Future:
        # the router's derivation is an in-process shortcut; over the
        # pipe it would ship the operands twice, the child derives again.
        # The caller's fault tags ride along: the child submits under them
        kwargs.pop("_derived", None)
        from libskylark_tpu_torch.resilience import faults

        return self._send_encoded(
            "submit", endpoint, tuple(sorted(faults.current_tags())),
            payload=kwargs)

    def session(self, op: str, /, **kwargs) -> Future:
        # session operands ride the pickle pipe (see _worker_main)
        return self._send("session", op, _shm.to_wire(kwargs))

    def train(self, op: str, /, **kwargs) -> Future:
        # train operands ride the pickle pipe like session appends: the
        # child persists them to disk at submit anyway
        return self._send("train", op, _shm.to_wire(kwargs))

    def register_operand(self, A, transform=None, dimension=None,
                         **kwargs) -> Future:
        kwargs = dict(kwargs, A=A, transform=transform,
                      dimension=dimension)
        return self._send_encoded("register", payload=kwargs)

    def unregister_operand(self, ref) -> Future:
        return self._send("unregister", str(ref))

    def shard(self, task: dict) -> Future:
        # in-memory rows (source_to_wire's array form) ride the rings
        # like submit operands; descriptors and the reply take the pipe
        return self._send_encoded("shard", payload=task)

    def queue_depth(self) -> int:
        # outstanding requests the parent knows of: no pipe round trip on
        # the routing hot path
        with self._lock:
            return len(self._futures)

    def state(self) -> str:
        return self._state

    def stats(self) -> dict:
        return self._rpc("stats") or {}

    def boot_info(self) -> dict:
        """The child's applied environment, warmup-pack report, engine
        counters, transport counters and kernel launch counters
        (``"launches"``)."""
        return self._rpc("env") or {}

    def transport_stats(self) -> Optional[dict]:
        """Parent-side shared-memory transport counters (``None`` when
        the transport is off)."""
        if self._transport is None:
            return None
        return self._transport.stats()

    def flush(self) -> None:
        self._rpc("flush")

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        ok = self._rpc("drain", timeout,
                       timeout=(timeout or 30.0) + 10.0)
        return bool(ok)

    def preempt(self) -> None:
        """Deliver a real SIGTERM to the replica process: the child's
        preemption handler drains its executor (in-flight results still
        come back) and runs its checkpoint hooks."""
        if self._proc.is_alive():
            os.kill(self._proc.pid, signal.SIGTERM)

    def shutdown(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            if self._proc.is_alive():
                try:
                    self._conn.send_bytes(_shm.pipe_dumps(
                        ("shutdown", next(self._rids))))
                except (OSError, ValueError):
                    pass
            self._proc.join(timeout=30.0)
            if self._proc.is_alive():  # a wedged child: don't leak it
                warnings.warn(
                    f"replica process {self.name!r} did not exit; "
                    "terminating", RuntimeWarning, stacklevel=2)
                self._proc.terminate()
                self._proc.join(timeout=5.0)
        finally:
            try:
                self._conn.close()
            except OSError:
                pass
            if self._transport is not None:
                self._transport.destroy()

    def owns_source(self, source: object) -> bool:
        return source is self


__all__ = ["PROPAGATED_ENV", "ProcessReplica", "Replica",
           "ReplicaRefusedError", "ThreadReplica", "propagated_env"]
