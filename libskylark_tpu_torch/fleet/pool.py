"""ReplicaPool: owns N named replicas and their shared lifecycle (the port
of libskylark_tpu/fleet/pool.py).

The pool is the fleet's capacity layer: it builds N replicas with one
executor configuration (one ``pad_floor``, one ``max_batch``, one
``device``: the router derives affinity keys and spill bounds from the
pool, so a mixed fleet would break sticky routing), names them
``r0..r{N-1}``, and gives the router one place to resolve health-hub
event sources to replica names. Membership is elastic:
:meth:`~ReplicaPool.add_replica` grows the pool by one pack-booted
replica (announced to subscribed routers by the hub's SERVING publish)
and :meth:`~ReplicaPool.remove_replica` shrinks it through the
preemption drain, the two verbs the autoscaler
(:mod:`libskylark_tpu_torch.fleet.autoscale`) drives.

Preemption: the pool registers one
:func:`~libskylark_tpu_torch.resilience.on_preemption` hook, so a
process-wide SIGTERM, which drains every in-process executor, also runs
every replica's drain hooks (final per-replica checkpoints) exactly once.
:meth:`preempt_replica` preempts one replica alone: a thread replica
drains in place, a process replica gets a real SIGTERM. Either way its
drain hooks fire, its in-flight futures resolve, and the hub announces
DRAINING → STOPPED, so a subscribed router sheds its traffic to peers.

Crash reap: a ``ProcessReplica`` child that exits unexpectedly (``kill
-9``, an OOM, a ``crash`` fault) publishes STOPPED from the parent's
reader thread; the pool reaps it: it leaves the membership at once (no
drain hooks: there was no grace window), its name lands in
:meth:`crashed_names`, and an attached autoscaler's next tick sees the
pool below its floor and replaces it by a pack boot.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.base.device import resolve_device
from libskylark_tpu_torch.engine import bucket as bucketing
from libskylark_tpu_torch.engine import serve as _serve
from libskylark_tpu_torch.fleet.replica import (ProcessReplica, Replica,
                                                ThreadReplica)
from libskylark_tpu_torch.resilience import health as _health
from libskylark_tpu_torch.resilience import preemption as _preemption

_UNSET = object()


def resolve_backend(backend: Optional[str]) -> str:
    """The effective replica backend: an explicit argument wins, else
    ``SKYLARK_FLEET_BACKEND``; ``auto`` is process replicas on hosts with
    at least 4 cores and thread replicas below. On a CUDA host each
    process replica holds a CUDA context of its own."""
    if backend is None:
        backend = str(_env.FLEET_BACKEND.get())
    backend = str(backend)
    if backend == "auto":
        return "process" if (os.cpu_count() or 1) >= 4 else "thread"
    return backend


class ReplicaPool:
    """N uniform replicas behind names (``r0``..``r{N-1}``).

    ::

        pool = fleet.ReplicaPool(4, max_batch=16, linger_us=2000)
        router = fleet.Router(pool)
        ...
        pool.shutdown()

    ``backend`` is ``"thread"`` (default), ``"process"`` or ``"auto"``;
    the other keyword arguments go to every replica's
    ``MicrobatchExecutor``, ``device=`` among them (the package default,
    ``"cuda"``, when absent). Process replicas also take ``coordinator=``,
    forwarded to ``parallel.multihost.initialize_distributed`` in the
    child. ``coordinator`` and ``replica_env`` may be a dict applied to
    every process replica or a callable ``name -> dict``: one replica,
    one seat or one device subset (``CUDA_VISIBLE_DEVICES``).

    ``warmup_pack`` boots every replica from a warmup pack: each replica
    captures the pack's buckets before serving (process replicas in
    their own interpreters, before the liveness probe resolves), so a
    fleet serves every packed bucket with no capture during traffic.

    ``shared_workers`` (thread backend only) sizes flush concurrency to
    the host instead of to N: the pool owns one dispatch queue and that
    many flush threads, and every replica puts its cohorts there
    (``MicrobatchExecutor(dispatch_queue=...)``).
    """

    def __init__(self, n: int = 2, *, backend: Optional[str] = None,
                 names: Optional[List[str]] = None, coordinator=None,
                 shared_workers: Optional[int] = None,
                 warmup_pack: Optional[str] = None,
                 replica_env=None,
                 **executor_kwargs):
        if n < 1:
            raise ValueError("a fleet needs at least one replica")
        backend = resolve_backend(backend)
        if backend not in ("thread", "process"):
            raise ValueError(
                f"backend must be 'thread', 'process' or 'auto', "
                f"got {backend!r}")
        names = list(names) if names else [f"r{i}" for i in range(n)]
        if len(names) != n or len(set(names)) != n:
            raise ValueError(f"need {n} distinct replica names, "
                             f"got {names!r}")
        self.backend = backend
        self.executor_kwargs = dict(executor_kwargs)
        self.pad_floor = int(executor_kwargs.get(
            "pad_floor", bucketing.PAD_FLOOR))
        self.max_batch = int(executor_kwargs.get("max_batch", 8))
        self._coordinator = coordinator
        self._replica_env = replica_env
        self.warmup_pack = warmup_pack
        self._lock = _locks.make_lock("fleet.pool")
        self._drain_hooks: Dict[str, list] = {name: [] for name in names}
        self._drained: set = set()
        self._replicas: Dict[str, Replica] = {}
        self._booting: set = set()
        # names under a pool-initiated preemption or drain: their STOPPED
        # events are expected, not crashes
        self._removing: set = set()
        self._crashed: List[str] = []
        self._shutdown = False
        self._next_idx = n
        self._dispatchq = None
        self._dispatchers: list = []
        if shared_workers is not None:
            if backend != "thread":
                raise ValueError(
                    "shared_workers applies to thread replicas only "
                    "(process replicas have their own interpreters)")
            import queue as _queue

            self._dispatchq = _queue.Queue()
            self._dispatchers = [
                threading.Thread(target=_serve.dispatch_loop,
                                 args=(self._dispatchq,),
                                 name=f"skylark-fleet-dispatch-{i}",
                                 daemon=True)
                for i in range(max(int(shared_workers), 1))]
            for t in self._dispatchers:
                t.start()
            executor_kwargs = dict(executor_kwargs,
                                   dispatch_queue=self._dispatchq)
        # the full construction kwargs (the shared queue included):
        # add_replica builds later replicas exactly like these
        self._replica_kwargs = dict(executor_kwargs)
        # every replica's device (a CUDA device with no card raises here)
        try:
            self.device = resolve_device(executor_kwargs.get("device"))
        except Exception:
            self._stop_dispatchers()
            raise
        try:
            self._build_all(names)
        except Exception:
            for r in self._replicas.values():
                r.shutdown()
            self._stop_dispatchers()
            raise
        # a SIGTERM to this process: the handler drains the executors,
        # then this hook runs every replica's drain hooks
        self._unhook = _preemption.on_preemption(self._run_all_drain_hooks)
        # crash reap (module doc): STOPPED events the pool did not start
        self._health_unsub = _health.subscribe(self._on_health_event)

    def _build_all(self, names: List[str]) -> None:
        """Build the initial replicas; process replicas boot all at once
        (each boot is a fresh interpreter and CUDA context)."""
        if self.backend == "thread" or len(names) == 1:
            for name in names:
                self._replicas[name] = self._build_replica(name)
            return
        built: Dict[str, Replica] = {}
        errs: list = []

        def boot(name):
            try:
                built[name] = self._build_replica(name)
            except BaseException as e:  # noqa: BLE001 — raised below
                errs.append(e)

        threads = [threading.Thread(target=boot, args=(name,),
                                    name=f"skylark-fleet-boot-{name}",
                                    daemon=True) for name in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for name in names:
            if name in built:
                self._replicas[name] = built[name]
        if errs:
            raise errs[0]

    def _per_replica(self, seat, name: str):
        return seat(name) if callable(seat) else seat

    def _build_replica(self, name: str,
                       warmup_pack=_UNSET) -> Replica:
        pack = (self.warmup_pack if warmup_pack is _UNSET
                else warmup_pack)
        if self.backend == "thread":
            return ThreadReplica(name, warmup_pack=pack,
                                 **self._replica_kwargs)
        return ProcessReplica(
            name, coordinator=self._per_replica(self._coordinator, name),
            env_overrides=self._per_replica(self._replica_env, name),
            warmup_pack=pack, **self._replica_kwargs)

    # -- addressing ----------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self._replicas)

    def replicas(self) -> List[Replica]:
        return [self._replicas[n] for n in self.names()]

    def get(self, name: str) -> Replica:
        return self._replicas[name]

    def resolve_source(self, source: object) -> Optional[str]:
        """Map a health-hub event source (an executor for thread
        replicas, the replica for process replicas) to its replica name;
        ``None`` for sources outside this pool."""
        for name, r in list(self._replicas.items()):
            if r.owns_source(source):
                return name
        return None

    # -- crash reap (module doc) ---------------------------------------

    def _on_health_event(self, source: object, old: str,
                         new: str) -> None:
        if new != _serve.STOPPED:
            return
        with self._lock:
            if self._shutdown:
                return
        name = self.resolve_source(source)
        if name is None:
            return
        dead = None
        with self._lock:
            if (name in self._removing or name in self._drained
                    or self._shutdown):
                return                 # pool-initiated: not a crash
            replica = self._replicas.get(name)
            if not isinstance(replica, ProcessReplica):
                return                 # threads have no crash mode
            if not replica.unexpected_exit:
                return                 # a drain's STOPPED, not a crash
            # reap now, so that the autoscaler's next tick replaces the
            # member instead of counting it as capacity
            dead = self._replicas.pop(name)
            self._drain_hooks.pop(name, None)
            self._crashed.append(name)
        if dead is not None:
            warnings.warn(
                f"replica {name!r} exited unexpectedly — reaped from "
                "the pool (an attached autoscaler will replace it)",
                RuntimeWarning, stacklevel=2)
            try:
                dead.shutdown()        # reap pipe and threads; idempotent
            except Exception:  # noqa: BLE001 — the process is gone
                pass

    def crashed_names(self) -> List[str]:
        """Names of replicas reaped after an unexpected exit."""
        with self._lock:
            return list(self._crashed)

    # -- elastic membership (the autoscaler's seam) --------------------

    def add_replica(self, name: Optional[str] = None, *,
                    warmup_pack=_UNSET) -> str:
        """Grow the pool by one replica (same backend and executor
        configuration; process replicas get their own ``coordinator`` /
        ``replica_env`` seat). Boots from the pool's warmup pack by
        default. Publishes ``SERVING`` once the replica is live, which is
        how a subscribed router adds it to its ring. Returns its name."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("ReplicaPool is shut down")
            if name is None:
                while (f"r{self._next_idx}" in self._replicas
                       or f"r{self._next_idx}" in self._booting):
                    self._next_idx += 1
                name = f"r{self._next_idx}"
                self._next_idx += 1
            name = str(name)
            if name in self._replicas or name in self._booting:
                raise ValueError(f"replica {name!r} already exists")
            # reserve the name: construction runs unlocked (a process
            # replica's boot takes seconds)
            self._booting.add(name)
        try:
            replica = self._build_replica(name, warmup_pack=warmup_pack)
        except Exception:
            with self._lock:
                self._booting.discard(name)
            raise
        with self._lock:
            self._booting.discard(name)
            if self._shutdown:
                # the pool went down during the boot: registering now
                # would hand a router a replica nothing will stop
                late = replica
            else:
                late = None
                self._replicas[name] = replica
                self._drain_hooks.setdefault(name, [])
                self._drained.discard(name)
        if late is not None:
            late.shutdown()
            raise RuntimeError(
                "ReplicaPool was shut down during the replica boot")
        _health.publish(replica, "NEW", _serve.SERVING)
        return name

    def remove_replica(self, name: str,
                       timeout: Optional[float] = 30.0) -> bool:
        """Shrink the pool by one replica: preempt it (a real SIGTERM for
        a process replica: DRAINING/STOPPED reach the hub, a router sheds
        its traffic, in-flight futures resolve, its drain hooks fire),
        then forget it. Returns whether the drain reached quiescence
        inside ``timeout``."""
        with self._lock:
            if name not in self._replicas:
                raise KeyError(f"no replica named {name!r}")
        drained = self.preempt_replica(name, timeout=timeout)
        with self._lock:
            replica = self._replicas.pop(name, None)
            self._drain_hooks.pop(name, None)
            self._drained.discard(name)
        if replica is not None:
            replica.shutdown()
        return drained

    # -- traffic helpers -----------------------------------------------

    def flush(self) -> None:
        """Flush every replica now, in name order (tests and
        deterministic storms)."""
        for name in self.names():
            self._replicas[name].flush()

    def stats(self) -> dict:
        return {name: self._replicas[name].stats()
                for name in self.names()}

    # -- per-replica preemption ----------------------------------------

    def on_replica_drain(self, name: str,
                         hook: Callable[[], None]) -> Callable[[], None]:
        """Register a final-drain hook for one replica; it runs exactly
        once, whether the replica is preempted alone
        (:meth:`preempt_replica`) or the whole process is SIGTERM'd.
        Returns the unregister callable."""
        with self._lock:
            self._drain_hooks[name].append(hook)

        def unregister() -> None:
            with self._lock:
                try:
                    self._drain_hooks[name].remove(hook)
                except (KeyError, ValueError):
                    pass

        return unregister

    def _run_drain_hooks(self, name: str) -> None:
        with self._lock:
            if name in self._drained:
                return
            self._drained.add(name)
            hooks = list(self._drain_hooks.get(name, ()))
        for hook in hooks:
            try:
                hook()
            except Exception as e:  # noqa: BLE001 — contained
                warnings.warn(
                    f"replica {name!r} drain hook {hook!r} failed: {e}",
                    RuntimeWarning, stacklevel=2)

    def _run_all_drain_hooks(self) -> None:
        for name in self.names():
            self._run_drain_hooks(name)

    def preempt_replica(self, name: str,
                        timeout: Optional[float] = 30.0) -> bool:
        """Preempt one replica: drain it (intake refused, DRAINING
        announced so that a router sheds its traffic, queued cohorts
        flushed, in-flight futures resolved), then run its drain hooks. A
        process replica gets a real SIGTERM and its own handler drains.
        Returns whether quiescence came inside ``timeout``."""
        replica = self._replicas[name]
        # a STOPPED ahead that the crash reap must not misread
        with self._lock:
            self._removing.add(name)
        try:
            if isinstance(replica, ProcessReplica):
                replica.preempt()
                # the child drains asynchronously: wait for its STOPPED
                deadline = time.monotonic() + (timeout or 30.0)
                while (replica.state() != "STOPPED"
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                drained = replica.state() == "STOPPED"
            else:
                drained = replica.drain(timeout=timeout)
            self._run_drain_hooks(name)
        finally:
            with self._lock:
                self._removing.discard(name)
        return drained

    def drain_replica(self, name: str,
                      timeout: Optional[float] = 30.0) -> bool:
        """Drain one replica without the preemption framing (no drain
        hooks): administrative removal."""
        with self._lock:
            self._removing.add(name)
        try:
            return self._replicas[name].drain(timeout=timeout)
        finally:
            with self._lock:
                self._removing.discard(name)

    # -- lifecycle -----------------------------------------------------

    def _stop_dispatchers(self) -> None:
        for _ in self._dispatchers:
            self._dispatchq.put(None)     # FIFO: queued cohorts first
        for t in self._dispatchers:
            t.join(timeout=30.0)
        self._dispatchers = []

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
        self._unhook()
        self._health_unsub()

        def stop(r: Replica) -> None:
            try:
                r.shutdown()
            except Exception as e:  # noqa: BLE001 — stop the rest too
                warnings.warn(f"replica {r.name!r} shutdown failed: {e}",
                              RuntimeWarning, stacklevel=2)

        if self.backend == "thread":
            for r in self.replicas():
                stop(r)
        else:
            # children exit concurrently (each tears down an interpreter)
            threads = [threading.Thread(target=stop, args=(r,),
                                        daemon=True)
                       for r in self.replicas()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if self._dispatchers:
            self._stop_dispatchers()

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


__all__ = ["ReplicaPool", "resolve_backend"]
