"""Warm-cache-aware router: the fleet's front door (the port of
libskylark_tpu/fleet/router.py).

``Router.submit`` mirrors the single executor's API (``submit_sketch`` /
``submit_fastfood`` / ``submit_solve`` / ``submit_krr_predict`` and the
rest return the same futures) but picks a replica per request from three
live signals:

1. **Sticky bucket affinity.** The request's bucket statics
   (:func:`libskylark_tpu_torch.engine.request_statics`, the tuple the
   executor keys its flushes on) hash onto the replica ring
   (:mod:`libskylark_tpu_torch.fleet.ring`) under a *bounded-load* rule:
   the owner is the first replica in preference order owning fewer than
   ``ceil(classes/replicas)`` classes. Every request of a class lands on
   the replica whose flush graphs are already captured for it, so the
   fleet captures each (bucket, capacity) class once, and requests that
   can coalesce meet in one queue.
2. **Live load.** Past ``spill_threshold`` queued requests on the owner,
   the router spills to the least-loaded healthy peer (a counted
   affinity miss).
3. **Health.** The router subscribes to the resilience health hub: a
   DEGRADED replica is demoted (routed to only when every healthy peer is
   gone), a DRAINING or STOPPED one leaves the ring at once; its
   in-flight futures still resolve while new traffic sheds to peers. The
   DRAINING announcement comes from the draining thread before its queue
   empties: no polling.

Failover: each candidate dispatch is wrapped; a replica that refuses
(load shed, drain race, pipe loss) or an injected ``fleet.route`` fault
(:mod:`libskylark_tpu_torch.resilience.faults`) moves the request to the
next replica in ring preference order, so a SIGTERM'd replica costs no
client-visible failure.

Hedging (``Router(pool, hedge=True)`` / ``SKYLARK_FLEET_HEDGE``): a
request still unresolved after a p99-derived delay is mirrored to the
next healthy ring-preference replica, and the caller's future settles
with whichever attempt finishes first; the loser is cancelled, or, under
``SKYLARK_FLEET_HEDGE_VERIFY``, completed and compared bit for bit.

Telemetry: ``fleet.routed`` / ``fleet.affinity_hit`` / ``fleet.failover``
/ ``fleet.spilled`` / ``fleet.hedged`` / ``fleet.hedge_wins`` /
``fleet.hedge_mismatches`` / ``fleet.session_handoffs`` counters by
replica, a ``fleet.route`` span over the executor's ``serve.submit`` span
(same request id), and a ``fleet`` collector block in
``telemetry.snapshot()`` over every live router and autoscaler and the
process-lifetime hedge and scale totals.

Where the port departs (ROADMAP C28): the hedge verify compares with
``torch.equal`` once both results are on one device (tensors anywhere in
tuples and dicts, numpy arrays by ``np.array_equal``). Results of thread
and process replicas are the same type: tensors on the pool's device. A
request a process replica's child refused at intake (its drain began
after the request left the parent) fails over to a peer, as a thread
replica's refusal in ``submit`` does.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import sys
import threading
import time
import uuid
import warnings
import weakref
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Iterable, Optional

import numpy as np
import torch

from libskylark_tpu_torch import telemetry as _telemetry
from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors as _errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.engine import resultcache as _rcache
from libskylark_tpu_torch.engine import serve as _serve
from libskylark_tpu_torch.fleet.pool import ReplicaPool
from libskylark_tpu_torch.fleet.replica import ReplicaRefusedError, _resolve
from libskylark_tpu_torch.fleet.ring import HashRing
from libskylark_tpu_torch.qos import tenants as _qos
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience import health as _health
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

# live instruments (enablement-gated); the always-on rollup is the
# "fleet" collector below
_ROUTED = _metrics.counter(
    "fleet.routed", "Requests routed, by replica and affinity outcome")
_AFFINITY_HIT = _metrics.counter(
    "fleet.affinity_hit", "Requests landing on their ring owner")
_FAILOVER = _metrics.counter(
    "fleet.failover", "Route failovers, by refusing replica")
_SPILLED = _metrics.counter(
    "fleet.spilled", "Load spills away from a saturated ring owner")
_HEDGED = _metrics.counter(
    "fleet.hedged", "Straggler requests mirrored to a second replica, "
    "by hedge-target replica")
_HEDGE_WINS = _metrics.counter(
    "fleet.hedge_wins", "Hedged requests where the mirror finished "
    "first, by hedge-target replica")
_HEDGE_MISMATCH = _metrics.counter(
    "fleet.hedge_mismatches", "Hedge verify-mode comparisons where the "
    "two executions diverged (must stay 0: the endpoints are "
    "deterministic)")
_SESSION_HANDOFFS = _metrics.counter(
    "fleet.session_handoffs", "Stateful sessions re-resolved to a new "
    "owner replica (drain handoff or crash replay), by new owner")

# process-lifetime hedge rollup: hedge events outlive their router
_LIFETIME = _metrics.LifetimeCounter(
    "fleet.router_life",
    kinds=("hedged", "hedge_wins", "hedge_mismatches"))


class NoHealthyReplicaError(_serve.ServeOverloadedError):
    """Every replica refused the request (all draining or stopped, or the
    whole preference order failed over). A ``ServeOverloadedError``, so
    single-executor retry handling works against a fleet."""


def _same(a, b) -> bool:
    """Bit equality of two results: tensors by ``torch.equal`` on one
    device, arrays by ``np.array_equal``, containers element by element,
    anything else by ``==``."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor)
                and isinstance(b, torch.Tensor)):
            return False
        return (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b.to(a.device)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return bool(a == b)


class _HedgeEntry:
    """One hedged request's state. ``client`` is the caller's future;
    ``primary``/``hedge`` are the replica attempts racing to settle
    it."""

    __slots__ = ("endpoint", "kwargs", "statics", "primary",
                 "primary_name", "client", "tags", "t0", "fired",
                 "hedge", "hedge_name", "settled", "errors", "results")

    def __init__(self, endpoint, kwargs, statics, primary, primary_name,
                 tags):
        self.endpoint = endpoint
        self.kwargs = kwargs
        self.statics = statics
        self.primary = primary
        self.primary_name = primary_name
        self.client: Future = Future()
        self.tags = tags
        self.t0 = time.monotonic()
        self.fired = False
        self.hedge: Optional[Future] = None
        self.hedge_name: Optional[str] = None
        self.settled = False
        self.errors: dict = {}
        self.results: dict = {}


class _Hedger:
    """The router's straggler watchdog: one timer thread over a heap of
    (due time, entry). An entry whose client settled before its due time
    costs one heap pop; one still unresolved fires a mirror submit."""

    def __init__(self, router: "Router"):
        self._router = router
        self._cond = threading.Condition(
            _locks.make_lock("fleet.hedger"))
        self._heap: list = []
        self._seq = itertools.count()
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="skylark-fleet-hedger", daemon=True)
        self._thread.start()

    def watch(self, entry: _HedgeEntry, due: float) -> None:
        with self._cond:
            heapq.heappush(self._heap, (due, next(self._seq), entry))
            self._cond.notify()

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                now = time.monotonic()
                if not self._heap:
                    self._cond.wait(timeout=1.0)
                    continue
                due, _, entry = self._heap[0]
                if due > now:
                    self._cond.wait(timeout=due - now)
                    continue
                heapq.heappop(self._heap)
            # the dispatch runs outside the heap lock: a mirror submit can
            # block on a replica's queue
            try:
                self._router._fire_hedge(entry)
            except Exception as e:  # noqa: BLE001 — the watchdog lives
                warnings.warn(f"hedge dispatch failed: {e}",
                              RuntimeWarning, stacklevel=1)


class Router:
    """Front-door router over a :class:`ReplicaPool` (see module doc).

    ::

        pool = fleet.ReplicaPool(4, max_batch=16)
        router = fleet.Router(pool)
        fut = router.submit_sketch(transform, A)
        ...
        router.close(); pool.shutdown()

    ``spill_threshold`` (requests queued on the affinity owner before the
    router spills to the least-loaded peer) defaults to ``4 *
    max_batch``: a full cohort plus headroom, so that cohorts still fill
    before load balancing splits them.
    """

    def __init__(self, pool: ReplicaPool, *, vnodes: int = 64,
                 spill_threshold: Optional[int] = None,
                 hedge: Optional[bool] = None,
                 hedge_delay_ms: Optional[float] = None,
                 hedge_verify: Optional[bool] = None,
                 cache: Optional[bool] = None):
        self._pool = pool
        self._ring = HashRing(pool.names(), vnodes=vnodes)
        self.spill_threshold = int(
            spill_threshold if spill_threshold is not None
            else 4 * pool.max_batch)
        self._lock = _locks.make_lock("fleet.router")
        # hedged requests: arguments beat the environment; the hedger
        # thread starts with the first hedged submit
        self._hedge_on = bool(_env.FLEET_HEDGE.get()
                              if hedge is None else hedge)
        self._hedge_fixed_ms = (
            _env.FLEET_HEDGE_DELAY_MS.get()
            if hedge_delay_ms is None else float(hedge_delay_ms))
        self._hedge_verify = bool(_env.FLEET_HEDGE_VERIFY.get()
                                  if hedge_verify is None
                                  else hedge_verify)
        self._hedge_lock = _locks.make_lock("fleet.hedge")
        self._hedger: Optional[_Hedger] = None
        # front-door single-flight: identical concurrent submits coalesce
        # onto one routed dispatch; the content digest is computed here,
        # once, and forwarded as ``_digest``. Follows SKYLARK_CACHE unless
        # pinned by the argument.
        cache_on = bool(_env.CACHE.get() if cache is None else cache)
        self._flights: Optional[_rcache.SingleFlight] = (
            _rcache.SingleFlight(name="router") if cache_on else None)
        # the router's own pin table mirrors every broadcast registration:
        # a ref submit derives its statics and digest from this host copy,
        # while only the ref crosses to the chosen replica
        self._residency = _rcache.ResidencyTable(name="router")
        self._latency: "collections.deque" = collections.deque(
            maxlen=4096)
        self._hedge_delay_cache = (0.0, 0.05)   # (stamp, seconds)
        self._degraded: set = set()
        self._removed: set = set()
        self._counts = collections.Counter()
        self._by_replica = collections.Counter()
        # the dist front door's shard coordinator over the pool, made by
        # the first dist submit
        self._dist_co = None
        # bounded-load ownership: statics -> (epoch, owner), and the
        # number of classes each replica owns; cleared on a membership
        # change (an epoch bump)
        self._epoch = 0
        self._assign: dict = {}
        self._owned = collections.Counter()
        # session affinity: sid -> (epoch, owner). The recorded owner
        # stays authoritative while it is on the ring (ring growth does
        # not move a live session); when it leaves, the next touch hands
        # the session off to a survivor, which resumes it from
        # SKYLARK_SESSION_DIR
        self._sessions: dict = {}
        self._epoch_hub_seq = _health.transition_seq()
        # seed the view from the replicas' current states: a router built
        # after a replica started draining must not route to it
        for name in pool.names():
            state = pool.get(name).state()
            if state in (_serve.DRAINING, _serve.STOPPED):
                self._ring.remove(name)
                self._removed.add(name)
            elif state == _serve.DEGRADED:
                self._degraded.add(name)
        # a weak subscription: a router dropped without close() is not
        # pinned by the hub; the shim unsubscribes itself at the first
        # publish after the router is collected
        wm = weakref.WeakMethod(self._on_state)
        unsub_cell: list = []

        def _dispatch(source, old, new):
            fn = wm()
            if fn is None:
                if unsub_cell:
                    unsub_cell[0]()
                return
            fn(source, old, new)

        self._unsub = _health.subscribe(_dispatch)
        unsub_cell.append(self._unsub)
        _ROUTERS.add(self)

    # -- health subscription -------------------------------------------

    def _membership_changed_locked(self) -> None:
        self._epoch += 1
        self._epoch_hub_seq = _health.transition_seq()
        self._assign.clear()
        self._owned.clear()

    def _on_state(self, source, old: str, new: str) -> None:
        name = self._pool.resolve_source(source)
        if name is None:
            return                     # another pool's executor
        with self._lock:
            if new in (_serve.DRAINING, _serve.STOPPED):
                if name in self._ring:
                    self._ring.remove(name)
                    self._membership_changed_locked()
                self._removed.add(name)
                self._degraded.discard(name)
            elif new == _serve.DEGRADED:
                self._degraded.add(name)
            elif new == _serve.SERVING:
                self._degraded.discard(name)
                if name not in self._ring:
                    # a replica the pool grew or revived joins the ring
                    self._ring.add(name)
                    self._membership_changed_locked()
                    self._removed.discard(name)

    def _affinity_owner(self, statics: tuple,
                        record: bool = True) -> Optional[str]:
        """Sticky bounded-load owner of a bucket class; ``None`` on an
        empty ring. With ``record=False`` the derivation is read-only: no
        assignment is stored and no ownership charged, so that
        introspection (:meth:`owner_of`) cannot move real traffic."""
        with self._lock:
            hit = self._assign.get(statics)
            if hit is not None and hit[0] == self._epoch:
                return hit[1]
            n_members = len(self._ring)
            if n_members == 0:
                return None
            cap = -(-(len(self._assign) + 1) // n_members)  # ceil
            owner = None
            for name in self._ring.preference(statics):
                if owner is None:
                    owner = name           # unbounded fallback
                if self._owned[name] < cap:
                    owner = name
                    break
            if record:
                self._assign[statics] = (self._epoch, owner)
                self._owned[owner] += 1
            return owner

    # -- routing -------------------------------------------------------

    def _candidates(self, statics: tuple,
                    allow_spill: bool = True) -> tuple:
        """(ordered candidate names, affinity owner, spilled?): the owner
        first, the rest in ring preference order with DEGRADED members
        demoted to the tail; under owner saturation the least-loaded
        healthy peer goes first (a counted spill). ``allow_spill=False``
        (best_effort traffic) keeps the owner first whatever its depth."""
        owner = self._affinity_owner(statics)
        if owner is None:
            return (), None, False
        pref = [owner] + [n for n in self._ring.preference(statics)
                          if n != owner]
        with self._lock:
            degraded = set(self._degraded)
        healthy = [n for n in pref if n not in degraded]
        order = healthy + [n for n in pref if n in degraded]
        spilled = False
        if allow_spill and len(healthy) > 1 and order \
                and order[0] == owner:
            try:
                depth = self._pool.get(owner).queue_depth()
            except KeyError:           # removed by a scale-down race
                depth = None
            if depth is not None and depth >= self.spill_threshold:
                peers = []
                for n in healthy[1:]:
                    try:
                        peers.append((self._pool.get(n).queue_depth(),
                                      n))
                    except KeyError:
                        continue
                if peers:
                    best_depth, best = min(peers)
                    if best_depth < depth:
                        order.remove(best)
                        order.insert(0, best)
                        spilled = True
        return tuple(order), owner, spilled

    def _admit(self, tenant, qos_class) -> tuple:
        """(tenant, class) past the front door's QoS admission: a given
        class is taken as it is; otherwise the tenant's bucket is charged
        here (a refusal counted and raised: an over-quota request never
        reaches a replica)."""
        if qos_class is not None:
            return (str(tenant) if tenant else ""), _qos.coerce_class(
                qos_class)
        registry = _qos.get_registry()
        try:
            tenant, qos_class = registry.admit(tenant)
        except _errors.TenantQuotaError as e:
            cls = registry.resolve(tenant)[1]
            with self._lock:
                self._counts["rate_limited"] += 1
            _serve._QOS_RATE_LIMITED.inc(
                **{"class": cls, "tenant": e.tenant})
            raise
        # the label forwarded to replicas is vetted here
        return registry.accounting_name(tenant), qos_class

    def submit(self, endpoint: str, /, **kwargs) -> Future:
        """Route one request; returns the chosen replica's future. Takes
        the executor ``submit`` kwargs (operands and ``timeout`` /
        ``deadline`` / ``request_id`` / ``tenant``).

        QoS: the router is the front door. It resolves ``tenant=``
        against this process's registry, charges its token bucket (a
        :class:`~libskylark_tpu_torch.base.errors.TenantQuotaError`
        reaches the caller) and forwards the class as ``qos_class=``, so
        thread and process replicas schedule it alike without charging
        again. best_effort requests neither spill nor hedge."""
        tenant, kwargs["qos_class"] = self._admit(
            kwargs.pop("tenant", None), kwargs.get("qos_class"))
        kwargs["tenant"] = tenant or ""
        derive_kwargs = {k: v for k, v in kwargs.items()
                         if k not in ("timeout",)}
        host = None
        if _rcache.is_ref(derive_kwargs.get("A")):
            # a resident operand: statics and digest from the router's
            # pin; ``kwargs["A"]`` keeps the ref, which each replica
            # resolves against its own pin
            d = _rcache.as_ref(derive_kwargs["A"]).digest
            derive_kwargs["A"] = self._residency.resolve(d)
            host = {"A": self._residency.host(d)}
        derived = _serve.derive_request(
            endpoint, pad_floor=self._pool.pad_floor, **derive_kwargs)
        statics = derived[0]
        # the chosen replica reuses this derivation (the pool keeps the
        # fleet uniform, so its pad_floor is the replicas')
        kwargs["_derived"] = derived
        rid = kwargs.get("request_id")
        if rid is None and _telemetry.enabled():
            rid = kwargs["request_id"] = _trace.new_request_id()
        if self._flights is None:
            return self._route(endpoint, kwargs, statics, rid)
        # single-flight at the front door: a submit whose digest matches
        # an in-flight leader gets a follower future without touching any
        # replica; the leader's settle fans its one result out
        digest = kwargs.get("_digest")
        if digest is None:
            digest = kwargs["_digest"] = _serve.request_digest(
                endpoint, derived, derive_kwargs, host=host)
        cls = kwargs["qos_class"]
        follower = self._flights.join(digest, cls)
        if follower is not None:
            with self._lock:
                self._counts["coalesced"] += 1
            return follower
        flight = self._flights.lead(digest, cls)
        try:
            fut = self._route(endpoint, kwargs, statics, rid)
        except BaseException as e:
            # the leader never dispatched: its followers fail alike
            self._flights.abort(flight, e)
            raise
        fut.add_done_callback(
            lambda f, _fl=flight: self._flights.settle(_fl, f))
        return fut

    def _route(self, endpoint: str, kwargs: dict, statics: tuple,
               rid) -> Future:
        """One routed dispatch (the fast path, else the candidate
        walk)."""
        # the route span is the request's root: the executor's
        # serve.submit span opens inside it (same thread, same request id)
        with _trace.span("fleet.route", attrs={"endpoint": endpoint},
                         request_id=rid) as sp:
            tags = faults.current_tags()
            # fast path: a healthy, unsaturated owner takes the request
            # without materializing the failover order
            owner = self._affinity_owner(statics)
            if owner is not None and owner not in self._degraded:
                try:
                    owner_depth = self._pool.get(owner).queue_depth()
                except KeyError:       # removed between ring and here
                    owner_depth = None
                if (owner_depth is not None
                        and (owner_depth < self.spill_threshold
                             or kwargs["qos_class"] == _qos.BEST_EFFORT)):
                    try:
                        faults.check("fleet.route", tags=tags,
                                     detail=f"{endpoint} -> {owner}")
                        fut = self._pool.get(owner).submit(endpoint,
                                                           **kwargs)
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as e:  # noqa: BLE001
                        self._note_failover(owner, sp, e)
                        return self._submit_slow(
                            endpoint, kwargs, statics, owner, sp,
                            tags, skip=owner, last_err=e)
                    self._account(owner, owner, False, sp)
                    fut = self._failover_on_refusal(
                        endpoint, kwargs, statics, owner, fut, tags)
                    return self._maybe_hedge(endpoint, kwargs, statics,
                                             owner, fut, tags)
            return self._submit_slow(endpoint, kwargs, statics, owner,
                                     sp, tags)

    def _note_failover(self, name: str, sp=None, err=None) -> None:
        with self._lock:
            self._counts["failover"] += 1
        _FAILOVER.inc(replica=name)
        if sp is not None:
            sp.add_event("failover", {"replica": name, "error": repr(err)})

    def _account(self, name: str, owner: Optional[str], spilled: bool,
                 sp) -> None:
        hit = name == owner
        with self._lock:
            self._counts["routed"] += 1
            self._counts["affinity_hit"] += hit
            self._counts["spilled"] += spilled
            self._by_replica[name] += 1
        _ROUTED.inc(replica=name, affinity=str(hit).lower())
        if hit:
            _AFFINITY_HIT.inc(replica=name)
        if spilled:
            _SPILLED.inc(replica=name)
        if sp is not None:
            sp.set_attr("replica", name)
            sp.set_attr("affinity_hit", hit)

    def _submit_slow(self, endpoint: str, kwargs: dict, statics: tuple,
                     owner: Optional[str], sp, tags,
                     skip: Optional[str] = None,
                     last_err: Optional[BaseException] = None) -> Future:
        """The full candidate walk (see :meth:`_candidates`). ``skip`` is
        a candidate the fast path already tried and counted."""
        order, owner, spilled = self._candidates(
            statics,
            allow_spill=kwargs.get("qos_class") != _qos.BEST_EFFORT)
        for name in order:
            if name == skip:
                continue
            try:
                # the chaos seam, per route attempt
                faults.check("fleet.route", tags=tags,
                             detail=f"{endpoint} -> {name}")
                fut = self._pool.get(name).submit(endpoint, **kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — failover
                last_err = e
                self._note_failover(name, sp, e)
                continue
            self._account(name, owner, spilled, sp)
            fut = self._failover_on_refusal(endpoint, kwargs, statics,
                                            name, fut, tags)
            return self._maybe_hedge(endpoint, kwargs, statics, name,
                                     fut, tags)
        raise NoHealthyReplicaError(
            f"no replica accepted {endpoint!r}: tried "
            f"{list(order) or 'none (empty ring)'}"
        ) from last_err

    def _failover_on_refusal(self, endpoint: str, kwargs: dict,
                             statics: tuple, name: str, fut: Future,
                             tags) -> Future:
        """A process replica's future, failing over when its child
        refused the request at intake (:class:`~libskylark_tpu_torch.
        fleet.replica.ReplicaRefusedError`: the request never ran there,
        as when a thread replica refuses in ``submit``). The refusal comes
        over the pipe after the child's DRAINING announcement, so the
        ring no longer holds the refusing replica when it is re-routed.
        Other outcomes pass through."""
        if not isinstance(fut, Future) or self._pool.backend != "process":
            return fut
        client: Future = Future()

        def settle(f: Future) -> None:
            if f.cancelled():
                client.cancel()
                return
            err = f.exception()
            if isinstance(err, ReplicaRefusedError):
                self._note_failover(name, None, err)
                try:
                    nxt = self._submit_slow(endpoint, kwargs, statics,
                                            None, None, tags, skip=name,
                                            last_err=err)
                except BaseException as e:  # noqa: BLE001 — the client's
                    _resolve(client, exception=e)
                    return
                nxt.add_done_callback(settle_from)
                return
            settle_from(f)

        def settle_from(f: Future) -> None:
            if f.cancelled():
                client.cancel()
            elif f.exception() is not None:
                _resolve(client, exception=f.exception())
            else:
                _resolve(client, result=f.result())

        fut.add_done_callback(settle)
        return client

    # -- pipelined distributed serve -----------------------------------

    def _dist_coordinator(self):
        with self._lock:
            co = self._dist_co
        if co is None:
            from libskylark_tpu_torch.dist.coordinator import (
                DistSketchCoordinator)

            # partials merge on the pool's device
            co = DistSketchCoordinator(pool=self._pool,
                                       device=self._pool.device)
            with self._lock:
                if self._dist_co is None:
                    self._dist_co = co
                else:
                    co = self._dist_co
        return co

    def _submit_dist(self, endpoint: str, plan, source, *,
                     tenant=None, qos_class=None, min_coverage=None,
                     deadline=None, timeout=None, request_id=None,
                     pipeline=None, solve=None,
                     digest_extra=()) -> Future:
        """Front door of one distributed job: admission, digest and
        single-flight happen here, once; then the first ring-preference
        replica with an in-process executor owns the job (thread fleets),
        or the router drives the shard storm itself (process fleets).
        Either way the shard tasks fan out over the whole pool through
        the shared coordinator."""
        from libskylark_tpu_torch.dist import serve as _dserve

        plan.validate()
        if source.n < plan.n:
            raise _errors.InvalidParametersError(
                f"source holds {source.n} rows < plan.n={plan.n}")
        tenant, qos_class = self._admit(tenant, qos_class)
        rid = request_id
        if rid is None and _telemetry.enabled():
            rid = _trace.new_request_id()
        with self._lock:
            self._counts["dist_jobs"] += 1
        co = self._dist_coordinator()
        owner_ex = None
        for name in self._ring.preference(("dist", plan.fingerprint())):
            try:
                ex = getattr(self._pool.get(name), "executor", None)
            except KeyError:
                continue
            if ex is not None:
                owner_ex = ex
                break

        def _dispatch(digest=None) -> Future:
            if owner_ex is not None:
                return owner_ex._submit_dist(
                    endpoint, plan, source, tenant=tenant,
                    qos_class=qos_class, min_coverage=min_coverage,
                    deadline=deadline, timeout=timeout,
                    request_id=rid, coordinator=co, pipeline=pipeline,
                    _digest=digest, solve=solve,
                    digest_extra=digest_extra)
            with _trace.span("fleet.route",
                             attrs={"endpoint": endpoint},
                             request_id=rid) as sp:
                job = _dserve.DistServeJob(
                    plan, source, coordinator=co, qos_class=qos_class,
                    tenant=tenant, registry=_qos.get_registry(),
                    min_coverage=min_coverage,
                    deadline=(deadline if deadline is not None
                              else timeout),
                    pipeline=pipeline, request_id=rid,
                    parent_ctx=sp.context() if sp is not None
                    else None)
                fut: Future = Future()
                _dserve.run_job_into(job, fut, solve=solve)
            return fut

        if self._flights is None:
            return _dispatch()
        # the coverage gate rides the digest: twins gating at 0.9 and 1.0
        # are different requests
        gate = (_dserve.class_min_coverage(qos_class)
                if min_coverage is None else float(min_coverage))
        digest = _dserve.dist_request_digest(
            endpoint, plan, source,
            extra=(*tuple(digest_extra), ("gate", gate)))
        follower = self._flights.join(digest, qos_class)
        if follower is not None:
            with self._lock:
                self._counts["coalesced"] += 1
            return follower
        flight = self._flights.lead(digest, qos_class)
        try:
            fut = _dispatch(digest)
        except BaseException as e:
            self._flights.abort(flight, e)
            raise
        fut.add_done_callback(
            lambda f, _fl=flight: self._flights.settle(_fl, f))
        return fut

    def submit_dist_sketch(self, plan, source, **kw) -> Future:
        """Pipelined distributed sketch through the fleet (see
        :meth:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor.
        submit_dist_sketch`): the router is the QoS front door and the
        single-flight tier, the pool the shard fleet."""
        return self._submit_dist("dist_sketch", plan, source, **kw)

    def submit_dist_lstsq(self, source, *, s_dim: int, seed: int = 0,
                          kind: str = "cwt", shard_rows: int = 0,
                          **kw) -> Future:
        """Distributed sketched least squares through the fleet."""
        from libskylark_tpu_torch.dist import serve as _dserve
        from libskylark_tpu_torch.dist.algorithms import lstsq_plan

        plan = lstsq_plan(source, s_dim=s_dim, seed=seed, kind=kind,
                          shard_rows=shard_rows)
        return self._submit_dist("dist_lstsq", plan, source,
                                 solve=_dserve.solve_lstsq, **kw)

    def submit_dist_svd(self, source, rank: int, *, s_dim=None,
                        seed: int = 0, kind: str = "jlt",
                        shard_rows: int = 0, **kw) -> Future:
        """Distributed randomized SVD through the fleet."""
        from libskylark_tpu_torch.dist import serve as _dserve
        from libskylark_tpu_torch.dist.algorithms import svd_plan

        plan = svd_plan(source, rank, s_dim=s_dim, seed=seed,
                        kind=kind, shard_rows=shard_rows)
        return self._submit_dist(
            "dist_svd", plan, source,
            solve=lambda r: _dserve.solve_svd(r, rank),
            digest_extra=(("rank", int(rank)),), **kw)

    # -- hedged requests -----------------------------------------------

    def _maybe_hedge(self, endpoint: str, kwargs: dict, statics: tuple,
                     name: str, fut: Future, tags) -> Future:
        """Wrap an accepted dispatch in the straggler watchdog: if the
        replica's future is still unresolved after the hedge delay, the
        request is mirrored to the next healthy ring-preference replica
        and the returned future settles with whichever attempt finishes
        first. Both executions give the same bits (the endpoints are
        functions of the operands and the transform's key data, and the
        mirror reuses the same kwargs). The replica's future passes
        through when hedging is off or the request is best_effort."""
        if (not self._hedge_on
                or kwargs.get("qos_class") == _qos.BEST_EFFORT):
            return fut
        if self._hedger is None:
            with self._hedge_lock:
                if self._hedger is None:
                    self._hedger = _Hedger(self)
        entry = _HedgeEntry(endpoint, kwargs, statics, fut, name, tags)
        fut.add_done_callback(
            lambda f: self._attempt_done(entry, f, "primary"))
        self._hedger.watch(entry,
                           time.monotonic() + self._hedge_delay_s())
        return entry.client

    def _hedge_delay_s(self) -> float:
        """The straggler threshold: ``hedge_delay_ms`` when pinned, else
        the p99 of this router's recent client latencies (seeded from the
        replicas' :meth:`latency_quantile` until it has samples), cached
        for 0.5 s."""
        if self._hedge_fixed_ms is not None:
            return max(float(self._hedge_fixed_ms), 0.0) / 1000.0
        now = time.monotonic()
        stamp, val = self._hedge_delay_cache
        if now - stamp < 0.5:
            return val
        with self._hedge_lock:
            lat = sorted(self._latency)
        p99 = _serve._percentile(lat, 0.99)
        if p99 is None:
            qs = [q for q in (r.latency_quantile(0.99)
                              for r in self._pool.replicas())
                  if q is not None]
            p99 = max(qs) if qs else 0.05
        val = min(max(p99, 0.001), 5.0)
        self._hedge_delay_cache = (now, val)
        return val

    def _fire_hedge(self, entry: _HedgeEntry) -> None:
        """The hedger's callback at an entry's due time: dispatch the
        mirror unless the primary resolved. If every peer refuses, the
        primary keeps its race unopposed."""
        with self._hedge_lock:
            if entry.settled or entry.fired or entry.primary.done():
                return
            # a settling primary clears the payload (heap entries outlive
            # their requests)
            kwargs = entry.kwargs
        if kwargs is None:
            return
        with self._lock:
            degraded = set(self._degraded)
        hfut = target = None
        for nm in self._ring.preference(entry.statics):
            if nm == entry.primary_name or nm in degraded:
                continue
            try:
                faults.check("fleet.route", tags=entry.tags,
                             detail=f"hedge {entry.endpoint} -> {nm}")
                hfut = self._pool.get(nm).submit(entry.endpoint,
                                                 **kwargs)
                target = nm
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException:  # noqa: BLE001 — try the next peer
                continue
        if hfut is None:
            return
        armed = False
        with self._hedge_lock:
            if not entry.settled:
                entry.fired = True
                entry.hedge = hfut
                entry.hedge_name = target
                entry.kwargs = None     # both attempts dispatched
                armed = True
        if not armed:
            hfut.cancel()
            return
        with self._lock:
            self._counts["hedged"] += 1
        _LIFETIME.inc("hedged")
        _HEDGED.inc(replica=target)
        hfut.add_done_callback(
            lambda f: self._attempt_done(entry, f, "hedge"))

    def _attempt_done(self, entry: _HedgeEntry, fut: Future,
                      who: str) -> None:
        """Race arbitration: the first successful attempt settles the
        client; the loser is cancelled, or in verify mode completed and
        compared. A failed attempt fails the client only when no other
        attempt can still win."""
        if fut.cancelled():
            return
        err = fut.exception()
        value = fut.result() if err is None else None
        settle_exc = settle_val = None
        to_cancel = None
        win = False
        have_val = False
        with self._hedge_lock:
            if err is not None:
                entry.errors[who] = err
                if entry.settled:
                    return
                peer = (entry.hedge if who == "primary"
                        else entry.primary)
                peer_live = (peer is not None and not peer.done()
                             and (who == "hedge" or entry.fired))
                if peer_live:
                    return             # the peer may still win
                entry.settled = True
                entry.kwargs = None
                settle_exc = err
            else:
                if self._hedge_verify:
                    entry.results[who] = value
                if not entry.settled:
                    entry.settled = True
                    entry.kwargs = None
                    settle_val, have_val = value, True
                    win = who == "hedge" and entry.fired
                    if not self._hedge_verify:
                        to_cancel = (entry.hedge if who == "primary"
                                     else entry.primary)
            both = self._hedge_verify and len(entry.results) == 2
        if settle_exc is not None:
            try:
                entry.client.set_exception(settle_exc)
            except Exception:  # noqa: BLE001 — already resolved
                pass
            return
        if have_val:
            with self._hedge_lock:
                self._latency.append(time.monotonic() - entry.t0)
            try:
                entry.client.set_result(settle_val)
            except Exception:  # noqa: BLE001 — already resolved
                pass
            if win:
                with self._lock:
                    self._counts["hedge_wins"] += 1
                _LIFETIME.inc("hedge_wins")
                _HEDGE_WINS.inc(replica=entry.hedge_name)
            if to_cancel is not None and not to_cancel.done():
                to_cancel.cancel()
        if both:
            self._verify_hedge(entry)

    def _verify_hedge(self, entry: _HedgeEntry) -> None:
        """Determinism guard (verify mode): both attempts completed, and
        their results must be bit-equal (:func:`_same`). A divergence is
        counted and warned, never averaged away."""
        try:
            equal = _same(entry.results["primary"],
                          entry.results["hedge"])
        except Exception:  # noqa: BLE001 — incomparable results
            equal = False
        with self._lock:
            self._counts["hedge_verified"] += 1
        if not equal:
            with self._lock:
                self._counts["hedge_mismatches"] += 1
            _LIFETIME.inc("hedge_mismatches")
            _HEDGE_MISMATCH.inc(replica=entry.hedge_name or "?")
            warnings.warn(
                f"hedged {entry.endpoint} produced diverging results "
                f"on {entry.primary_name!r} vs {entry.hedge_name!r} — "
                "a serve endpoint is no longer deterministic",
                RuntimeWarning, stacklevel=2)
        entry.results.clear()          # compared: drop the payloads

    # executor-mirroring conveniences

    def submit_sketch(self, transform, A, dimension=None, **kw) -> Future:
        return self.submit("sketch_apply", transform=transform, A=A,
                           dimension=dimension, **kw)

    def submit_fastfood(self, transform, A, **kw) -> Future:
        return self.submit("fastfood_features", transform=transform,
                           A=A, **kw)

    def submit_solve(self, A, B, transform, method: str = "qr",
                     **kw) -> Future:
        return self.submit("solve_l2_sketched", A=A, B=B,
                           transform=transform, method=method, **kw)

    def submit_krr_predict(self, kernel, X_new, X_train, coef,
                           **kw) -> Future:
        return self.submit("krr_predict", kernel=kernel, X_new=X_new,
                           X_train=X_train, coef=coef, **kw)

    def submit_graph_ase(self, A, k: int, *, seed: int = 0,
                         iters: int = 2, **kw) -> Future:
        return self.submit("graph_ase", A=A, k=k, seed=seed,
                           iters=iters, **kw)

    def submit_graph_ppr(self, A, s, *, alpha: float = 0.85,
                         iters: int = 16, **kw) -> Future:
        return self.submit("graph_ppr", A=A, s=s, alpha=alpha,
                           iters=iters, **kw)

    def submit_condest(self, A, *, steps: int = 8, seed: int = 0,
                       **kw) -> Future:
        return self.submit("condest", A=A, steps=steps, seed=seed, **kw)

    def submit_lowrank(self, transform_s, transform_t, A, k: int,
                       **kw) -> Future:
        return self.submit("lowrank", transform_s=transform_s,
                           transform_t=transform_t, A=A, k=k, **kw)

    def submit_rlsc_predict(self, kernel, X_new, X_train, coef,
                            coding=None, **kw) -> Future:
        return self.submit("rlsc_predict", kernel=kernel, X_new=X_new,
                           X_train=X_train, coef=coef, coding=coding,
                           **kw)

    def submit_compressed_matmul(self, A, B, transform=None, *,
                                 s_dim=None, seed: int = 0,
                                 **kw) -> Future:
        if transform is None:
            # the executor's construction: both front doors build the
            # same default operator
            transform = _serve.default_cmm_transform(
                A, s_dim=s_dim, seed=seed)
        return self.submit("compressed_matmul", transform=transform,
                           A=A, B=B, **kw)

    # -- stateful sessions ---------------------------------------------

    def open_sketch_session(self, kind: str, *,
                            session_id: Optional[str] = None,
                            owner: Optional[str] = None,
                            timeout: float = 60.0, **spec_kwargs) -> str:
        """Open a session on one replica and pin its affinity there: the
        first healthy replica in the ring preference order of
        ``("session", sid)``, unless ``owner`` pins one (which then does
        not fail over). Returns the session id."""
        sid = str(session_id) if session_id else uuid.uuid4().hex[:16]
        tags = faults.current_tags()
        order = ((owner,) if owner
                 else self._session_candidates(sid))
        last_err: Optional[BaseException] = None
        for name in order:
            # a candidate that refuses the open moves it to the next one:
            # the registry's open has no effect when refused
            try:
                faults.check("fleet.route", tags=tags,
                             detail=f"session:open {sid} -> {name}")
                fut = self._pool.get(name).session(
                    "open", kind=kind, session_id=sid, **spec_kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — failover
                last_err = e
                if owner:
                    raise
                self._note_failover(name)
                continue
            try:
                sid = fut.result(timeout=timeout)
            except (KeyboardInterrupt, SystemExit):
                raise
            except (_FutTimeout, TimeoutError):
                # a timeout is not a refusal: the open may have landed on
                # this replica, so the id stays pinned to it
                with self._lock:
                    self._sessions[sid] = (self._epoch, name)
                raise _errors.CommunicationError(
                    f"session open {sid!r} on replica {name!r} did "
                    f"not resolve within {timeout}s; the open may "
                    f"still have landed there — the id stays pinned "
                    f"to {name!r}: retry a session verb against it, "
                    "or evict the id") from None
            except BaseException as e:  # noqa: BLE001 — failover
                last_err = e
                if owner:
                    raise
                self._note_failover(name)
                continue
            with self._lock:
                self._sessions[sid] = (self._epoch, name)
            return sid
        raise NoHealthyReplicaError(
            f"no replica accepted the session open for {sid!r}: "
            f"tried {list(order)}") from last_err

    def _session_candidates(self, sid: str) -> tuple:
        """Healthy-first preference order of a session id (DEGRADED
        demoted to the tail)."""
        pref = list(self._ring.preference(("session", sid)))
        if not pref:
            raise NoHealthyReplicaError(
                f"no replica available for session {sid!r} "
                "(empty ring)")
        with self._lock:
            degraded = set(self._degraded)
        return tuple([n for n in pref if n not in degraded]
                     + [n for n in pref if n in degraded])

    def _session_owner(self, sid: str) -> str:
        """A session's owner: a recorded assignment holds while that
        replica is on the ring; once it left, the id re-resolves against
        the survivors (a handoff: the new owner resumes the session from
        ``SKYLARK_SESSION_DIR`` at its first touch)."""
        with self._lock:
            entry = self._sessions.get(sid)
            if entry is not None and entry[1] in self._ring:
                if entry[0] != self._epoch:
                    self._sessions[sid] = (self._epoch, entry[1])
                return entry[1]
        new = self._session_candidates(sid)[0]
        self._note_session_owner(sid, new)
        return new

    def _note_session_owner(self, sid: str, new: str) -> None:
        with self._lock:
            prev = self._sessions.get(sid)
            handoff = prev is not None and prev[1] != new
            self._sessions[sid] = (self._epoch, new)
            if handoff:
                self._counts["session_handoffs"] += 1
        if handoff:
            _SESSION_HANDOFFS.inc(replica=new)

    def _session_call(self, sid: str, op: str, kwargs: dict) -> Future:
        """Dispatch one session verb to the owner, failing over down the
        candidate order when a replica refuses the call. A future the
        owner accepted and later fails is not retried here: the sequence
        numbers make the client's retry safe, and the retry re-resolves
        ownership."""
        tags = faults.current_tags()
        owner = self._session_owner(sid)
        order = [owner] + [n for n in self._session_candidates(sid)
                           if n != owner]
        last_err: Optional[BaseException] = None
        for name in order:
            try:
                faults.check("fleet.route", tags=tags,
                             detail=f"session:{op} {sid} -> {name}")
                fut = self._pool.get(name).session(op, **kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — failover
                last_err = e
                self._note_failover(name)
                continue
            self._note_session_owner(sid, name)

            def _scrub(f, _sid=sid):
                # a session that ended another way than a routed finalize
                # (TTL eviction, fencing) must not keep its entry
                try:
                    evicted = isinstance(f.exception(),
                                         _errors.SessionEvictedError)
                except BaseException:  # noqa: BLE001 — CancelledError
                    evicted = False
                if evicted:
                    with self._lock:
                        self._sessions.pop(_sid, None)

            fut.add_done_callback(_scrub)
            return fut
        raise NoHealthyReplicaError(
            f"no replica accepted session {op!r} for {sid!r}: tried "
            f"{order}") from last_err

    def session_append(self, session_id: str, X, Y=None,
                       seq: Optional[int] = None, **kw) -> Future:
        """Route one append to the session's owner; resolves to ``(seq,
        rows)``. Give explicit ``seq`` numbers to retry across a crash:
        duplicates are no-ops on the resuming owner."""
        return self._session_call(
            session_id, "append",
            dict(session_id=session_id, X=X, Y=Y, seq=seq, **kw))

    def session_finalize(self, session_id: str, **kw) -> Future:
        """Route the finalize to the owner and drop the assignment."""
        fut = self._session_call(session_id, "finalize",
                                 dict(session_id=session_id, **kw))

        def _forget(_f):
            with self._lock:
                self._sessions.pop(session_id, None)

        fut.add_done_callback(_forget)
        return fut

    def session_owner(self, session_id: str) -> Optional[str]:
        """The replica the next session verb would land on (resolved, but
        nothing dispatched)."""
        try:
            return self._session_owner(session_id)
        except NoHealthyReplicaError:
            return None

    # -- training jobs -------------------------------------------------

    def _train_terminal(self, e: BaseException) -> bool:
        # errors that end a train job wherever it runs
        return isinstance(e, (_errors.TrainBudgetExhaustedError,
                              _errors.SessionEvictedError,
                              _errors.InvalidParametersError))

    def submit_train_job(self, spec, operands: Optional[dict] = None,
                         *, session_id: Optional[str] = None) -> Future:
        """Submit a preemptible training job to the fleet; the future
        resolves to its terminal result (the trained model dict, or the
        terminal error).

        The job lands on the first healthy replica in the session ring
        order of its id and runs there in slices. If that replica dies or
        refuses mid-job, the router resume-chains: it sends
        ``train("resume")`` to the next candidate, which adopts the
        on-disk session and continues bit-equal from the last acked
        slice. Attempts are bounded at two passes over the pool."""
        sid = str(session_id) if session_id \
            else f"train-{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._counts["train_jobs"] += 1
        return self._train_chain(sid, spec, operands, "submit")

    def _train_chain(self, sid: str, spec, operands,
                     initial_op: str) -> Future:
        client: Future = Future()
        tags = faults.current_tags()
        budget = {"left": 2 * max(1, len(self._pool.names()))}

        def _on_done(f: Future) -> None:
            try:
                result = f.result()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — chain or settle
                if self._train_terminal(e) or budget["left"] <= 0:
                    with self._lock:
                        self._sessions.pop(sid, None)
                    if not client.done():
                        client.set_exception(e)
                    return
                # lost mid-job (dead pipe, drain refusal): the session is
                # on disk, a surviving peer resumes it
                _dispatch("resume", exclude=self.session_owner(sid))
                return
            with self._lock:
                self._sessions.pop(sid, None)
            if not client.done():
                client.set_result(result)

        def _dispatch(op: str, exclude: Optional[str] = None) -> None:
            cands = self._session_candidates(sid)
            order = [n for n in cands if n != exclude]
            if exclude is not None and exclude in cands:
                order.append(exclude)   # last resort: it may be back
            last_err: Optional[BaseException] = None
            for name in order:
                if budget["left"] <= 0:
                    break
                budget["left"] -= 1
                try:
                    faults.check("fleet.route", tags=tags,
                                 detail=f"train:{op} {sid} -> {name}")
                    if op == "submit":
                        fut = self._pool.get(name).train(
                            "submit", spec=spec, operands=operands,
                            session_id=sid)
                    else:
                        fut = self._pool.get(name).train(
                            "resume", session_id=sid)
                        with self._lock:
                            self._counts["train_resumes"] += 1
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:  # noqa: BLE001 — failover
                    last_err = e
                    self._note_failover(name)
                    continue
                self._note_session_owner(sid, name)
                fut.add_done_callback(_on_done)
                return
            with self._lock:
                self._sessions.pop(sid, None)
            if not client.done():
                client.set_exception(NoHealthyReplicaError(
                    f"no replica accepted train {op!r} for {sid!r}: "
                    f"tried {order}") if last_err is None
                    else last_err)

        _dispatch(initial_op)
        return client

    def resume_train_job(self, session_id: str) -> Future:
        """Adopt an orphaned on-disk training job (no live router holds
        its chain) and return a future for its terminal result, resume-
        chaining across replica deaths like :meth:`submit_train_job`."""
        return self._train_chain(str(session_id), None, None, "resume")

    def train_job_status(self, session_id: str) -> dict:
        """Progress snapshot from the job's current owner (raises
        :class:`~libskylark_tpu_torch.base.errors.SessionEvictedError`
        when no replica has it live)."""
        sid = str(session_id)
        owner = self._session_owner(sid)
        fut = self._pool.get(owner).train("status", session_id=sid)
        return fut.result(timeout=30.0)

    # -- operand residency ---------------------------------------------

    def register_operand(self, A, transform=None, dimension=None,
                         **kwargs) -> "_rcache.OperandRef":
        """Pin one operand resident on every replica of the pool: each
        replica pins the same bytes under the same digest (and its sketch
        when ``transform`` is given), so a later ``submit(..., A=ref)``
        routed anywhere skips the operand's upload. Blocks until every
        replica has pinned it. Replicas added later do not inherit pins:
        register again after scaling."""
        futs = [(r.name, r.register_operand(
                    A, transform=transform, dimension=dimension,
                    **kwargs))
                for r in self._pool.replicas()]
        if not futs:
            raise NoHealthyReplicaError(
                "register_operand on an empty pool")
        refs = {name: str(f.result()) for name, f in futs}
        if len(set(refs.values())) != 1:
            # digests do not depend on the transport: a disagreement means
            # the replicas diverged
            raise RuntimeError(
                f"replicas disagree on operand digest: {refs}")
        digest = _rcache.as_ref(next(iter(refs.values()))).digest
        # the host copy ref submits derive against
        self._residency.pin(digest, A)
        return _rcache.OperandRef(digest)

    def unregister_operand(self, ref) -> int:
        """Drop a resident operand from every replica (its pinned sketches
        with it); returns how many replicas held it."""
        ref = str(_rcache.as_ref(ref).digest)
        futs = [r.unregister_operand(ref)
                for r in self._pool.replicas()]
        self._residency.unpin(ref)
        return sum(1 for f in futs if f.result())

    # -- introspection -------------------------------------------------

    def owner_of(self, endpoint: str, **kwargs) -> Optional[str]:
        """The bounded-load owner a request would have affinity for;
        ``None`` on an empty ring. Read-only: a probe never stores an
        assignment or charges ownership."""
        statics = _serve.request_statics(
            endpoint, pad_floor=self._pool.pad_floor, **kwargs)
        return self._affinity_owner(statics, record=False)

    def routable(self) -> list:
        """Names on the ring (DRAINING/STOPPED excluded)."""
        return sorted(self._ring.members())

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            by = dict(sorted(self._by_replica.items()))
            degraded = sorted(self._degraded)
            removed = sorted(self._removed)
        routed = c.get("routed", 0)
        # the network front door's rollup, once the net tier is loaded
        net = None
        if "libskylark_tpu_torch.net.server" in sys.modules:
            try:
                from libskylark_tpu_torch.net.server import net_stats
                net = net_stats()
            except Exception:  # noqa: BLE001 — stats never fail serving
                net = None
        return {
            "net": net,
            "routed": routed,
            "affinity_hit": c.get("affinity_hit", 0),
            "affinity_hit_rate": (
                round(c.get("affinity_hit", 0) / routed, 4)
                if routed else None),
            "failover": c.get("failover", 0),
            "spilled": c.get("spilled", 0),
            "hedged": c.get("hedged", 0),
            "hedge_wins": c.get("hedge_wins", 0),
            "hedge_mismatches": c.get("hedge_mismatches", 0),
            # verify-mode comparisons made (a key of the port only)
            "hedge_verified": c.get("hedge_verified", 0),
            "rate_limited": c.get("rate_limited", 0),
            "coalesced": c.get("coalesced", 0),
            "dist_jobs": c.get("dist_jobs", 0),
            "dist_coordinator": (self._dist_co.stats()
                                 if self._dist_co is not None
                                 else None),
            "single_flight": (self._flights.stats()
                              if self._flights is not None else None),
            "session_handoffs": c.get("session_handoffs", 0),
            "train_jobs": c.get("train_jobs", 0),
            "train_resumes": c.get("train_resumes", 0),
            "sessions_assigned": len(self._sessions),
            "session_epoch": self._epoch,
            "session_epoch_hub_seq": self._epoch_hub_seq,
            "routable": self.routable(),
            "degraded": degraded,
            "removed": removed,
            "by_replica": by,
        }

    def close(self) -> None:
        """Unsubscribe from the health hub and stop the hedger (the pool
        outlives the router; idempotent)."""
        self._unsub()
        hedger, self._hedger = self._hedger, None
        if hedger is not None:
            hedger.stop()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_ROUTERS: "weakref.WeakSet[Router]" = weakref.WeakSet()

_FLEET_KEYS = ("routed", "affinity_hit", "failover", "spilled", "hedged",
               "hedge_wins", "hedge_mismatches", "rate_limited",
               "coalesced", "session_handoffs")


def fleet_stats() -> dict:
    """Routing counters summed over every live router (the ``fleet``
    collector block of ``telemetry.snapshot()``), with the rollup of every
    live :class:`~libskylark_tpu_torch.fleet.autoscale.Autoscaler`."""
    agg = collections.Counter({k: 0 for k in _FLEET_KEYS})
    by_replica = collections.Counter()
    routers = 0
    for router in list(_ROUTERS):
        s = router.stats()
        routers += 1
        for k in _FLEET_KEYS:
            agg[k] += s[k]
        by_replica.update(s["by_replica"])
    out = dict(agg)
    out["routers"] = routers
    out["affinity_hit_rate"] = (
        round(out["affinity_hit"] / out["routed"], 4)
        if out["routed"] else None)
    out["by_replica"] = {name: {"routed": n}
                         for name, n in sorted(by_replica.items())}
    out.update(_LIFETIME.snapshot())
    # autoscale imports the pool, never this module: no cycle
    from libskylark_tpu_torch.fleet import autoscale as _autoscale

    out["autoscale"] = _autoscale.autoscale_stats()
    return out


_telemetry.register_collector("fleet", fleet_stats)


def _iter_routers() -> Iterable[Router]:   # tests and debugging
    return list(_ROUTERS)


__all__ = ["NoHealthyReplicaError", "Router", "fleet_stats"]
