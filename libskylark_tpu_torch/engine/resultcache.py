"""Content-addressed result caching, single-flight request dedupe and
operand residency for the serve path (the port of
libskylark_tpu/engine/resultcache.py).

Every serve endpoint is a pure function of (operand bytes, key data,
bucket statics): zero padding is exact, filler lanes replicate real
requests, seeds ride explicit key data, and a lane's bits do not depend
on its cohort. So a result is content-addressable: a blake2b digest over
the request's operand bytes and statics names it, and a storm of
identical requests can be served by one flush and a fan-out.

**Digests** (:func:`operand_digest`). blake2b-256 over the statics and a
canonical walk of the request's parts: per array a header (name, dtype,
shape) and the raw buffer. The digest is the reference's byte for byte,
so a fleet that mixes port and reference replicas computes one address.
Host operands (numpy arrays, CPU tensors) hash their buffer in place,
C-contiguous ones with no copy. A CUDA tensor must be copied to the host
to be hashed: that copy is made only when a cache is on (and once when
``register_operand`` digests a CUDA operand), once per operand, and
counted (``cache_stats()["digest_d2h_bytes"]``). A submit by
:class:`OperandRef` hashes the host copy that registration kept, so it
copies nothing. There is no device-side hash: it could not give the
reference's address.

**Single-flight** (:meth:`ResultCache.join_flight`, ``lead_flight``,
``settle_flight``, ``abort_flight``). Concurrent identical requests
coalesce onto one in-flight leader; the leader's outcome, a result or an
exception, reaches every follower. A flight older than
``SKYLARK_CACHE_SINGLE_FLIGHT_TIMEOUT`` stops taking followers.

**Bounded digest->result cache** (:class:`ResultCache`). A byte budget
(``SKYLARK_CACHE_MAX_BYTES``) split across the QoS classes by the
``SKYLARK_CACHE_QUOTA_*`` fractions; a class evicts only its own entries,
oldest first (FIFO), so two replicas fed one request history hold the
same cache.

Two departures from the reference, both forced by the card:

- **Cached values are tensors on the executor's device, never aliased.**
  The reference freezes a result as a read-only host array and hands
  the same array to every hit; torch has no read-only flag. The cache
  stores a compact private copy (:func:`freeze_result`): a served
  result is a view into its whole flush buffer, which would keep
  capacity times the bytes alive behind an entry that counts one lane.
  Every hit and every follower gets its own clone
  (:func:`handout`), made after the producing flush's work finished. The
  byte budget counts device memory.
- **A registered operand is resident on the executor's device**
  (:class:`ResidencyTable`): it is uploaded once, at registration, and a
  flush stacks it by a device-to-device copy. The table also keeps the
  host bytes the operand's digest was taken from, so that a submit by
  reference digests without a device-to-host copy.

The cache does nothing under a DEGRADED executor: the executor checks
its health before touching any cache lock.
"""

from __future__ import annotations

import collections
import hashlib
import time
from concurrent.futures import Future
from typing import Callable, Dict, Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.engine import bucket as bucketing
from libskylark_tpu_torch.qos import tenants as _qtenants
from libskylark_tpu_torch.telemetry import metrics as _metrics

_HITS = _metrics.counter(
    "cache.hits",
    "Result-cache hits (request served from the digest->result "
    "cache, no flush), by priority class")
_MISSES = _metrics.counter(
    "cache.misses",
    "Result-cache misses (request went on to flush or coalesce), by "
    "priority class")
_BYTES_SAVED = _metrics.counter(
    "cache.bytes_saved",
    "Result bytes served without recomputation (cache hits plus "
    "single-flight fan-outs), by priority class")
_EVICTED = _metrics.counter(
    "cache.evicted",
    "Cache entries evicted by the per-class byte quotas, by priority "
    "class")
_SF_COALESCED = _metrics.counter(
    "cache.single_flight_coalesced",
    "Requests coalesced onto an identical in-flight leader, by priority "
    "class")
_RESIDENT = _metrics.gauge(
    "cache.resident_operands",
    "Operands currently pinned by register_operand, by replica")


# ---------------------------------------------------------------------------
# digesting
# ---------------------------------------------------------------------------


def host_bytes(a, d2h: Optional[Callable[[int], None]] = None):
    """``a`` as a host array for hashing: a numpy array as it is, a CPU
    tensor's buffer in place, a CUDA tensor copied to the host (its bytes
    passed to ``d2h``, the caller's count)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.device.type != "cpu":
            a = a.cpu()
            if d2h is not None:
                d2h(a.numel() * a.element_size())
        return a.numpy()
    return np.asarray(a)


def _hash_array(h, name: str, a, d2h=None) -> None:
    """Fold one operand array into the digest: a type and shape header,
    then the raw buffer (C-contiguous buffers through a memoryview, a
    strided view through ``tobytes()``)."""
    a = host_bytes(a, d2h)
    h.update(f"|{name}:{a.dtype.str}:{a.shape}|".encode())
    if a.flags.c_contiguous:
        h.update(a.data)
    else:
        h.update(a.tobytes())


def operand_digest(parts, statics=(), *,
                   d2h: Optional[Callable[[int], None]] = None) -> str:
    """The content address of one request: blake2b-256 over the bucket
    ``statics`` and ``parts``, an ordered sequence of ``(name, value)``
    pairs where each value is an array or tensor, ``bytes``, ``str`` or
    ``None``. Part names are framed, so two part lists cannot collide by
    concatenation. ``d2h`` receives the bytes of each CUDA tensor copied
    to the host to be hashed."""
    h = hashlib.blake2b(digest_size=32)
    h.update(repr(tuple(statics)).encode())
    for name, v in parts:
        if isinstance(v, (bytes, bytearray)):
            h.update(f"|{name}:bytes:{len(v)}|".encode())
            h.update(v)
        elif isinstance(v, str):
            h.update(f"|{name}:str|".encode())
            h.update(v.encode())
        elif v is None:
            h.update(f"|{name}:none|".encode())
        else:
            _hash_array(h, name, v, d2h)
    return h.hexdigest()


class OperandRef(str):
    """A registered operand's handle: the digest string, typed so the
    serve layer can tell a reference from an operand at intake."""

    __slots__ = ()

    @property
    def digest(self) -> str:
        return str(self)


def is_ref(x) -> bool:
    """Whether an intake operand is a residency reference (an
    :class:`OperandRef`, or its forwarded string form ``"ref:<digest>"``)."""
    return isinstance(x, OperandRef) or (
        isinstance(x, str) and x.startswith("ref:"))


def as_ref(x) -> "OperandRef":
    return x if isinstance(x, OperandRef) else OperandRef(
        x[4:] if isinstance(x, str) and x.startswith("ref:") else x)


# ---------------------------------------------------------------------------
# value freezing, hand-out and sizing
# ---------------------------------------------------------------------------


def freeze_result(value):
    """A compact private copy of one result: a tensor cloned into its own
    contiguous storage on its device (a served result may be a view into
    its whole flush buffer), a host array copied and marked read-only,
    containers memberwise (lists become tuples)."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone(memory_format=torch.contiguous_format)
    if isinstance(value, np.ndarray):
        out = np.array(value, copy=True)
        out.setflags(write=False)
        return out
    if isinstance(value, (tuple, list)):
        return tuple(freeze_result(v) for v in value)
    if isinstance(value, dict):
        return {k: freeze_result(v) for k, v in value.items()}
    return value


def handout(value):
    """What one caller receives from a cached or shared value: each
    tensor cloned (a caller's in-place write must not reach the cache or
    another caller), read-only host arrays and scalars as they are."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, tuple):
        return tuple(handout(v) for v in value)
    if isinstance(value, dict):
        return {k: handout(v) for k, v in value.items()}
    return value


def _synchronize(value) -> None:
    """Wait for the clones of ``value``'s CUDA tensors to finish, so a
    future resolves to finished work as a flush's does."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    walk(value)
    for d in devices:
        torch.cuda.current_stream(d).synchronize()


def handout_synced(value):
    """:func:`handout`, then a wait for the clones on the card."""
    out = handout(value)
    _synchronize(out)
    return out


def _fan_out(followers: list, frozen) -> None:
    """Resolve each follower with its own finished clone of ``frozen``."""
    copies = [handout(frozen) for _ in followers]
    _synchronize(copies)
    for f, v in zip(followers, copies):
        f.set_result(v)


#: lookup's miss sentinel (``None`` is a legal result)
MISS = object()


class _Flight:
    """One in-flight single-flight entry: the leader's future, its
    followers, and the frozen value the executor made for them before
    the leader resolved. Mutated only under the cache lock; the fan runs
    outside it."""

    __slots__ = ("key", "cls", "leader", "followers", "t0", "settled",
                 "frozen")

    def __init__(self, key: str, cls: str, leader: Optional[Future]):
        self.key = key
        self.cls = cls
        self.leader = leader
        self.followers: list = []
        self.t0 = time.monotonic()
        self.settled = False
        self.frozen = MISS


class ResultCache:
    """Bounded, class-partitioned digest->result cache with the
    single-flight table (module docstring). One per
    :class:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor`; the
    executor owns the DEGRADED bypass, this class the quotas.

    One leaf lock (``cache.state``) guards the maps; no method resolves a
    future or calls back into the executor while holding it."""

    def __init__(self, name: str = "",
                 max_bytes: Optional[int] = None,
                 quota_fractions: Optional[Dict[str, float]] = None,
                 single_flight_timeout: Optional[float] = None):
        self.name = str(name)
        self.max_bytes = int(max_bytes if max_bytes is not None
                             else _env.CACHE_MAX_BYTES.get())
        fr = {c: _qtenants.cache_quota_fraction(c)
              for c in _qtenants.CLASSES}
        if quota_fractions:
            for c, f in quota_fractions.items():
                fr[_qtenants.coerce_class(c)] = min(max(float(f), 0.0),
                                                    1.0)
        self.budgets = {c: int(self.max_bytes * fr[c])
                        for c in _qtenants.CLASSES}
        self.sf_timeout = float(
            single_flight_timeout if single_flight_timeout is not None
            else _env.CACHE_SINGLE_FLIGHT_TIMEOUT.get())
        self._lock = _locks.make_lock("cache.state")
        # per class, strict insertion order: FIFO eviction
        self._entries: Dict[str, "collections.OrderedDict"] = {
            c: collections.OrderedDict() for c in _qtenants.CLASSES}
        self._bytes: Dict[str, int] = {c: 0 for c in _qtenants.CLASSES}
        self._flights: Dict[str, _Flight] = {}
        self._counts: "collections.Counter" = collections.Counter()
        self._d2h = 0

    # -- lookup / insert ----------------------------------------------

    def note_digest_d2h(self, nbytes: int) -> None:
        """Count bytes copied from the card to the host to be hashed."""
        with self._lock:
            self._d2h += int(nbytes)

    def note_hit(self, cls: str, value) -> None:
        """Count a request served from a pinned result (an operand
        registered with its transform): the hit and bytes-saved ledger of
        a cache hit, no entry touched."""
        cls = _qtenants.coerce_class(cls)
        nbytes = bucketing.result_nbytes(value)
        with self._lock:
            self._counts[("hits", cls)] += 1
            self._counts[("bytes_saved", cls)] += nbytes
        _HITS.inc(**{"class": cls})
        _BYTES_SAVED.inc(nbytes, **{"class": cls})

    def lookup(self, key: str, cls: str):
        """The cached value under ``key`` (shared: hand it out with
        :func:`handout`) or :data:`MISS`. Counts the hit; a miss is
        counted by :meth:`lead_flight`, since a request that coalesces
        onto a leader never flushes. Any class's entry serves any class:
        quotas bound retention, not reads."""
        with self._lock:
            for c in _qtenants.CLASSES:
                ent = self._entries[c].get(key)
                if ent is not None:
                    value, nbytes = ent
                    self._counts[("hits", cls)] += 1
                    self._counts[("bytes_saved", cls)] += nbytes
                    break
            else:
                return MISS
        _HITS.inc(**{"class": cls})
        _BYTES_SAVED.inc(nbytes, **{"class": cls})
        return value

    def put(self, key: str, cls: str, value) -> bool:
        """Insert one frozen value under its digest, charged to ``cls``'s
        quota; evicts the class's own oldest entries until it fits.
        Returns whether it was admitted: one larger than the class's
        whole budget is refused (counted ``uncacheable``)."""
        cls = _qtenants.coerce_class(cls)
        nbytes = bucketing.result_nbytes(value)
        budget = self.budgets.get(cls, 0)
        evicted = 0
        with self._lock:
            if nbytes > budget:
                self._counts[("uncacheable", cls)] += 1
                return False
            d = self._entries[cls]
            if key in d:
                return True
            while self._bytes[cls] + nbytes > budget and d:
                _, (_, old_nb) = d.popitem(last=False)
                self._bytes[cls] -= old_nb
                evicted += 1
            d[key] = (value, nbytes)
            self._bytes[cls] += nbytes
            if evicted:
                self._counts[("evicted", cls)] += evicted
            self._counts[("insertions", cls)] += 1
        if evicted:
            _EVICTED.inc(evicted, **{"class": cls})
        return True

    def invalidate(self, key: str) -> bool:
        """Drop one digest from every class partition."""
        dropped = False
        with self._lock:
            for c in _qtenants.CLASSES:
                ent = self._entries[c].pop(key, None)
                if ent is not None:
                    self._bytes[c] -= ent[1]
                    dropped = True
        return dropped

    def clear(self) -> None:
        """Drop every entry (the device memory goes with them)."""
        with self._lock:
            for c in _qtenants.CLASSES:
                self._entries[c].clear()
                self._bytes[c] = 0

    # -- single-flight -------------------------------------------------

    def join_flight(self, key: str, cls: str) -> Optional[Future]:
        """A follower's future on an identical in-flight request that is
        still fresh, or ``None`` (the caller leads)."""
        with self._lock:
            fl = self._flights.get(key)
            if (fl is None or fl.settled
                    or time.monotonic() - fl.t0 > self.sf_timeout):
                return None
            f: Future = Future()
            fl.followers.append(f)
            self._counts[("single_flight_coalesced", cls)] += 1
            self._counts[("bypassed", cls)] += 1
        _SF_COALESCED.inc(**{"class": cls})
        return f

    def lead_flight(self, key: str, cls: str, leader: Future) -> _Flight:
        """Register ``leader`` as the flight of ``key`` (displacing a
        stale flight, which keeps and settles its own followers); the
        miss is counted here."""
        cls = _qtenants.coerce_class(cls)
        fl = _Flight(key, cls, leader)
        with self._lock:
            self._flights[key] = fl
            self._counts[("misses", cls)] += 1
        _MISSES.inc(**{"class": cls})
        return fl

    def claim(self, key: str, cls: str, leader: Future) -> tuple:
        """The cache lookup, the flight join and the flight lead as one
        step under the cache lock, so that identical concurrent requests
        make one flush: ``("hit", value)`` (shared: hand it out),
        ``("follow", future)`` or ``("lead", flight)`` with ``leader`` as
        the flight's future. Counted as :meth:`lookup`,
        :meth:`join_flight` and :meth:`lead_flight` count."""
        cls = _qtenants.coerce_class(cls)
        with self._lock:
            for c in _qtenants.CLASSES:
                ent = self._entries[c].get(key)
                if ent is not None:
                    value, nbytes = ent
                    self._counts[("hits", cls)] += 1
                    self._counts[("bytes_saved", cls)] += nbytes
                    break
            else:
                value = MISS
            if value is MISS:
                fl = self._flights.get(key)
                if (fl is not None and not fl.settled
                        and time.monotonic() - fl.t0 <= self.sf_timeout):
                    f: Future = Future()
                    fl.followers.append(f)
                    self._counts[("single_flight_coalesced", cls)] += 1
                    self._counts[("bypassed", cls)] += 1
                    kind, got = "follow", f
                else:
                    fl = self._flights[key] = _Flight(key, cls, leader)
                    self._counts[("misses", cls)] += 1
                    kind, got = "lead", fl
        if value is not MISS:
            _HITS.inc(**{"class": cls})
            _BYTES_SAVED.inc(nbytes, **{"class": cls})
            return "hit", value
        (_SF_COALESCED if kind == "follow" else _MISSES).inc(
            **{"class": cls})
        return kind, got

    def settle_flight(self, flight: _Flight, fut: Future,
                      insert: bool = True) -> None:
        """The leader future's done-callback: cache the frozen value (not
        when ``insert`` is false, a DEGRADED executor, or the leader
        failed), then detach the flight, so that no identical request
        finds neither; give every follower its own clone or the leader's
        exception. Futures resolve outside the cache lock."""
        exc = fut.exception()
        frozen = MISS
        if exc is None:
            frozen = flight.frozen
            if frozen is MISS:
                frozen = freeze_result(fut.result())
            if insert:
                self.put(flight.key, flight.cls, frozen)
        with self._lock:
            if flight.settled:
                return
            flight.settled = True
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
            followers = list(flight.followers)
        if exc is not None:
            for f in followers:
                f.set_exception(exc)
            return
        nbytes = bucketing.result_nbytes(frozen)
        if followers:
            with self._lock:
                self._counts[("bytes_saved", flight.cls)] += (
                    nbytes * len(followers))
            _BYTES_SAVED.inc(nbytes * len(followers),
                             **{"class": flight.cls})
            _fan_out(followers, frozen)

    def abort_flight(self, flight: _Flight, exc: BaseException) -> None:
        """Fail a flight whose leader never reached execution (its submit
        raised): the followers fail with the leader's exception."""
        with self._lock:
            if flight.settled:
                return
            flight.settled = True
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
            followers = list(flight.followers)
        for f in followers:
            f.set_exception(exc)

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        """The ``stats()["cache"]`` block: hit, miss and eviction counts
        and byte budgets per class, live entries, single-flight counts,
        and the bytes copied to the host for digests."""
        with self._lock:
            c = dict(self._counts)
            entries = {cls: len(self._entries[cls])
                       for cls in _qtenants.CLASSES}
            nbytes = dict(self._bytes)
            flights = len(self._flights)
            d2h = self._d2h

        def total(kind):
            return sum(n for (k, _cls), n in c.items() if k == kind)

        by_class = {}
        for cls in _qtenants.CLASSES:
            by_class[cls] = {
                "hits": c.get(("hits", cls), 0),
                "misses": c.get(("misses", cls), 0),
                "bytes_saved": c.get(("bytes_saved", cls), 0),
                "evicted": c.get(("evicted", cls), 0),
                "single_flight_coalesced": c.get(
                    ("single_flight_coalesced", cls), 0),
                "insertions": c.get(("insertions", cls), 0),
                "uncacheable": c.get(("uncacheable", cls), 0),
                "entries": entries[cls],
                "bytes": nbytes[cls],
                "budget_bytes": self.budgets[cls],
            }
        hits, misses = total("hits"), total("misses")
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": (round(hits / (hits + misses), 4)
                         if hits + misses else None),
            "bytes_saved": total("bytes_saved"),
            "evicted": total("evicted"),
            "single_flight_coalesced": total("single_flight_coalesced"),
            "insertions": total("insertions"),
            "uncacheable": total("uncacheable"),
            "entries": sum(entries.values()),
            "bytes": sum(nbytes.values()),
            "max_bytes": self.max_bytes,
            "in_flight": flights,
            "digest_d2h_bytes": d2h,
            "by_class": by_class,
        }


def merge_cache_blocks(blocks) -> dict:
    """Cross-executor merge of per-executor ``stats()["cache"]`` blocks:
    counters and byte gauges sum, budgets sum, the hit rate comes from
    the pooled counts."""
    agg: "collections.Counter" = collections.Counter()
    res: "collections.Counter" = collections.Counter()
    by_class: dict = {c: collections.Counter()
                      for c in _qtenants.CLASSES}
    n = 0
    for b in blocks:
        if not b:
            continue
        n += 1
        for k in ("hits", "misses", "bytes_saved", "evicted",
                  "single_flight_coalesced", "insertions",
                  "uncacheable", "entries", "bytes", "max_bytes",
                  "in_flight", "digest_d2h_bytes"):
            agg[k] += b.get(k, 0)
        for cls, blk in b.get("by_class", {}).items():
            by_class[cls].update(blk)
        res.update(b.get("residency") or {})
    out = dict(agg)
    out["caches"] = n
    out["residency"] = dict(res)
    out["hit_rate"] = (
        round(agg["hits"] / (agg["hits"] + agg["misses"]), 4)
        if agg["hits"] + agg["misses"] else None)
    out["by_class"] = {c: dict(by_class[c]) for c in _qtenants.CLASSES}
    return out


class SingleFlight:
    """A flight table without the result cache: concurrent identical
    submits coalesce onto one dispatched leader and nothing is kept
    afterwards (a router's front door, ROADMAP A7). Misses are not
    counted here; coalesced followers are, on the shared instruments."""

    def __init__(self, name: str = "",
                 timeout: Optional[float] = None):
        self.name = str(name)
        self.timeout = float(
            timeout if timeout is not None
            else _env.CACHE_SINGLE_FLIGHT_TIMEOUT.get())
        self._lock = _locks.make_lock("cache.router_flights")
        self._flights: Dict[str, _Flight] = {}
        self._counts: "collections.Counter" = collections.Counter()

    def join(self, key: str, cls: str) -> Optional[Future]:
        """A follower future on an in-flight ``key``, or ``None``."""
        cls = _qtenants.coerce_class(cls)
        with self._lock:
            fl = self._flights.get(key)
            if (fl is None or fl.settled
                    or time.monotonic() - fl.t0 > self.timeout):
                return None
            f: Future = Future()
            fl.followers.append(f)
            self._counts[("coalesced", cls)] += 1
        _SF_COALESCED.inc(**{"class": cls})
        return f

    def lead(self, key: str, cls: str) -> _Flight:
        """Register the caller as ``key``'s leader."""
        cls = _qtenants.coerce_class(cls)
        fl = _Flight(key, cls, None)
        with self._lock:
            self._flights[key] = fl
            self._counts[("led", cls)] += 1
        return fl

    def settle(self, flight: _Flight, fut: Future) -> None:
        """Fan the leader's outcome to every follower, each with its own
        copy; nothing is cached."""
        with self._lock:
            if flight.settled:
                return
            flight.settled = True
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
            followers = list(flight.followers)
        if not followers:
            return
        exc = fut.exception()
        if exc is not None:
            for f in followers:
                f.set_exception(exc)
            return
        frozen = freeze_result(fut.result())
        nbytes = bucketing.result_nbytes(frozen)
        with self._lock:
            self._counts[("bytes_saved", flight.cls)] += (
                nbytes * len(followers))
        _BYTES_SAVED.inc(nbytes * len(followers),
                         **{"class": flight.cls})
        _fan_out(followers, frozen)

    def abort(self, flight: _Flight, exc: BaseException) -> None:
        """Fail a flight whose leader's dispatch raised."""
        with self._lock:
            if flight.settled:
                return
            flight.settled = True
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
            followers = list(flight.followers)
        for f in followers:
            f.set_exception(exc)

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            flights = len(self._flights)

        def total(kind):
            return sum(n for (k, _cls), n in c.items() if k == kind)

        return {
            "coalesced": total("coalesced"),
            "led": total("led"),
            "bytes_saved": total("bytes_saved"),
            "in_flight": flights,
            "by_class": {
                cls: {"coalesced": c.get(("coalesced", cls), 0),
                      "led": c.get(("led", cls), 0),
                      "bytes_saved": c.get(("bytes_saved", cls), 0)}
                for cls in _qtenants.CLASSES},
        }


# ---------------------------------------------------------------------------
# operand residency
# ---------------------------------------------------------------------------


class ResidencyTable:
    """Digest -> pinned operand table behind ``register_operand``. A pin
    holds the operand as a tensor on ``device`` (uploaded once, counted in
    ``upload_bytes``) and the host bytes its digest was taken from, and,
    when registered with a transform, the operand's sketch under the
    request's digest. Pins are explicit state, never evicted by the
    quotas; :meth:`unpin` drops an operand and its pinned results."""

    def __init__(self, name: str = "", device=None):
        self.name = str(name)
        self.device = torch.device(device) if device is not None else None
        self._lock = _locks.make_lock("cache.residency")
        # digest -> (host bytes, the resident tensor)
        self._pins: Dict[str, tuple] = {}
        # request digest -> pinned result, and operand digest -> the
        # request digests it owns (dropped with it)
        self._results: Dict[str, object] = {}
        self._owned: Dict[str, list] = {}
        self._uploads = 0
        self._upload_bytes = 0

    def pin(self, digest: str, operand, replace: bool = False,
            resident: Optional[torch.Tensor] = None) -> str:
        """Pin ``operand`` (host bytes: a numpy array or a CPU tensor's
        buffer) under ``digest``, resident on the table's device: uploaded
        from ``operand``, or copied from ``resident`` (the same values on
        a device) on the device. The same bytes again are a no-op; other
        bytes under a held digest raise unless ``replace``."""
        host = freeze_result(host_bytes(operand))
        with self._lock:
            held = self._pins.get(digest)
            if held is not None and not replace:
                if (held[0].shape != host.shape
                        or held[0].dtype != host.dtype
                        or not np.array_equal(held[0], host)):
                    raise ValueError(
                        f"operand digest {digest[:12]}… is already "
                        f"pinned to different bytes")
                return digest
        device = self.device if self.device is not None else "cpu"
        if resident is not None:
            dev = resident.detach().to(device, copy=True)
            uploaded = 0
        else:
            dev = torch.from_numpy(host.copy()).to(device)
            uploaded = dev.numel() * dev.element_size()
        with self._lock:
            self._pins[digest] = (host, dev)
            if uploaded:
                self._uploads += 1
                self._upload_bytes += uploaded
            n = len(self._pins)
        _RESIDENT.set(float(n), replica=self.name)
        return digest

    def pin_result(self, rdigest: str, value,
                   owner: Optional[str] = None) -> None:
        """Pin one result under its full request digest (a registered
        operand's sketch): a later submit of that digest resolves from
        here before the cache is consulted. ``owner`` ties it to an
        operand digest, so that unpinning the operand drops it."""
        with self._lock:
            self._results[rdigest] = freeze_result(value)
            if owner is not None:
                self._owned.setdefault(owner, []).append(rdigest)

    def result(self, rdigest: str):
        with self._lock:
            return self._results.get(rdigest)

    def _held(self, digest: str) -> tuple:
        with self._lock:
            v = self._pins.get(digest)
        if v is None:
            raise KeyError(
                f"no resident operand for digest {digest[:12]}… on "
                f"{self.name or 'this executor'}: register_operand it "
                f"here")
        return v

    def resolve(self, digest: str) -> torch.Tensor:
        """The resident tensor of a pinned operand."""
        return self._held(digest)[1]

    def host(self, digest: str) -> np.ndarray:
        """The pinned operand's host bytes (read-only), what its digest
        and a request digest by reference hash."""
        return self._held(digest)[0]

    def unpin(self, digest: str) -> bool:
        with self._lock:
            found = self._pins.pop(digest, None) is not None
            for rd in self._owned.pop(digest, ()):
                self._results.pop(rd, None)
            n = len(self._pins)
        _RESIDENT.set(float(n), replica=self.name)
        return found

    def digests(self) -> list:
        with self._lock:
            return sorted(self._pins)

    def stats(self) -> dict:
        with self._lock:
            return {
                "resident_operands": len(self._pins),
                "pinned_results": len(self._results),
                "resident_bytes": int(sum(
                    v[1].numel() * v[1].element_size()
                    for v in self._pins.values())),
                "uploads": self._uploads,
                "upload_bytes": self._upload_bytes,
            }


__all__ = [
    "OperandRef", "ResidencyTable", "ResultCache", "SingleFlight",
    "as_ref", "freeze_result", "handout", "is_ref", "MISS",
    "merge_cache_blocks", "operand_digest",
]
