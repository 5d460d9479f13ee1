"""Blocking TCP client for the serve front door (the port of
libskylark_tpu/net/client.py; docs/networking). Its frames are the
reference's bytes, so it talks to either package's server; results come
back as host numpy arrays, as the wire carries them.

``NetClient`` speaks :mod:`libskylark_tpu_torch.net.wire` to a
:class:`~libskylark_tpu_torch.net.server.NetServer` and exposes the same
future-shaped surface as :class:`~libskylark_tpu_torch.fleet.router.Router`:
``submit(verb, **kwargs)`` returns a
:class:`concurrent.futures.Future` immediately; transport kwargs
(``tenant`` / ``qos_class`` / ``deadline`` / ``timeout``) ride the
frame header, operand kwargs ride the tagged codec.

**Retry is safe by construction, so it is on by default.** A request
frame is deterministic bytes; when the connection dies with requests
inflight the client reconnects (bounded attempts, seeded decorrelated
jitter — the :mod:`~libskylark_tpu_torch.resilience.policy` discipline) and
re-sends *the identical bytes*. The server decodes the identical
kwargs, the router re-derives the identical content digest, and the
single-flight table (docs/caching) either joins the still-running
original flight or hits the result cache — the engine flushes exactly
once no matter how many times the wire tore. Structured server errors
(quota, overload, protocol, deadline) are **never** retried by the
transport loop: they surface as the same typed exception the server
raised, ``retry_after_s`` intact, and the *caller* decides — exactly
the in-process contract.

GOAWAY handling: a draining server announces itself; the client stops
sending on that connection but keeps reading until every inflight
response lands (the server's drain settles them), then transparently
reconnects for the next request. A drain is therefore invisible to
callers — futures resolve, new work finds the next server generation.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors as _errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.net import wire as _wire
from libskylark_tpu_torch.resilience.policy import Deadline
from libskylark_tpu_torch.telemetry import trace as _trace


def _close_socket(sock: socket.socket) -> None:
    """Shutdown-then-close: a bare ``close()`` only drops the fd
    refcount and leaves threads blocked in ``recv`` sleeping forever —
    the shutdown delivers the EOF that wakes them."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _SendFailed(Exception):
    """Internal: a send hit a transport fault and ``_conn_lost`` now
    owns the request's fate (re-send or budget-exhausted failure) —
    the caller must NOT touch the future."""


class _Pending:
    """One unacknowledged request: the exact frame bytes to re-send,
    the caller's future, and the transport-retry ledger."""

    __slots__ = ("frame", "future", "attempts", "gen", "verb")

    def __init__(self, frame: bytes, future: Future, gen: int,
                 verb: str):
        self.frame = frame
        self.future = future
        self.attempts = 0
        self.gen = gen
        self.verb = verb


class NetClient:
    """Blocking client for the serve front door.

    ::

        c = net.NetClient(srv.address, tenant="team-a")
        fut = c.submit("sketch_apply", A=A, transform=S, dimension=dim)
        SA = fut.result(timeout=30)
        c.close()

    ``retry_budget`` transport reconnect-resends per request and
    ``retry_backoff_s`` base backoff default from the
    ``SKYLARK_NET_RETRY_*`` knobs; ``seed`` pins the jitter stream
    (tests)."""

    def __init__(self, address: Tuple[str, int], *,
                 tenant: Optional[str] = None,
                 qos_class: Optional[str] = None,
                 retry_budget: Optional[int] = None,
                 retry_backoff_s: Optional[float] = None,
                 connect_timeout: float = 5.0,
                 seed: Optional[int] = None):
        self.address = (str(address[0]), int(address[1]))
        self.tenant = tenant
        self.qos_class = qos_class
        self.retry_budget = int(
            retry_budget if retry_budget is not None
            else _env.NET_RETRY_BUDGET.get())
        self.retry_backoff_s = float(
            retry_backoff_s if retry_backoff_s is not None
            else _env.NET_RETRY_BACKOFF_S.get())
        self.connect_timeout = float(connect_timeout)
        self._rng = random.Random(
            seed if seed is not None else hash(self.address) & 0xFFFF)
        self._lock = _locks.make_lock("net.client")
        self._sock: Optional[socket.socket] = None
        self._gen = 0
        self._seq = 0
        self._pending: Dict[int, _Pending] = {}
        self._closed = False
        self._goaways = 0
        self._transport_retries = 0

    # -- the future-shaped surface -------------------------------------

    def submit(self, verb: str, /, *, tenant: Optional[str] = None,
               qos_class: Optional[str] = None,
               deadline=None, timeout: Optional[float] = None,
               **kwargs) -> Future:
        """Send one request; returns a Future resolving to the verb's
        result or raising the server's typed exception. ``deadline``
        (seconds or a :class:`~libskylark_tpu_torch.resilience.policy
        .Deadline`) ships as *remaining budget* — the server restarts
        the clock at receipt so the wire hop is never double-counted."""
        if self._closed:
            raise RuntimeError("NetClient is closed")
        deadline_s = None
        if deadline is not None:
            d = Deadline.coerce(deadline)
            deadline_s = max(0.0, d.remaining())
        ctx = _trace.get_context()
        rid = ctx.request_id if ctx is not None else None
        if rid is None:
            rid = _trace.new_request_id()
        trace = {"request_id": rid}
        if ctx is not None:
            trace["trace_id"] = ctx.trace_id
            trace["span_id"] = ctx.span_id
        with self._lock:
            self._seq += 1
            seq = self._seq
        frame = _wire.pack_request(
            verb, kwargs, seq=seq,
            tenant=tenant if tenant is not None else self.tenant,
            qos_class=(qos_class if qos_class is not None
                       else self.qos_class),
            deadline_s=deadline_s, timeout=timeout, trace=trace)
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        pend = _Pending(frame, fut, -1, verb)
        with self._lock:
            self._pending[seq] = pend
        try:
            self._send(seq, pend)
        except _SendFailed:
            pass        # retry machinery owns the request now
        except BaseException as e:  # noqa: BLE001 — fail the future
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            with self._lock:
                self._pending.pop(seq, None)
            fut.set_exception(self._as_comm_error(e))
        return fut

    # convenience wrappers mirroring Router's blocking surface --------

    def ping(self, timeout: float = 5.0) -> str:
        return self.submit("ping").result(timeout=timeout)

    def stats(self, timeout: float = 10.0) -> dict:
        return self.submit("stats").result(timeout=timeout)

    def open_sketch_session(self, kind: str, *, timeout: float = 30.0,
                            **spec_kwargs) -> str:
        return self.submit("session.open", kind=kind,
                           **spec_kwargs).result(timeout=timeout)

    def session_append(self, session_id: str, X, Y=None, *,
                       seq: Optional[int] = None) -> Future:
        kw = {"session_id": session_id, "X": X}
        if Y is not None:
            kw["Y"] = Y
        if seq is not None:
            kw["seq"] = seq
        return self.submit("session.append", **kw)

    def session_finalize(self, session_id: str, **kwargs) -> Future:
        return self.submit("session.finalize", session_id=session_id,
                           **kwargs)

    def register_operand(self, A, *, timeout: float = 30.0, **kwargs):
        """Pin ``A`` resident fleet-wide; returns the
        :class:`~libskylark_tpu_torch.engine.resultcache.OperandRef` whose
        digest string later submits pass as ``A=ref``."""
        return self.submit("operand.register", A=A,
                           **kwargs).result(timeout=timeout)

    def unregister_operand(self, ref, *, timeout: float = 30.0) -> int:
        return self.submit("operand.unregister",
                           ref=ref).result(timeout=timeout)

    def train_job_status(self, session_id: str, *,
                         timeout: float = 30.0) -> dict:
        return self.submit("train.status",
                           session_id=session_id).result(timeout=timeout)

    def client_stats(self) -> dict:
        with self._lock:
            return {
                "address": list(self.address),
                "pending": len(self._pending),
                "generation": self._gen,
                "goaways_seen": self._goaways,
                "transport_retries": self._transport_retries,
                "connected": self._sock is not None,
            }

    # -- transport -----------------------------------------------------

    def _send(self, seq: int, pend: _Pending) -> None:
        try:
            sock, gen = self._ensure_conn()
        except (OSError, _errors.CommunicationError) as e:
            # connect failed: charge this request's budget and let the
            # recovery loop (or budget exhaustion) decide
            pend.gen = self._gen
            self._retry_or_fail(seq, pend, e)
            raise _SendFailed() from e
        pend.gen = gen
        try:
            sock.sendall(pend.frame)
        except OSError as e:
            self._conn_lost(gen)
            raise _SendFailed() from e

    def _ensure_conn(self) -> Tuple[socket.socket, int]:
        with self._lock:
            if self._closed:
                raise RuntimeError("NetClient is closed")
            if self._sock is not None:
                return self._sock, self._gen
            self._gen += 1
            gen = self._gen
        sock = socket.create_connection(
            self.address, timeout=self.connect_timeout)
        sock.settimeout(None)
        with self._lock:
            if self._gen != gen or self._closed:
                sock.close()
                raise _errors.CommunicationError(
                    "connection superseded during connect")
            self._sock = sock
        reader = threading.Thread(
            target=self._read_loop, args=(sock, gen),
            name=f"net-client-read-{gen}", daemon=True)
        reader.start()
        return sock, gen

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        try:
            while True:
                header, bodies = _wire.read_frame(sock.recv)
                t = header.get("t")
                if t == _wire.GOAWAY:
                    self._on_goaway(sock, gen)
                    continue
                seq = header.get("seq")
                if seq is None:
                    # unsequenced error: connection-scoped refusal
                    # (e.g. accepted-then-refused at max_connections)
                    self._fail_gen(gen, _wire.unpack_error(header))
                    return
                with self._lock:
                    pend = self._pending.pop(int(seq), None)
                if pend is None:
                    continue            # late reply to a retried seq
                if t == _wire.RES:
                    try:
                        pend.future.set_result(
                            _wire.unpack_result(header, bodies))
                    except Exception as e:  # noqa: BLE001
                        pend.future.set_exception(e)
                elif t == _wire.ERR:
                    pend.future.set_exception(_wire.unpack_error(header))
                else:
                    pend.future.set_exception(_errors.WireProtocolError(
                        f"unexpected frame type {t!r} from server"))
        except (_wire.PeerClosed, _errors.WireProtocolError, OSError):
            pass
        except Exception:  # noqa: BLE001 — reader must not leak
            pass
        finally:
            self._conn_lost(gen)

    def _on_goaway(self, sock: socket.socket, gen: int) -> None:
        """Server drain announcement: stop routing NEW requests here
        (drop the socket reference — the reader keeps running so
        inflight responses still land), reconnect lazily."""
        with self._lock:
            self._goaways += 1
            if self._gen == gen and self._sock is sock:
                self._sock = None

    def _conn_lost(self, gen: int) -> None:
        """A connection generation died. Re-send every request that
        was inflight on it (identical bytes — digest-keyed idempotency
        makes this safe) up to the per-request retry budget.

        A dead socket is noticed twice — by the sender's failed
        ``sendall`` AND by the reader thread's EOF — so each harvested
        pending is CLAIMED (``gen = -1``) under the lock: the second
        notice matches nothing and cannot double-bill the attempt or
        re-send the frame twice (the duplicate would later wake an
        idle server reader, which is how a chaos plan's fault ends up
        consumed by the wrong connection). Claiming, rather than
        marking the whole generation dead, keeps the late notice
        harmless without suppressing it: the notices race the sender's
        ``p.gen`` stamp, and whichever arrives after the stamp must
        still be able to harvest.
        """
        with self._lock:
            if self._sock is not None and self._gen == gen:
                _close_socket(self._sock)
                self._sock = None
            if self._closed:
                items = []
            else:
                items = [(seq, p) for seq, p in self._pending.items()
                         if p.gen == gen]
                for _, p in items:
                    p.gen = -1      # claimed by this recovery
        retry = []
        for seq, pend in items:
            if self._charge_attempt(seq, pend):
                retry.append((seq, pend))
        if retry:
            t = threading.Thread(
                target=self._recover, args=(retry,),
                name=f"net-client-recover-{gen}", daemon=True)
            t.start()

    def _charge_attempt(self, seq: int, pend: _Pending) -> bool:
        """Bill one transport attempt; fail the future and return
        False once the budget is gone."""
        pend.attempts += 1
        if pend.attempts <= self.retry_budget:
            return True
        with self._lock:
            self._pending.pop(seq, None)
        if not pend.future.done():
            pend.future.set_exception(_errors.CommunicationError(
                f"connection lost; retry budget "
                f"({self.retry_budget}) exhausted for "
                f"{pend.verb!r} seq={seq}"))
        return False

    def _retry_or_fail(self, seq: int, pend: _Pending,
                       cause: BaseException) -> None:
        if self._charge_attempt(seq, pend):
            t = threading.Thread(
                target=self._recover, args=([(seq, pend)],),
                name="net-client-reconnect", daemon=True)
            t.start()

    def _recover(self, items) -> None:
        # decorrelated jitter (policy.RetryPolicy's discipline): the
        # sleep grows with the worst attempt count in the batch, and
        # the jitter is seeded so tests replay byte-identically
        attempt = max(p.attempts for _, p in items)
        base = self.retry_backoff_s * (2.0 ** (attempt - 1))
        delay = min(2.0, base + self._rng.uniform(0, base))
        time.sleep(delay)
        with self._lock:
            self._transport_retries += len(items)
        for seq, pend in items:
            with self._lock:
                if seq not in self._pending:
                    continue            # already settled (late reply)
            try:
                self._send(seq, pend)
            except _SendFailed:
                # the retry machinery re-billed and re-queued (or
                # failed) THIS item and everything already re-sent on
                # the dead generation; keep walking the batch so the
                # not-yet-sent items (still carrying the older dead
                # generation) are not stranded
                continue
            except BaseException as e:  # noqa: BLE001
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                with self._lock:
                    self._pending.pop(seq, None)
                if not pend.future.done():
                    pend.future.set_exception(self._as_comm_error(e))
                return

    def _fail_gen(self, gen: int, exc: BaseException) -> None:
        with self._lock:
            items = [(s, p) for s, p in self._pending.items()
                     if p.gen == gen]
            for s, _ in items:
                self._pending.pop(s, None)
        for _, pend in items:
            pend.future.set_exception(exc)

    @staticmethod
    def _as_comm_error(e: BaseException) -> BaseException:
        if isinstance(e, _errors.SkylarkError):
            return e
        return _errors.CommunicationError(f"{type(e).__name__}: {e}")

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Drop the connection and fail anything still pending (a
        deliberate local close is not a retryable transport fault)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sock = self._sock
            self._sock = None
            items = list(self._pending.items())
            self._pending.clear()
        if sock is not None:
            _close_socket(sock)
        for _, pend in items:
            if not pend.future.done():
                pend.future.set_exception(_errors.CommunicationError(
                    "NetClient closed with requests inflight"))

    def __enter__(self) -> "NetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["NetClient"]
