"""Threaded TCP front door over the serve stack (the port of
libskylark_tpu/net/server.py; docs/networking).

``NetServer`` adapts socket connections onto a router: anything with the
executor's verbs, duck-typed: a :class:`~libskylark_tpu_torch.fleet.Router`
over a replica pool on the card, or one
:class:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor` fronted
directly. Every serve endpoint family plus the session / train / operand-residency
verbs crosses the wire as one :mod:`~libskylark_tpu_torch.net.wire`
request frame and comes back as a result or structured-error frame. The server owns *no*
scheduling policy of its own — QoS admission, affinity routing,
single-flight coalescing, and caching all stay in the router it
fronts; the network tier only adds the four things a socket needs:

- **edge admission errors as wire errors** — a
  :class:`~libskylark_tpu_torch.base.errors.TenantQuotaError` or
  ``ServeOverloadedError`` raised at the router front door becomes an
  error frame carrying the stable code and ``retry_after_s``, so a
  remote client backs off exactly like an in-process one;
- **bounded per-connection inflight windows** — the reader thread
  acquires a window slot *before* dispatching and the slot is
  released only after the response bytes are written, so a slow
  reader stops being read from (TCP backpressure) instead of
  buffering responses without bound;
- **disconnect-mid-request detach** — a connection that dies with
  requests inflight abandons its server-side futures without
  cancelling the underlying flight (coalesced followers on other
  connections still get their result; the computation is never
  poisoned);
- **drain discipline at the socket layer** — ``drain()`` (and the
  process SIGTERM path via
  :func:`~libskylark_tpu_torch.resilience.preemption.on_preemption`, which
  runs after the executors settle) sends a GOAWAY frame on every
  live connection, stops accepting, waits for inflight responses to
  flush, then closes — the r11/r15 replica-drain contract, one layer
  down.

Fault sites ``net.accept`` / ``net.read`` / ``net.write`` ride the
chaos table (:mod:`libskylark_tpu_torch.resilience.faults`): a fired fault
aborts one accept, one frame read, or one frame write — the client's
bounded reconnect-retry is what absorbs it (docs/networking).

Where the port departs, each keeping the reference's bytes and verbs:

- **Results are copied to the host on the connection's writer thread.**
  An executor resolves its futures on its worker, with tensors on its
  device; the settle callback only queues the settled future, and the
  writer packs it (one copy off the card, the ``.npy`` encode, the CRC)
  before it writes. A slow peer or a large result never holds the
  executor's worker.
- **A train submit's handle** (the executor returns a
  :class:`~libskylark_tpu_torch.train.jobs.TrainJobHandle`, the
  reference's router a future) is settled through its future.
- **A connection is tracked before its threads start**, so one whose
  peer hangs up at once is counted and forgotten like any other (the
  reference starts them first, and a quick death could leave the dead
  connection in the live set).
- **The ``stats`` verb** answers the router's stats, whose ``net`` block
  a fleet router adds itself as the reference's does; an executor's
  stats do not carry it, so the front door adds it there. Every dict key
  is a string (an executor's histograms are keyed by capacity).
"""

from __future__ import annotations

import collections
import socket
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

from libskylark_tpu_torch import telemetry as _telemetry
from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors as _errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.engine import serve as _serve
from libskylark_tpu_torch.net import wire as _wire
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience import preemption as _preemption
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

_CONNECTIONS = _metrics.gauge(
    "net.connections", "Live TCP connections on the serve front door")
_REQUESTS = _metrics.counter(
    "net.requests", "Wire requests dispatched, by verb")
_WIRE_ERRORS = _metrics.counter(
    "net.wire_errors", "Structured wire error frames sent, by code")
_BYTES_IN = _metrics.counter(
    "net.bytes_in", "Request bytes received on the serve front door")
_BYTES_OUT = _metrics.counter(
    "net.bytes_out", "Response bytes written on the serve front door")
_DRAINS = _metrics.counter(
    "net.drains", "Socket-layer drains (GOAWAY + settle) completed")

#: process-lifetime rollup that survives server teardown (the smoke
#: gates read these after ``close()``)
_LIFETIME = _metrics.LifetimeCounter(
    "net", kinds=("accepted", "refused", "requests", "wire_errors",
                  "bytes_in", "bytes_out", "drains",
                  "disconnected_inflight", "retries_represented"))

_SERVERS: "weakref.WeakSet[NetServer]" = weakref.WeakSet()

#: verbs that run synchronously on the connection's reader thread
#: (control plane: rare, and their router calls are blocking by
#: design) — everything else resolves through a Future
_BLOCKING_VERBS = ("session.open", "train.status", "operand.register",
                   "operand.unregister", "stats", "ping")


def _dist_source(kwargs: dict):
    from libskylark_tpu_torch.dist.plan import ArraySource

    X = kwargs.pop("X")
    Y = kwargs.pop("Y", None)
    return ArraySource(X, Y)


def _wire_safe(value):
    """Results the tagged codec can't express directly, converted to
    their documented wire forms (docs/networking, "Verbs"): a dist
    merge result becomes a plain dict of its public fields. Tensors stay
    as they are; the codec copies each to the host once."""
    if hasattr(value, "SX") and hasattr(value, "coverage"):
        return {
            "SX": value.SX, "SY": value.SY,
            "coverage": float(value.coverage),
            "degraded": bool(value.degraded),
            "missing": [list(r) for r in getattr(value, "missing", ())],
        }
    return value


def _str_keys(value):
    """A stats block with every dict key a string, as JSON spells it
    (an executor's histograms are keyed by capacity)."""
    if isinstance(value, dict):
        return {str(k): _str_keys(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_str_keys(v) for v in value)
    return value


class _Conn:
    """One accepted connection: a reader thread (frame → dispatch), a
    writer thread (bounded response queue → socket), and the inflight
    window between them."""

    def __init__(self, server: "NetServer", sock: socket.socket,
                 peer: Tuple[str, int]):
        self.server = server
        self.sock = sock
        self.peer = peer
        self.alive = True
        self.goaway_sent = False
        self._lock = _locks.make_lock("net.conn")
        self._window = threading.Semaphore(server.inflight_window)
        self._pending: Dict[int, Future] = {}
        # the writer queue is bounded too (belt to the window's
        # braces): even a bug that leaked window slots could not
        # buffer more than 2x window responses
        self._outq: "collections.deque" = collections.deque()
        self._out_cv = threading.Condition(self._lock)
        self._reader = threading.Thread(
            target=self._read_loop, name=f"net-read-{peer}", daemon=True)
        self._writer = threading.Thread(
            target=self._write_loop, name=f"net-write-{peer}",
            daemon=True)

    def start(self) -> None:
        """Start the reader and writer, once the server tracks the
        connection (a peer that hangs up at once must find it tracked)."""
        self._reader.start()
        self._writer.start()

    # -- outbound ------------------------------------------------------

    def enqueue(self, frame: bytes, releases_window: bool) -> None:
        with self._lock:
            if not self.alive:
                if releases_window:
                    self._window.release()
                return
            self._outq.append((frame, releases_window))
            self._out_cv.notify()

    def goaway(self, drain_timeout_s: float) -> None:
        with self._lock:
            if self.goaway_sent or not self.alive:
                return
            self.goaway_sent = True
        self.enqueue(_wire.pack_goaway(drain_timeout_s), False)
        self.server._count("goaways_sent")

    def pending_count(self) -> int:
        """Work the drain must wait for: registered futures plus
        responses not yet fully written to the socket."""
        with self._lock:
            return len(self._pending) + len(self._outq)

    def inflight_count(self) -> int:
        """Registered-but-unsettled requests only. Distinct from
        :meth:`pending_count`: a settled response waiting in the
        write queue is counted by ``responses_sent`` already, so
        adding ``_outq`` here would double-count it in the
        ``pending + responses_sent`` conservation the stats surface
        advertises."""
        with self._lock:
            return len(self._pending)

    def _write_loop(self) -> None:
        while True:
            with self._lock:
                while self.alive and not self._outq:
                    self._out_cv.wait(0.5)
                if not self._outq:
                    return
                # peek, don't pop: the frame must stay visible to
                # pending_count() until sendall returns, or a drain
                # polling for quiescence can close the socket under a
                # mid-flight write (only this thread ever pops)
                frame, releases = self._outq[0]
            if isinstance(frame, _Settled):
                frame = self._frame_of(frame)
            try:
                faults.check("net.write", tags=faults.current_tags(),
                             detail=f"{self.peer} {len(frame)}B")
                self.sock.sendall(frame)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException:  # noqa: BLE001 — peer gone/injected
                if releases:
                    self._window.release()
                self._die()
                return
            with self._lock:
                if self._outq:      # _die may have cleared it
                    self._outq.popleft()
            self.server._count("bytes_out", len(frame))
            _BYTES_OUT.inc(len(frame))
            if releases:
                self._window.release()

    def _frame_of(self, settled: "_Settled") -> bytes:
        """A settled result's frame, packed here on the writer thread:
        the result copied to the host and encoded, or, when it has no
        wire encoding, a structured error frame in its place."""
        try:
            return _wire.pack_result(
                settled.seq, _wire_safe(settled.future.result()))
        except BaseException as e:  # noqa: BLE001 — unencodable result
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            self.server._note_wire_error(e)
            return _wire.pack_error(settled.seq, e)

    # -- inbound -------------------------------------------------------

    def _read_loop(self) -> None:
        try:
            while self.alive:
                header, bodies = _wire.read_frame(self.sock.recv)
                # the fault site fires AFTER a frame actually arrived
                # (a read error on real bytes, before processing) —
                # checking before the blocking read would let an idle
                # connection's reader, descheduled since its last
                # frame, consume a counted fault plan entry minutes
                # after the traffic it was meant to hit
                faults.check("net.read", tags=faults.current_tags(),
                             detail=str(self.peer))
                self._on_frame(header, bodies)
        except _wire.PeerClosed:
            pass
        except (KeyboardInterrupt, SystemExit):
            raise
        except _errors.WireProtocolError as e:
            # a malformed frame means the stream lost sync: report
            # once (unsequenced — we can't trust the frame's seq) and
            # tear down; the client reconnects and re-sends
            self.server._wire_error(self, None, e)
        except BaseException:  # noqa: BLE001 — socket torn down
            pass
        finally:
            self._die()

    def _on_frame(self, header: dict, bodies) -> None:
        self.server._count(
            "bytes_in",
            sum(b.nbytes for b in bodies) if bodies else 0)
        if header.get("t") != _wire.REQ:
            raise _errors.WireProtocolError(
                f"unexpected frame type {header.get('t')!r} from client")
        seq = int(header.get("seq", -1))
        self.server._note_transport_digest(header.get("digest"))
        # window admission BEFORE dispatch: a client that pipelines
        # past the window stops being read until responses flush
        self._window.acquire()
        try:
            verb, kwargs = _wire.unpack_request(header, bodies)
            self.server._dispatch(self, seq, verb, kwargs, header)
        except BaseException as e:  # noqa: BLE001 — reply, don't die
            self._window.release()
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            self.server._wire_error(self, seq, e)

    # -- settle --------------------------------------------------------

    def register(self, seq: int, fut: Future) -> None:
        with self._lock:
            self._pending[seq] = fut

    def settle(self, seq: int, fut: Future) -> None:
        with self._lock:
            self._pending.pop(seq, None)
            dead = not self.alive
        if dead:
            # disconnect-mid-request: the future already ran (or was
            # shared with coalesced followers) — detach, never cancel
            self._window.release()
            return
        exc = fut.exception()
        if exc is not None:
            self.server._wire_error(self, seq, exc, releases_window=True)
            return
        # packed by the writer thread (_frame_of): the caller may be the
        # executor's worker, which must not copy results off the card
        self.server._count("responses_sent")
        self.enqueue(_Settled(seq, fut), True)

    def _die(self) -> None:
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            inflight = len(self._pending)
            self._pending.clear()
            self._outq.clear()
            self._out_cv.notify_all()
        if inflight:
            self.server._count("disconnected_inflight", inflight)
            _LIFETIME.inc("disconnected_inflight", inflight)
        # shutdown-then-close: a bare close() leaves the peer thread
        # of this connection blocked in recv forever
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._forget(self)

    def close(self) -> None:
        self._die()


class NetServer:
    """The TCP serve front door (docs/networking).

    ::

        pool = fleet.ReplicaPool(2, cache=True)
        router = fleet.Router(pool, cache=True)
        srv = net.NetServer(router)          # SKYLARK_NET_* defaults
        host, port = srv.address
        ...
        srv.drain()                          # GOAWAY + settle + close
        srv.close()

    ``port=0`` (the default) binds an ephemeral port — read
    ``srv.address`` after construction. The server registers itself
    with the preemption tier: a process SIGTERM drains the executors
    first (r9/r11), then this server's GOAWAY/settle hook runs inside
    the same teardown, so a remote client never sees the shutdown as
    anything but a drained connection."""

    def __init__(self, router, *, host: Optional[str] = None,
                 port: Optional[int] = None,
                 max_connections: Optional[int] = None,
                 inflight_window: Optional[int] = None,
                 drain_timeout_s: Optional[float] = None):
        self.router = router
        self.host = host if host is not None else _env.NET_HOST.get()
        self.inflight_window = int(
            inflight_window if inflight_window is not None
            else _env.NET_INFLIGHT_WINDOW.get())
        self.max_connections = int(
            max_connections if max_connections is not None
            else _env.NET_MAX_CONNECTIONS.get())
        self.drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else _env.NET_DRAIN_TIMEOUT_S.get())
        bind_port = int(port if port is not None else _env.NET_PORT.get())
        self._lock = _locks.make_lock("net.server")
        self._conns: "weakref.WeakSet[_Conn]" = weakref.WeakSet()
        self._counts: "collections.Counter" = collections.Counter()
        self._recent_digests: "collections.OrderedDict" = (
            collections.OrderedDict())
        self._draining = False
        self._closed = False
        self._listener = socket.create_server(
            (self.host, bind_port), reuse_port=False)
        self._listener.settimeout(0.25)
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]
        self._verbs = self._build_verbs()
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="net-accept", daemon=True)
        self._acceptor.start()
        self._unhook = _preemption.on_preemption(self._on_preempt)
        _SERVERS.add(self)

    # -- accept --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return                      # listener closed (drain)
            try:
                faults.check("net.accept", tags=faults.current_tags(),
                             detail=str(peer))
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException:  # noqa: BLE001 — injected accept fail
                self._count("refused")
                _LIFETIME.inc("refused")
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            with self._lock:
                live = len(self._conns)
                overloaded = (self._draining
                              or live >= self.max_connections)
            if overloaded:
                # refuse with a structured frame, not a silent RST:
                # the client backs off like any other overload
                self._count("refused")
                _LIFETIME.inc("refused")
                try:
                    sock.sendall(_wire.pack_error(
                        None, _serve.ServeOverloadedError(
                            "connection refused: "
                            + ("draining" if self._draining else
                               f"at max_connections={self.max_connections}"
                               ))))
                    sock.close()
                except OSError:
                    pass
                continue
            sock.settimeout(None)
            conn = _Conn(self, sock, peer)
            with self._lock:
                self._conns.add(conn)
                live = len(self._conns)
            conn.start()
            self._count("accepted")
            _LIFETIME.inc("accepted")
            _CONNECTIONS.set(live)

    def _forget(self, conn: _Conn) -> None:
        with self._lock:
            self._conns.discard(conn)
            live = len(self._conns)
        _CONNECTIONS.set(live)

    # -- dispatch ------------------------------------------------------

    def _build_verbs(self) -> dict:
        r = self.router
        verbs: dict = {ep: (lambda kw, tk, _ep=ep:
                            r.submit(_ep, **kw, **tk))
                       for ep in _serve.ENDPOINTS}

        def dist_sketch(kw, tk):
            src = _dist_source(kw)
            return r.submit_dist_sketch(kw.pop("plan"), src, **kw, **tk)

        def dist_lstsq(kw, tk):
            src = _dist_source(kw)
            return r.submit_dist_lstsq(src, **kw, **tk)

        def dist_svd(kw, tk):
            src = _dist_source(kw)
            return r.submit_dist_svd(src, kw.pop("rank"), **kw, **tk)

        verbs["dist_sketch"] = dist_sketch
        verbs["dist_lstsq"] = dist_lstsq
        verbs["dist_svd"] = dist_svd
        verbs["session.open"] = (
            lambda kw, tk: r.open_sketch_session(kw.pop("kind"), **kw))
        verbs["session.append"] = (
            lambda kw, tk: r.session_append(kw.pop("session_id"), **kw))
        verbs["session.finalize"] = (
            lambda kw, tk: r.session_finalize(kw.pop("session_id"),
                                              **kw))
        verbs["train.submit"] = (
            lambda kw, tk: r.submit_train_job(
                kw.pop("spec"), kw.pop("operands", None),
                session_id=kw.pop("session_id", None)))
        verbs["train.resume"] = (
            lambda kw, tk: r.resume_train_job(kw.pop("session_id")))
        verbs["train.status"] = (
            lambda kw, tk: r.train_job_status(kw.pop("session_id")))
        verbs["operand.register"] = (
            lambda kw, tk: r.register_operand(kw.pop("A"), **kw))
        verbs["operand.unregister"] = (
            lambda kw, tk: int(r.unregister_operand(kw.pop("ref"))))
        def stats(kw, tk):
            st = dict(r.stats())
            if st.get("net") is None:
                st["net"] = net_stats()
            return _str_keys(st)

        verbs["stats"] = stats
        verbs["ping"] = lambda kw, tk: "pong"
        return verbs

    def _dispatch(self, conn: _Conn, seq: int, verb: str, kwargs: dict,
                  header: dict) -> None:
        handler = self._verbs.get(verb)
        if handler is None:
            raise _errors.WireProtocolError(f"unknown verb {verb!r}")
        self._count("requests")
        self._count_verb(verb)
        _REQUESTS.inc(verb=verb)
        _LIFETIME.inc("requests")
        transport: dict = {}
        if "tenant" in header:
            transport["tenant"] = header["tenant"]
        if "qos" in header:
            transport["qos_class"] = header["qos"]
        if "deadline_s" in header:
            # remaining-budget semantics: the clock (re)starts at
            # receipt, so network latency never silently eats the
            # budget twice (docs/networking)
            transport["deadline"] = float(header["deadline_s"])
        if "timeout" in header:
            transport["timeout"] = float(header["timeout"])
        trace = header.get("trace") or {}
        rid = trace.get("request_id")
        if rid is not None:
            transport["request_id"] = rid
        parent = None
        if trace.get("trace_id") and trace.get("span_id"):
            parent = _trace.SpanContext(
                str(trace["trace_id"]), str(trace["span_id"]), rid)
        if verb in _BLOCKING_VERBS:
            transport = {}      # control plane: no admission/deadline
        with _trace.span("net.serve", attrs={"verb": verb},
                         parent=parent, request_id=rid):
            result = handler(dict(kwargs), transport)
        if (not isinstance(result, Future)
                and isinstance(getattr(result, "future", None), Future)):
            result = result.future      # an executor's TrainJobHandle
        if isinstance(result, Future):
            conn.register(seq, result)
            result.add_done_callback(
                lambda f, _c=conn, _s=seq: _c.settle(_s, f))
        else:
            conn.settle(seq, _Resolved(result))

    # -- errors / accounting -------------------------------------------

    def _wire_error(self, conn: _Conn, seq: Optional[int],
                    exc: BaseException,
                    releases_window: bool = False) -> None:
        self._note_wire_error(exc)
        conn.enqueue(_wire.pack_error(seq, exc), releases_window)

    def _note_wire_error(self, exc: BaseException) -> None:
        code = _wire.exc_code(exc)
        self._count("wire_errors")
        self._count_code(code)
        _WIRE_ERRORS.inc(code=str(code))
        _LIFETIME.inc("wire_errors")

    def _note_transport_digest(self, digest) -> None:
        """Duplicate transport digests = a client re-presented a
        request after reconnect (observability only — flight adoption
        keys on the router's content digest, which the identical
        bytes re-derive)."""
        if not digest:
            return
        with self._lock:
            if digest in self._recent_digests:
                self._counts["retries_represented"] += 1
                _LIFETIME.inc("retries_represented")
                return
            self._recent_digests[digest] = None
            while len(self._recent_digests) > 4096:
                self._recent_digests.popitem(last=False)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n
        if key == "bytes_in":
            _BYTES_IN.inc(n)
            _LIFETIME.inc("bytes_in", n)
        elif key == "bytes_out":
            _LIFETIME.inc("bytes_out", n)

    def _count_verb(self, verb: str) -> None:
        with self._lock:
            self._counts[f"verb:{verb}"] += 1

    def _count_code(self, code: int) -> None:
        with self._lock:
            self._counts[f"code:{code}"] += 1

    # -- drain / close -------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """GOAWAY every live connection, stop accepting, wait for
        inflight responses to flush (bounded by ``timeout``, default
        ``SKYLARK_NET_DRAIN_TIMEOUT_S``), then close. Returns whether
        quiescence was reached inside the budget. Idempotent."""
        timeout = self.drain_timeout_s if timeout is None else timeout
        with self._lock:
            already = self._draining
            self._draining = True
        if not already:
            try:
                self._listener.close()
            except OSError:
                pass
            for conn in list(self._conns):
                conn.goaway(timeout)
        deadline = time.monotonic() + max(0.0, float(timeout))
        quiesced = False
        while time.monotonic() < deadline:
            if all(c.pending_count() == 0 for c in list(self._conns)):
                quiesced = True
                break
            time.sleep(0.005)
        else:
            quiesced = all(c.pending_count() == 0
                           for c in list(self._conns))
        for conn in list(self._conns):
            conn.close()
        if not already:
            self._count("drains")
            _DRAINS.inc()
            _LIFETIME.inc("drains")
        return quiesced

    def _on_preempt(self) -> None:
        # SIGTERM: the executor drain already settled queued work
        # (hook order — drain_serving runs first), so the remaining
        # job is the socket layer's: GOAWAY, flush, close
        self.drain()

    def close(self) -> None:
        """Tear down without the drain grace (tests; ``drain()`` first
        for the graceful path). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._unhook()
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in list(self._conns):
            conn.close()

    def __enter__(self) -> "NetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- stats ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            conns = list(self._conns)
        by_verb = {k.split(":", 1)[1]: v for k, v in c.items()
                   if k.startswith("verb:")}
        by_code = {k.split(":", 1)[1]: v for k, v in c.items()
                   if k.startswith("code:")}
        return {
            "address": list(self.address),
            "connections_live": len(conns),
            "pending": sum(cn.inflight_count() for cn in conns),
            "accepted": c.get("accepted", 0),
            "refused": c.get("refused", 0),
            "requests": c.get("requests", 0),
            "responses_sent": c.get("responses_sent", 0),
            "wire_errors": c.get("wire_errors", 0),
            "bytes_in": c.get("bytes_in", 0),
            "bytes_out": c.get("bytes_out", 0),
            "goaways_sent": c.get("goaways_sent", 0),
            "drains": c.get("drains", 0),
            "disconnected_inflight": c.get("disconnected_inflight", 0),
            "retries_represented": c.get("retries_represented", 0),
            "draining": self._draining,
            "by_verb": by_verb,
            "by_code": by_code,
        }


class _Settled:
    """A settled future queued for the writer thread, which packs it."""

    __slots__ = ("seq", "future")

    def __init__(self, seq: int, future: Future):
        self.seq = seq
        self.future = future


class _Resolved(Future):
    """A pre-resolved future (uniform settle path for blocking verbs)."""

    def __init__(self, value):
        super().__init__()
        self.set_result(value)


def net_stats() -> dict:
    """Aggregate front-door counters over every live server (the
    ``net`` collector block in ``telemetry.snapshot()`` — rendered as
    ``skylark_net_*`` on the Prometheus surface), plus the
    process-lifetime rollup that survives server teardown."""
    agg = collections.Counter(
        accepted=0, refused=0, requests=0, responses_sent=0,
        wire_errors=0, bytes_in=0, bytes_out=0, goaways_sent=0,
        drains=0, disconnected_inflight=0, retries_represented=0)
    by_verb: "collections.Counter" = collections.Counter()
    by_code: "collections.Counter" = collections.Counter()
    servers = 0
    live = 0
    for srv in list(_SERVERS):
        s = srv.stats()
        servers += 1
        live += s["connections_live"]
        for k in agg:
            agg[k] += s[k]
        by_verb.update(s["by_verb"])
        by_code.update(s["by_code"])
    out = dict(agg)
    out["servers"] = servers
    out["connections_live"] = live
    out["by_verb"] = {k: {"requests": v}
                      for k, v in sorted(by_verb.items())}
    out["by_code"] = {k: {"errors": v}
                      for k, v in sorted(by_code.items())}
    out.update(_LIFETIME.snapshot())
    return out


_telemetry.register_collector("net", net_stats)

__all__ = ["NetServer", "net_stats"]
