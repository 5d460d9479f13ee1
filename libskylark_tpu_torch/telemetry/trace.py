"""Structured request tracing: spans, contextvar linkage, cross-thread
handoff, and a ``torch.profiler`` range per span (the port of
libskylark_tpu/telemetry/trace.py).

A **span** is one named, timed unit of work with parent/child linkage::

    with telemetry.span("serve.flush", attrs={"capacity": 8}) as sp:
        ...  # children opened inside nest under sp

Linkage is :mod:`contextvars`-based. Threads do not inherit context,
which is right for the serve layer (a flush worker must not parent under
whatever the submitting thread was doing), so crossing a thread is
explicit: capture :func:`get_context` where the request is born, hand
the :class:`SpanContext` over with the work, and :func:`attach` it in the
executing thread (or pass it as ``parent=``).
``MicrobatchExecutor.submit`` does this: the request id minted at submit
rides the queued request into the flush thread and every bisection
retry.

Every real span also enters ``torch.profiler.record_function`` with its
name (where the reference enters its profiler's trace annotation), so a
``serve.flush`` span's range encloses the flush's kernel launches in a
``torch.profiler`` trace, and in nsys under ``emit_nvtx``.

Cost: a disabled :func:`span` is one branch returning a shared no-op
context manager, with no allocation, no contextvar write and no profiler
call. ``force=True`` opens a real span regardless of the global gate.

Finished spans go to a bounded in-memory ring (:func:`finished_spans`)
and to every registered sink (:func:`add_sink`).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional

from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.telemetry import metrics as _metrics

# ---------------------------------------------------------------------------
# ids
# ---------------------------------------------------------------------------

_ids = itertools.count(1)
# full pid + 32 random bits, drawn once: ids stay cheap per span (no
# urandom call on the hot path) yet unique across processes
_ID_PREFIX = f"{os.getpid():x}-{os.urandom(4).hex()}"


def _new_id() -> str:
    return f"{_ID_PREFIX}-{next(_ids):08x}"


def new_request_id() -> str:
    """Mint a request id (the serve layer calls this at submit when the
    caller didn't provide one)."""
    return f"req-{_new_id()}"


# ---------------------------------------------------------------------------
# span + context
# ---------------------------------------------------------------------------


class SpanContext:
    """The portable identity of a span: what crosses threads/processes.
    Carries the trace id, the span id (the future parent), and the
    request id baggage the serve pipeline threads end to end."""

    __slots__ = ("trace_id", "span_id", "request_id")

    def __init__(self, trace_id: str, span_id: str,
                 request_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.request_id = request_id

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"SpanContext(trace={self.trace_id}, span={self.span_id}, "
                f"request={self.request_id})")


class Span:
    """One in-flight (then finished) traced operation."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "request_id",
                 "attrs", "events", "t_wall", "duration_s", "status",
                 "error", "thread")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 request_id: Optional[str], attrs: Optional[dict]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.request_id = request_id
        self.attrs = dict(attrs) if attrs else {}
        self.events: list = []
        self.t_wall = time.time()
        self.duration_s: Optional[float] = None
        self.status = "ok"
        self.error: Optional[str] = None
        self.thread = threading.current_thread().name

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, attrs: Optional[dict] = None) -> None:
        self.events.append({"name": name, "t": time.time(),
                            "attrs": dict(attrs) if attrs else {}})

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.request_id)

    def to_dict(self) -> dict:
        doc = {
            "kind": "span",
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_wall": round(self.t_wall, 6),
            "duration_s": (round(self.duration_s, 9)
                           if self.duration_s is not None else None),
            "status": self.status,
            "thread": self.thread,
        }
        if self.request_id is not None:
            doc["request_id"] = self.request_id
        if self.attrs:
            doc["attrs"] = self.attrs
        if self.events:
            doc["events"] = self.events
        if self.error is not None:
            doc["error"] = self.error
        return doc


# the active span (or attached remote SpanContext) for this context
_CURRENT: "contextvars.ContextVar[Optional[object]]" = \
    contextvars.ContextVar("skylark_telemetry_span", default=None)

_FINISHED: "deque[Span]" = deque(maxlen=2048)
_SINKS: "list[Callable[[Span], None]]" = []
_SINK_LOCK = _locks.make_lock("telemetry.sink")

_span_count = _metrics.counter(
    "telemetry.spans", "Finished telemetry spans, by name and status")


def current_span() -> Optional[Span]:
    cur = _CURRENT.get()
    return cur if isinstance(cur, Span) else None


def get_context() -> Optional[SpanContext]:
    """The calling context's span identity, for explicit cross-thread
    handoff (``None`` outside any span)."""
    cur = _CURRENT.get()
    if isinstance(cur, Span):
        return cur.context()
    if isinstance(cur, SpanContext):
        return cur
    return None


@contextlib.contextmanager
def attach(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Adopt a :class:`SpanContext` captured in another thread: spans
    opened inside the block parent under it (and inherit its request
    id). ``attach(None)`` is a no-op block."""
    if ctx is None:
        yield
        return
    token = _CURRENT.set(ctx)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def _profiler_range(name: str):
    """``torch.profiler.record_function(name)``: the span's range in a
    ``torch.profiler`` trace (and an NVTX range under
    ``torch.autograd.profiler.emit_nvtx``), enclosing the kernel
    launches made inside the span."""
    import torch

    return torch.profiler.record_function(name)


class _NoopSpanCm:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpanCm()


class _SpanCm:
    """Real-span context manager (class, not @contextmanager: the
    serve submit path opens one per request and the generator protocol
    costs ~2x a plain __enter__/__exit__ pair)."""

    __slots__ = ("span", "_token", "_ann", "_t0")

    def __init__(self, name: str, attrs: Optional[dict],
                 parent: Optional[SpanContext],
                 request_id: Optional[str]):
        cur = _CURRENT.get()
        if parent is None and cur is not None:
            parent = cur.context() if isinstance(cur, Span) else cur
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
            if request_id is None:
                request_id = parent.request_id
        else:
            trace_id = _new_id()
            parent_id = None
        self.span = Span(name, trace_id, parent_id, request_id, attrs)
        self._token = None
        self._ann = None
        self._t0 = 0.0

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self.span)
        self._ann = _profiler_range(self.span.name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self.span
        s.duration_s = time.perf_counter() - self._t0
        try:
            self._ann.__exit__(exc_type, exc, tb)
        except Exception:  # pragma: no cover - profiler teardown
            pass
        if exc is not None:
            s.status = "error"
            s.error = repr(exc)
        _CURRENT.reset(self._token)
        _finish(s)
        return False


def span(name: str, attrs: Optional[dict] = None, *,
         parent: Optional[SpanContext] = None,
         request_id: Optional[str] = None,
         force: bool = False):
    """Open a span (context manager yielding the :class:`Span`, or
    ``None`` when telemetry is disabled and ``force`` is not set).

    ``parent`` overrides the ambient contextvar parent (cross-thread
    handoff); ``request_id`` pins the id explicitly (else inherited
    from the parent); ``force`` opens a real span regardless of the
    global gate (for a caller that keeps its own enablement)."""
    if not (force or _metrics.enabled()):
        return _NOOP
    return _SpanCm(name, attrs, parent, request_id)


def add_event(name: str, attrs: Optional[dict] = None) -> None:
    """Append an event to the current span (no-op outside one, or
    disabled) — e.g. a resilience retry attempt recording itself on
    whatever span is executing."""
    cur = current_span()
    if cur is not None:
        cur.add_event(name, attrs)


# ---------------------------------------------------------------------------
# finished-span fanout
# ---------------------------------------------------------------------------


def _finish(s: Span) -> None:
    _FINISHED.append(s)
    _span_count.inc_always(name=s.name, status=s.status)
    with _SINK_LOCK:
        sinks = list(_SINKS)
    for sink in sinks:
        try:
            sink(s)
        except Exception:  # noqa: BLE001 — a sink must never fail work
            pass


def add_sink(fn: Callable[[Span], None]) -> Callable[[], None]:
    """Register a finished-span consumer; returns the unregister
    callable."""
    with _SINK_LOCK:
        _SINKS.append(fn)

    def unregister() -> None:
        with _SINK_LOCK:
            try:
                _SINKS.remove(fn)
            except ValueError:
                pass

    return unregister


def finished_spans(n: Optional[int] = None) -> list:
    """The most recent finished spans (bounded ring; tests/debug)."""
    spans = list(_FINISHED)
    return spans if n is None else spans[-n:]


def clear_finished() -> None:
    _FINISHED.clear()


__all__ = [
    "Span", "SpanContext", "add_event", "add_sink", "attach",
    "clear_finished", "current_span", "finished_spans", "get_context",
    "new_request_id", "span",
]
