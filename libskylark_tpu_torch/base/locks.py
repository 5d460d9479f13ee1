"""Named locks and the runtime lock-order witness (the port of
libskylark_tpu/base/locks.py).

Every lock of the threaded serving layer is made by :func:`make_lock`
(or :func:`make_rlock`) under a stable dotted site name (``"serve.state"``,
``"cache.state"``, ...), the reference's names. Normally the factory
returns a plain ``threading.Lock``: no wrapper, no cost.

With the witness on (``SKYLARK_LOCK_WITNESS=1``, or :func:`enable_witness`
before the locks are made) the factory returns instrumented locks that
record the runtime acquisition order: taking ``B`` while holding ``A``
adds the edge ``A -> B`` to a process-wide graph, and an edge that closes
a cycle is recorded as a violation. Two code paths that take one pair of
locks in opposite orders deadlock only under the right interleaving; the
witness sees the order, which both paths show on every run.

Violations are recorded, not raised where the lock is taken: raising
inside ``acquire`` would leave a half-locked teardown. Call
:func:`check_witness` at a safe point; it raises :class:`LockOrderError`
listing every violation.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from libskylark_tpu_torch.base import env as _env

_FORCED: Optional[bool] = None


def witness_enabled() -> bool:
    """Whether newly constructed locks are instrumented
    (``SKYLARK_LOCK_WITNESS`` or :func:`enable_witness`)."""
    if _FORCED is not None:
        return _FORCED
    return bool(_env.LOCK_WITNESS.get())


def enable_witness(on: bool = True) -> None:
    """Programmatic switch (overrides the environment gate). Only locks
    constructed *after* the switch are instrumented — enable before
    building the executors/pools under test."""
    global _FORCED
    _FORCED = bool(on)


class LockOrderError(RuntimeError):
    """Raised by :func:`check_witness` when the witness recorded at
    least one lock-order violation."""


class _Witness:
    """Process-global acquisition-order recorder. Thread-safe; the
    held-stack is thread-local, the graph is shared."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        # site name -> set of site names acquired while it was held
        self._edges: Dict[str, Set[str]] = {}
        self._violations: List[dict] = []
        self._acquisitions = 0

    # -- per-thread held stack --

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- graph --

    def _reaches(self, src: str, dst: str) -> bool:
        """Whether ``dst`` is reachable from ``src`` in the recorded
        graph (caller holds ``self._lock``)."""
        seen = {src}
        stack = [src]
        while stack:
            for nxt in self._edges.get(stack.pop(), ()):
                if nxt == dst:
                    return True
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    def note_acquire(self, name: str) -> None:
        held = self._held()
        with self._lock:
            self._acquisitions += 1
            for h in held:
                if h == name:
                    continue  # re-entrant RLock hold, not an ordering
                s = self._edges.setdefault(h, set())
                if name in s:
                    continue
                # adding h -> name: a path name ~> h means a cycle —
                # some thread has taken these sites in the other order
                if self._reaches(name, h):
                    self._violations.append({
                        "edge": (h, name),
                        "held": list(held),
                        "thread": threading.current_thread().name,
                    })
                s.add(name)
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- reporting --

    def report(self) -> dict:
        with self._lock:
            return {
                "acquisitions": self._acquisitions,
                "edges": {a: sorted(b) for a, b in
                          sorted(self._edges.items())},
                "violations": [dict(v) for v in self._violations],
            }

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._violations.clear()
            self._acquisitions = 0


_WITNESS = _Witness()


def witness_report() -> dict:
    """The recorded graph: ``{"acquisitions", "edges", "violations"}``
    (edges keyed on lock site names)."""
    return _WITNESS.report()


def reset_witness() -> None:
    """Drop the recorded graph and violations (tests)."""
    _WITNESS.reset()


def check_witness() -> None:
    """Raise :class:`LockOrderError` if any acquisition closed a cycle
    in the recorded lock-order graph."""
    rep = _WITNESS.report()
    if rep["violations"]:
        lines = [
            f"  {a} -> {b} (held {v['held']}, thread {v['thread']})"
            for v in rep["violations"] for a, b in (v["edge"],)
        ]
        raise LockOrderError(
            "lock-order witness recorded %d cycle-closing "
            "acquisition(s):\n%s" % (len(rep["violations"]),
                                     "\n".join(lines)))


class WitnessLock:
    """A ``threading.Lock`` that reports acquire/release to the
    witness. Duck-compatible where the repo needs it: ``with``,
    ``acquire(blocking, timeout)``, ``locked()``, and the
    ``_is_owned`` probe ``threading.Condition`` uses."""

    _inner_factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        self._inner = self._inner_factory()
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            _WITNESS.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._owner = None
        _WITNESS.note_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessLock {self.name!r} at {id(self):#x}>"


class WitnessRLock(WitnessLock):
    """Re-entrant variant."""

    _inner_factory = staticmethod(threading.RLock)

    def __init__(self, name: str):
        super().__init__(name)
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
            _WITNESS.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._count -= 1
        if self._count == 0:
            self._owner = None
        _WITNESS.note_release(self.name)
        self._inner.release()


def make_lock(name: str):
    """A lock for the named acquisition site: a plain
    ``threading.Lock`` normally, a :class:`WitnessLock` under the
    witness. The name is the site's identity in both the runtime
    witness graph — keep it stable and dotted
    (``"<subsystem>.<role>"``)."""
    if witness_enabled():
        return WitnessLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """Re-entrant counterpart of :func:`make_lock`."""
    if witness_enabled():
        return WitnessRLock(name)
    return threading.RLock()


__all__ = [
    "LockOrderError", "WitnessLock", "WitnessRLock", "check_witness",
    "enable_witness", "make_lock", "make_rlock", "reset_witness",
    "witness_enabled", "witness_report",
]
