"""Preemption-safe shutdown: SIGTERM drains every live serve executor,
then runs the registered checkpoint hooks (the port of
libskylark_tpu/resilience/preemption.py).

A preemptible machine is evicted by a SIGTERM followed, tens of seconds
later, by a SIGKILL. The handler turns the SIGTERM into an orderly
teardown:

1. every live :class:`~libskylark_tpu_torch.engine.serve.
   MicrobatchExecutor` is **drained**: intake stops (new submits raise
   ``ServeOverloadedError``), every queued cohort flushes, every
   in-flight future resolves;
2. every **registered hook** runs (:func:`register_checkpoint` wraps a
   checkpointer's ``save_sync``), on a teardown thread that
   :func:`wait_for_preemption_teardown` joins;
3. the **preemption flag** stays set: host loops poll
   :func:`preemption_requested`.

The handler does not exit the process; that is the host's decision. A
previously installed Python handler of the same signal runs after ours.
Live sessions and training jobs are checkpointed by the executor's drain
(:meth:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor.drain`).
"""

from __future__ import annotations

import signal
import threading
import warnings
from typing import Callable, Optional, Sequence

from libskylark_tpu_torch.base import locks as _locks

_LOCK = _locks.make_lock("resilience.preemption")
_EVENT = threading.Event()
_PREV: dict[int, object] = {}          # signum -> previous handler
_HOOKS: list[Callable[[], None]] = []
_DRAIN_TIMEOUT = 30.0
_DRAIN_SERVING = True
_HANDLING = threading.Event()          # re-entrancy guard
_TEARDOWN: Optional[threading.Thread] = None


def preemption_requested() -> bool:
    """Whether a preemption signal has been received (sticky until
    :func:`reset_preemption`). Host training loops poll this at
    iteration boundaries."""
    return _EVENT.is_set()


def reset_preemption() -> None:
    """Clear the preemption flag (tests; a host that survived a
    spurious SIGTERM)."""
    _EVENT.clear()


def on_preemption(callback: Callable[[], None]) -> Callable[[], None]:
    """Register an arbitrary hook to run during preemption handling
    (after serve drain, in registration order). Returns an unregister
    callable. Hook failures are warned, never raised — one broken hook
    must not rob the others of their drain window."""
    with _LOCK:
        _HOOKS.append(callback)

    def unregister() -> None:
        with _LOCK:
            try:
                _HOOKS.remove(callback)
            except ValueError:
                pass

    return unregister


def register_checkpoint(checkpointer, state_fn: Callable[[], tuple]
                        ) -> Callable[[], None]:
    """Register a final-save hook for a host-loop solver:
    ``state_fn()`` returns ``(step, state, metadata)`` and the hook
    runs ``checkpointer.save_sync(step, state, metadata)`` — blocking
    until the write is durable. Returns the unregister callable."""

    def hook() -> None:
        step, state, metadata = state_fn()
        meta = dict(metadata or {})
        meta.setdefault("preempted", True)
        checkpointer.save_sync(int(step), state, meta)

    return on_preemption(hook)


def drain_serving(timeout: Optional[float] = None) -> int:
    """Drain every live microbatch executor in the process; returns how
    many were drained. Safe with zero executors (the import is lazy so
    a pure-solver process never touches the serve layer)."""
    from libskylark_tpu_torch.engine import serve as _serve

    n = 0
    for ex in list(_serve._EXECUTORS):
        try:
            ex.drain(timeout=timeout if timeout is not None
                     else _DRAIN_TIMEOUT)
            n += 1
        except Exception as e:  # noqa: BLE001 — drain the rest regardless
            warnings.warn(f"preemption drain of {ex!r} failed: {e}",
                          RuntimeWarning, stacklevel=2)
    return n


def _run_handler() -> None:
    if _HANDLING.is_set():      # second SIGTERM while already handling
        return
    _HANDLING.set()
    try:
        if _DRAIN_SERVING:
            drain_serving()
        with _LOCK:
            hooks = list(_HOOKS)
        for hook in hooks:
            try:
                hook()
            except Exception as e:  # noqa: BLE001
                warnings.warn(f"preemption hook {hook!r} failed: {e}",
                              RuntimeWarning, stacklevel=2)
    finally:
        _HANDLING.clear()


def _handle(signum, frame) -> None:
    global _TEARDOWN
    _EVENT.set()
    # The teardown must NOT run on the interrupted thread: CPython
    # delivers signals between bytecodes of whatever frame the main
    # thread is in — which may be inside the serve layer holding the
    # very (non-reentrant) executor lock drain() needs. A synchronous
    # drain here would deadlock until SIGKILL, losing exactly the data
    # the handler exists to save. The dedicated thread blocks only
    # until the main thread releases that lock (microseconds after
    # this handler returns); hosts and tests join via
    # :func:`wait_for_preemption_teardown`.
    #
    # Deliberately lock-free: taking _LOCK here would recreate the
    # held-lock deadlock one level up (the signal may interrupt a frame
    # inside on_preemption/register_checkpoint holding _LOCK). Safe
    # without it: Python signal handlers run only on the main thread
    # and are never re-entered mid-handler, so this is the sole writer
    # of _TEARDOWN.
    if _TEARDOWN is None or not _TEARDOWN.is_alive():
        t = threading.Thread(
            target=_run_handler,
            name="skylark-preemption-teardown", daemon=True)
        _TEARDOWN = t
        t.start()
    prev = _PREV.get(signum)
    if callable(prev):
        prev(signum, frame)


def wait_for_preemption_teardown(timeout: Optional[float] = None) -> bool:
    """Block until the preemption teardown (drain + checkpoint hooks)
    finishes; returns whether it did within ``timeout``. True
    trivially when no preemption has been handled. A preempted host's
    main loop typically calls this before exiting so the final save is
    durable before the process goes away."""
    t = _TEARDOWN          # lock-free read: assignment is atomic (GIL)
    if t is None:
        return True
    t.join(timeout)
    return not t.is_alive()


def install_preemption_handler(
    signals: Sequence[int] = (signal.SIGTERM,),
    drain_timeout: float = 30.0,
    drain_serving_executors: bool = True,
) -> None:
    """Install the preemption handler on ``signals`` (default SIGTERM,
    the eviction protocol of preemptible machines; add ``signal.SIGINT``
    for notebook runs). Idempotent per signal; only callable from the main thread
    (a CPython ``signal.signal`` constraint). A previously-installed
    Python handler is chained after ours."""
    global _DRAIN_TIMEOUT, _DRAIN_SERVING
    _DRAIN_TIMEOUT = float(drain_timeout)
    _DRAIN_SERVING = bool(drain_serving_executors)
    with _LOCK:
        for signum in signals:
            if signum in _PREV:
                continue
            prev = signal.signal(signum, _handle)
            _PREV[signum] = prev


def uninstall_preemption_handler() -> None:
    """Restore the previous handlers and clear the flag (tests)."""
    with _LOCK:
        for signum, prev in list(_PREV.items()):
            try:
                signal.signal(
                    signum,
                    prev if prev is not None else signal.SIG_DFL)
            except (ValueError, TypeError):  # pragma: no cover
                pass
            del _PREV[signum]
    _EVENT.clear()


__all__ = [
    "drain_serving", "install_preemption_handler", "on_preemption",
    "preemption_requested", "register_checkpoint", "reset_preemption",
    "uninstall_preemption_handler", "wait_for_preemption_teardown",
]
