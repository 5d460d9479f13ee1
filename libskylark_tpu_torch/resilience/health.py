"""Health-state change hub: executors publish, subscribers listen (the
port of libskylark_tpu/resilience/health.py).

The serve executor's states (``SERVING`` / ``DEGRADED`` / ``DRAINING`` /
``STOPPED``) are pushed, not only polled: :class:`~libskylark_tpu_torch.
engine.serve.MicrobatchExecutor` publishes every transition the moment it
happens (from the flush worker on DEGRADED flips, from ``drain()`` on
DRAINING, from ``shutdown()`` on STOPPED), and a router (ROADMAP A7,
fleet/) or a test subscribes.

The hub is a process-wide list of callbacks, with no filtering and no
history; ``source`` is the object that transitioned. Callback failures
are warned, never raised: a broken subscriber must not stop the drain
that publishes to it. Transitions are also counted on the always-on
``resilience.health_transitions`` counter.
"""

from __future__ import annotations

import warnings
from typing import Callable

from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.telemetry import metrics as _metrics

_LOCK = _locks.make_lock("resilience.health")
_SUBSCRIBERS: "list[Callable[[object, str, str], None]]" = []
_SEQ = 0        # monotonic transition sequence (see transition_seq)

# always on: the transition itself (a drain, a DEGRADED flip) dwarfs
# the counter bump, and snapshots carry the state history
_TRANSITIONS = _metrics.counter(
    "resilience.health_transitions",
    "Executor health-state transitions, by old and new state")


def subscribe(fn: Callable[[object, str, str], None]
              ) -> Callable[[], None]:
    """Register ``fn(source, old_state, new_state)`` to run on every
    published health transition in the process. Returns the
    unregister callable. The callback runs on whatever thread
    published (a flush worker, a drain caller, a SIGTERM teardown
    thread) — it must be cheap and must not call back into the
    publishing executor's submit/drain paths."""
    with _LOCK:
        _SUBSCRIBERS.append(fn)

    def unsubscribe() -> None:
        with _LOCK:
            try:
                _SUBSCRIBERS.remove(fn)
            except ValueError:
                pass

    return unsubscribe


def transition_seq() -> int:
    """Monotonic count of transitions published in this process: any
    view derived from hub events and stamped with this value is stale
    once the value moves."""
    with _LOCK:
        return _SEQ


def publish(source: object, old: str, new: str) -> None:
    """Fan one transition out to every subscriber (the serve layer's
    hook; see :meth:`MicrobatchExecutor._maybe_publish_state`).
    Subscriber failures are contained — publishing happens on drain
    and teardown paths that must complete regardless."""
    global _SEQ
    _TRANSITIONS.inc_always(old=old, new=new)
    with _LOCK:
        _SEQ += 1
        subs = list(_SUBSCRIBERS)
    for fn in subs:
        try:
            fn(source, old, new)
        except Exception as e:  # noqa: BLE001 — never rob the drain
            warnings.warn(
                f"health-state subscriber {fn!r} failed on "
                f"{old}->{new}: {e}", RuntimeWarning, stacklevel=2)


__all__ = ["publish", "subscribe", "transition_seq"]
