"""Retry/backoff policies and deadline budgets (the port of
libskylark_tpu/resilience/policy.py).

:class:`Deadline`
    A monotonic budget that threads through call stacks: a caller makes
    ``Deadline.after(30)`` once, and every layer below derives its
    timeouts from ``remaining()`` instead of stacking its own. The serve
    executor's ``submit(deadline=...)`` takes one.

:class:`RetryPolicy`
    Retry with exponential backoff and decorrelated jitter (each delay
    drawn from ``uniform(base, prev * multiplier)``, capped), per-attempt
    timeouts, a total deadline and an error-class predicate over
    :mod:`libskylark_tpu_torch.base.errors`. A ``seed`` makes the jitter
    sequence deterministic: the same seed gives the reference's delays.

Both are host-side control flow; neither touches the device.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Iterator, Optional, Sequence, Union

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

# every retry attempt under any policy bumps this counter, always: a
# retry already paid for a failure and a backoff sleep
_RETRIES = _metrics.counter(
    "resilience.retries",
    "Retry attempts under RetryPolicy, by error class")


class DeadlineExceededError(errors.SkylarkError, TimeoutError):
    """A total deadline budget was exhausted before the work completed."""


class Deadline:
    """A monotonic point in time a unit of work must finish by.

    ``Deadline.after(30)`` starts a 30-second budget; ``remaining()``
    is what's left (``inf`` for the unbounded deadline), ``expired``
    whether it ran out, and ``check()`` raises
    :class:`DeadlineExceededError` so deep call sites can bail without
    plumbing a boolean back up. A ``Deadline`` is intended to be
    created once at the top of a request and passed *down* — every
    layer below derives attempt timeouts from one shared budget.
    """

    __slots__ = ("_t",)

    def __init__(self, seconds: Optional[float] = None):
        self._t = None if seconds is None else time.monotonic() + float(seconds)

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        return cls(seconds)

    @classmethod
    def coerce(cls, obj: Union[None, int, float, "Deadline"]
               ) -> Optional["Deadline"]:
        """``None`` → ``None``; a number → ``Deadline.after(number)``;
        a ``Deadline`` passes through (the submit-API convenience)."""
        if obj is None or isinstance(obj, Deadline):
            return obj
        return cls(float(obj))

    def remaining(self) -> float:
        if self._t is None:
            return math.inf
        return self._t - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "") -> None:
        if self.expired:
            raise DeadlineExceededError(
                f"deadline exceeded{': ' + what if what else ''}")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        r = self.remaining()
        return f"Deadline(remaining={'inf' if r == math.inf else round(r, 3)})"


#: Error classes a policy retries by default: the taxonomy's transport
#: and resource failures plus their stdlib counterparts. Logic errors
#: (InvalidParametersError, UnsupportedError, ...) never retry — they
#: would fail identically forever.
TRANSIENT_ERRORS = (
    errors.IOError_,
    errors.CommunicationError,
    errors.AllocationError,
    ConnectionError,
    TimeoutError,
    OSError,
)


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with decorrelated jitter over an error-class
    predicate.

    ``retry_on`` is either a tuple of exception classes or a predicate
    ``exc -> bool``. ``seed`` pins the jitter stream (deterministic
    replay); ``sleep`` is injectable so tests run without waiting.
    ``attempt_timeout``/``timeout_arg`` wire per-attempt timeouts into
    callables that accept one (e.g. ``urlopen(timeout=...)``): each
    attempt gets ``min(attempt_timeout, deadline.remaining())``.
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 3.0
    jitter: str = "decorrelated"          # "decorrelated" | "full" | "none"
    retry_on: Union[Sequence[type], Callable] = TRANSIENT_ERRORS
    seed: Optional[int] = None
    attempt_timeout: Optional[float] = None
    timeout_arg: Optional[str] = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise errors.InvalidParametersError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.jitter not in ("decorrelated", "full", "none"):
            raise errors.InvalidParametersError(
                f"jitter must be decorrelated|full|none, got {self.jitter!r}")

    # -- predicate --

    def retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, DeadlineExceededError):
            # budget exhaustion means STOP: it inherits TimeoutError
            # (an OSError) so every transient predicate would otherwise
            # match it and retry precisely when the deadline said not to
            return False
        if callable(self.retry_on):
            return bool(self.retry_on(exc))
        return isinstance(exc, tuple(self.retry_on))

    # -- backoff schedule --

    def delays(self) -> Iterator[float]:
        """The (possibly seeded, hence replayable) backoff sequence."""
        rng = random.Random(self.seed)
        prev = self.base_delay
        k = 0
        while True:
            if self.jitter == "none":
                d = min(self.max_delay, self.base_delay * self.multiplier ** k)
            elif self.jitter == "full":
                cap = min(self.max_delay,
                          self.base_delay * self.multiplier ** k)
                d = rng.uniform(0.0, cap)
            else:  # decorrelated
                d = min(self.max_delay,
                        rng.uniform(self.base_delay, prev * self.multiplier))
                prev = d
            k += 1
            yield d

    # -- execution --

    def call(self, fn: Callable, *args,
             deadline: Union[None, float, Deadline] = None,
             on_retry: Optional[Callable] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy.

        Retryable failures back off and re-attempt up to
        ``max_attempts`` within the ``deadline`` budget; the final
        failure re-raises with the attempt count appended to its trace
        (when it's a :class:`~libskylark_tpu.base.errors.SkylarkError`).
        ``on_retry(attempt, exc, delay)`` observes each retry (logging,
        counters). Non-retryable errors propagate immediately.
        """
        deadline = Deadline.coerce(deadline)
        delays = self.delays()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if deadline is not None and deadline.expired:
                raise DeadlineExceededError(
                    f"retry budget exhausted after {attempt - 1} "
                    f"attempt(s)") from last
            kw = kwargs
            if self.timeout_arg:
                t = self.attempt_timeout
                if deadline is not None:
                    rem = max(deadline.remaining(), 0.001)
                    t = rem if t is None else min(t, rem)
                if t is not None:
                    kw = dict(kwargs)
                    kw[self.timeout_arg] = t
            try:
                return fn(*args, **kw)
            except BaseException as e:  # noqa: BLE001 — predicate decides
                if not self.retryable(e) or attempt == self.max_attempts:
                    if isinstance(e, errors.SkylarkError):
                        e.append_trace(
                            f"RetryPolicy: attempt {attempt}/"
                            f"{self.max_attempts}")
                    raise
                last = e
                d = next(delays)
                if deadline is not None:
                    d = min(d, max(deadline.remaining(), 0.0))
                _RETRIES.inc_always(error=type(e).__name__)
                # the retry-attempt event lands on whatever span is
                # executing and carries that span's id explicitly
                cur = _trace.current_span()
                if cur is not None:
                    cur.add_event("resilience.retry", {
                        "attempt": attempt,
                        "error": type(e).__name__,
                        "delay_s": round(d, 4),
                        "span_id": cur.span_id,
                    })
                if on_retry is not None:
                    on_retry(attempt, e, d)
                if d > 0:
                    self.sleep(d)
        raise AssertionError("unreachable")  # pragma: no cover

    def __call__(self, fn: Callable) -> Callable:
        """Decorator form: ``@policy`` wraps ``fn`` in :meth:`call`."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped
