"""Tenant model of the multi-tenant QoS layer (the port of
libskylark_tpu/qos/tenants.py).

- a **priority class**, ``interactive`` / ``standard`` / ``best_effort``
  (:data:`CLASSES`, the tuple ``base.env.QOS_CLASSES``), with a
  weighted-fair scheduling weight, a DEGRADED-shed fraction, a
  queue-pressure admission bound and a p99 latency SLO
  (:class:`ClassPolicy`);
- a **tenant**, a named principal mapped to one class and optionally
  rate-limited by a deterministic token bucket (:class:`TokenBucket`): a
  request over quota is refused at admission with
  :class:`~libskylark_tpu_torch.base.errors.TenantQuotaError` and never
  queued;
- a **registry** (:class:`TenantRegistry`) that resolves ``tenant=`` to
  ``(tenant, class)`` and charges the bucket. Unknown tenants and
  requests without one land in ``SKYLARK_QOS_DEFAULT_CLASS``, unlimited.

An executor built without ``tenants=`` resolves against the
process-wide registry (:func:`get_registry`). A request that arrives
with ``qos_class=`` was admitted by a front door already (a router,
ROADMAP A7) and is not charged again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors as _errors
from libskylark_tpu_torch.base import locks as _locks

#: Priority classes, most- to least-protected (shed order is the
#: reverse). The tuple object is ``base/env.QOS_CLASSES`` — the env
#: parser and this module cannot disagree.
CLASSES: Tuple[str, ...] = _env.QOS_CLASSES

INTERACTIVE, STANDARD, BEST_EFFORT = CLASSES

#: Weighted-fair scheduling weights (deficit quanta per round). The
#: ratios — not the absolute values — are the contract: under
#: sustained full backlog the classes drain ~8:4:1.
DEFAULT_WEIGHTS: Dict[str, int] = {
    INTERACTIVE: 8, STANDARD: 4, BEST_EFFORT: 1,
}

#: Queue-pressure admission bound per class, as a fraction of
#: ``max_queue`` — applied even when the executor is healthy.
#: best_effort stops admitting at half the queue so a best-effort
#: storm can never fill the bound against higher classes; interactive
#: and standard keep the full bound (and the backpressure wait).
PRESSURE_FRACTIONS: Dict[str, float] = {
    INTERACTIVE: 1.0, STANDARD: 1.0, BEST_EFFORT: 0.5,
}


def default_class() -> str:
    """``SKYLARK_QOS_DEFAULT_CLASS`` (typo degrades to standard)."""
    return _env.QOS_DEFAULT_CLASS.get()


def shed_fraction(cls: str) -> float:
    """The class's DEGRADED-shed fraction of ``max_queue`` (env-
    tunable; interactive > standard > best_effort by default, which
    IS the shed ordering: the smaller the fraction, the earlier the
    class sheds)."""
    if cls == INTERACTIVE:
        return float(_env.QOS_SHED_INTERACTIVE.get())
    if cls == BEST_EFFORT:
        return float(_env.QOS_SHED_BEST_EFFORT.get())
    return float(_env.QOS_SHED_STANDARD.get())


def cache_quota_fraction(cls: str) -> float:
    """The class's share of the result-cache byte budget
    (``SKYLARK_CACHE_QUOTA_*``).
    Quotas are hard partitions — insertion into one class evicts only
    that class's own entries — so the fractions ARE the isolation
    contract: a best_effort storm can fill at most its own share and
    never displaces an interactive working set. Values clamp to
    [0, 1]; a non-positive fraction disables caching for the class."""
    if cls == INTERACTIVE:
        f = _env.CACHE_QUOTA_INTERACTIVE.get()
    elif cls == BEST_EFFORT:
        f = _env.CACHE_QUOTA_BEST_EFFORT.get()
    else:
        f = _env.CACHE_QUOTA_STANDARD.get()
    return min(max(float(f), 0.0), 1.0)


def slo_seconds(cls: str) -> float:
    """The class's p99 latency SLO in seconds (env-tunable)."""
    if cls == INTERACTIVE:
        ms = _env.QOS_SLO_INTERACTIVE_MS.get()
    elif cls == BEST_EFFORT:
        ms = _env.QOS_SLO_BEST_EFFORT_MS.get()
    else:
        ms = _env.QOS_SLO_STANDARD_MS.get()
    return max(float(ms), 0.0) / 1000.0


def coerce_class(cls: Optional[str]) -> str:
    """A valid class name (``None``/unknown degrade to the default
    class — the repo's typo-degrades convention, so a misspelled
    class never drops a request)."""
    if cls is None:
        return default_class()
    cls = str(cls).strip().lower()
    return cls if cls in CLASSES else default_class()


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """One priority class's scheduling contract."""

    name: str
    weight: int
    shed_fraction: float      # of max_queue, under DEGRADED
    pressure_fraction: float  # of max_queue, always
    slo_s: float              # p99 latency target


def class_policy(cls: str) -> ClassPolicy:
    """The live (env-resolved) policy of one class."""
    cls = coerce_class(cls)
    return ClassPolicy(
        name=cls,
        weight=DEFAULT_WEIGHTS[cls],
        shed_fraction=shed_fraction(cls),
        pressure_fraction=PRESSURE_FRACTIONS[cls],
        slo_s=slo_seconds(cls),
    )


class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/second refill up to
    ``burst`` capacity; each admission costs one token. All state
    transitions are pure functions of the observation times handed to
    :meth:`try_acquire` (tests drive a manual clock; production passes
    ``time.monotonic()``), so the same arrival schedule always admits
    the same subset — the determinism the property battery pins."""

    __slots__ = ("rate", "burst", "_tokens", "_stamp", "_lock")

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise _errors.InvalidParametersError(
                f"token-bucket rate must be positive, got {rate}")
        self.rate = float(rate)
        self.burst = (float(burst) if burst is not None
                      else 2.0 * self.rate)
        if self.burst < 1.0:
            self.burst = 1.0
        self._tokens = self.burst      # starts full
        self._stamp: Optional[float] = None
        self._lock = _locks.make_lock("qos.bucket")

    def try_acquire(self, now: Optional[float] = None
                    ) -> Tuple[bool, float]:
        """``(admitted, retry_after_s)``: spend one token if available;
        otherwise the deterministic seconds until one refills."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._stamp is not None and now > self._stamp:
                self._tokens = min(
                    self.burst,
                    self._tokens + (now - self._stamp) * self.rate)
            if self._stamp is None or now > self._stamp:
                self._stamp = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True, 0.0
            return False, (1.0 - self._tokens) / self.rate

    def available(self) -> float:
        with self._lock:
            return self._tokens


@dataclasses.dataclass
class Tenant:
    """One registered principal: name, class, optional rate limit."""

    name: str
    priority_class: str = STANDARD
    bucket: Optional[TokenBucket] = None


class TenantRegistry:
    """Thread-safe name -> :class:`Tenant` map with admission.

    ::

        reg = qos.get_registry()
        reg.register("search-ui", "interactive")
        reg.register("bulk-etl", "best_effort", rate=100.0)
        tenant, cls = reg.resolve("search-ui")
        reg.admit("bulk-etl")        # raises TenantQuotaError over quota
    """

    def __init__(self):
        self._lock = _locks.make_lock("qos.registry")
        self._tenants: Dict[str, Tenant] = {}

    def register(self, name: str, priority_class: str = STANDARD, *,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None) -> Tenant:
        """Register (or re-register) a tenant. ``rate`` is requests/
        second (``None`` consults ``SKYLARK_QOS_RATE_DEFAULT``; both
        unset = unlimited); ``burst`` is the bucket capacity
        (``None`` consults ``SKYLARK_QOS_BURST_DEFAULT``, else 2x
        rate). Re-registering replaces the tenant — including a fresh
        token bucket. An *explicit* ``rate=0`` is an error
        (:class:`~libskylark_tpu.base.errors.InvalidParametersError`
        from the bucket — a zero rate is neither a limit nor
        unlimited; refuse rather than guess); a non-positive env
        DEFAULT degrades to unlimited (the typo convention)."""
        cls = coerce_class(priority_class)
        if rate is None:
            rate = _env.QOS_RATE_DEFAULT.get()
            if rate is not None and rate <= 0:
                rate = None          # env zero/typo = no default limit
        if burst is None:
            burst = _env.QOS_BURST_DEFAULT.get()
        bucket = TokenBucket(rate, burst) if rate is not None else None
        t = Tenant(name=str(name), priority_class=cls, bucket=bucket)
        with self._lock:
            self._tenants[t.name] = t
        return t

    def unregister(self, name: str) -> None:
        with self._lock:
            self._tenants.pop(str(name), None)

    def get(self, name: str) -> Optional[Tenant]:
        with self._lock:
            return self._tenants.get(str(name))

    def resolve(self, tenant: Optional[str]) -> Tuple[str, str]:
        """``(tenant_name, class)`` for a submit's ``tenant=``:
        registered tenants carry their class, unknown/anonymous ones
        land in the default class."""
        if tenant is None:
            return "", default_class()
        t = self.get(tenant)
        if t is None:
            return str(tenant), default_class()
        return t.name, t.priority_class

    def admit(self, tenant: Optional[str],
              now: Optional[float] = None) -> Tuple[str, str]:
        """Resolve AND charge the tenant's token bucket. Raises
        :class:`~libskylark_tpu.base.errors.TenantQuotaError` when the
        bucket is empty (the request must be refused, not queued)."""
        name, cls = self.resolve(tenant)
        t = self.get(name) if name else None
        if t is not None and t.bucket is not None:
            ok, retry = t.bucket.try_acquire(now)
            if not ok:
                raise _errors.TenantQuotaError(
                    f"tenant {name!r} over admission quota "
                    f"({t.bucket.rate:g} req/s); retry in "
                    f"{retry:.3f}s", tenant=name, retry_after_s=retry)
        return name, cls

    def accounting_name(self, tenant: Optional[str]) -> str:
        """The label under which a request's tenant is ACCOUNTED:
        the tenant's name when registered, else ``""`` (the anonymous
        bucket). Metric label sets and per-tenant stats key on this,
        never on the raw caller string — otherwise a client passing a
        unique ``tenant=`` per request (a user id, a request id)
        would grow the label dictionaries without bound."""
        if not tenant:
            return ""
        return tenant if self.get(tenant) is not None else ""

    def names(self) -> list:
        with self._lock:
            return sorted(self._tenants)

    def stats(self) -> dict:
        with self._lock:
            tenants = list(self._tenants.values())
        return {
            "tenants": {
                t.name: {
                    "class": t.priority_class,
                    "rate": t.bucket.rate if t.bucket else None,
                    "tokens": (round(t.bucket.available(), 3)
                               if t.bucket else None),
                }
                for t in sorted(tenants, key=lambda t: t.name)
            },
        }


# process-global registry: what MicrobatchExecutor consults
# when not handed an explicit one (tests build their own)
_REGISTRY = TenantRegistry()


def get_registry() -> TenantRegistry:
    """The process-global tenant registry."""
    return _REGISTRY


__all__ = [
    "BEST_EFFORT", "CLASSES", "ClassPolicy", "DEFAULT_WEIGHTS",
    "INTERACTIVE", "PRESSURE_FRACTIONS", "STANDARD", "Tenant",
    "TenantRegistry", "TokenBucket", "cache_quota_fraction",
    "class_policy", "coerce_class", "default_class", "get_registry",
    "shed_fraction", "slo_seconds",
]
