"""Weighted-fair deficit scheduling across the QoS priority classes (the
port of libskylark_tpu/qos/scheduler.py).

Deficit round robin (Shreedhar and Varghese) over one virtual queue per
class. Each class holds a deficit, a credit counted in requests; a round
visits the classes in priority order, credits each ready one ``quantum x
weight``, and lets a class dispatch cohorts while its deficit covers
their request count. Properties:

- **weighted fairness**: under a sustained backlog of every class the
  served requests approach the 8:4:1 class weights;
- **no starvation**: every weight is at least 1, so a backlogged class
  is credited every round;
- **work conservation**: with one backlogged class, it dispatches at
  once;
- **determinism**: the decision is a pure function of the backlog and
  the carried deficits, with no clock and no randomness, so the port
  and the reference make the same choices on the same ready sets.

The scheduler sees class names and request counts, not buckets;
:class:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor` maps its
buckets to classes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from libskylark_tpu_torch.qos import tenants as _tenants


class DeficitScheduler:
    """DRR decision state over the priority classes (module doc).

    Single-threaded by contract: the executor consults it only from
    the flusher thread (under the executor lock), so the deficits
    need no lock of their own.
    """

    def __init__(self, weights: Optional[Dict[str, int]] = None,
                 quantum: int = 1):
        self.weights = dict(_tenants.DEFAULT_WEIGHTS)
        if weights:
            for cls, w in weights.items():
                self.weights[_tenants.coerce_class(cls)] = max(int(w), 1)
        self.quantum = max(int(quantum), 1)
        self._deficit: Dict[str, float] = {c: 0.0 for c in
                                           _tenants.CLASSES}
        self.served: Dict[str, int] = {c: 0 for c in _tenants.CLASSES}
        # requests satisfied WITHOUT a dispatch (result-cache hits and
        # single-flight followers): they never consume a
        # flush slot, so they must not spend deficit — but the
        # fairness ledger has to show them or a hot cached class would
        # look starved next to its actual goodput
        self.bypassed: Dict[str, int] = {c: 0 for c in _tenants.CLASSES}

    # -- the decision procedure ---------------------------------------

    def next_class(self, backlog: Dict[str, int],
                   cost: Callable[[str], int]) -> Optional[str]:
        """Pick the class to dispatch from next. ``backlog`` maps class
        -> ready request count (classes with zero ready work are
        skipped and their deficit cleared — an idle class must not
        bank credit and then burst past its weight); ``cost(cls)`` is
        the request count of the cohort that WOULD be dispatched.
        Returns ``None`` when nothing is ready."""
        ready = [c for c in _tenants.CLASSES if backlog.get(c, 0) > 0]
        if not ready:
            for c in _tenants.CLASSES:
                self._deficit[c] = 0.0
            return None
        for c in _tenants.CLASSES:
            if backlog.get(c, 0) <= 0:
                # no banked credit for idle classes (DRR's anti-burst
                # rule): a class that sat empty must not return and
                # burst past its weight on saved deficit
                self._deficit[c] = 0.0
        if len(ready) == 1:
            # work conservation: a lone backlogged class never waits
            # on credit arithmetic
            return ready[0]
        # spend-then-credit rounds: serve the first class (priority
        # order) whose deficit covers its head cohort; when none can
        # afford theirs, credit every ready class one quantum x weight
        # and retry. Terminates: deficits grow at least 1/iteration
        # toward a bounded cohort cost.
        bound = int(max(cost(c) for c in ready)) + 2
        for _ in range(bound):
            for c in ready:
                if self._deficit[c] >= cost(c):
                    return c
            for c in ready:
                self._deficit[c] += self.quantum * self.weights[c]
        return max(ready, key=lambda c: self._deficit[c])

    def charge(self, cls: str, n: int) -> None:
        """Account one dispatched cohort of ``n`` requests."""
        cls = _tenants.coerce_class(cls)
        self._deficit[cls] = max(0.0, self._deficit[cls] - int(n))
        self.served[cls] = self.served.get(cls, 0) + int(n)

    def note_bypass(self, cls: str, n: int = 1) -> None:
        """Account ``n`` requests of ``cls`` satisfied without a
        dispatch (a result-cache hit or a coalesced single-flight
        follower): counted in the fairness ledger, charged to no
        deficit — a bypassed request consumed no flush slot, so
        spending credit for it would under-serve the class's actual
        queue."""
        cls = _tenants.coerce_class(cls)
        self.bypassed[cls] = self.bypassed.get(cls, 0) + int(n)

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        return {
            "weights": dict(self.weights),
            "deficit": {c: round(self._deficit[c], 3)
                        for c in _tenants.CLASSES},
            "served": dict(self.served),
            "bypassed": dict(self.bypassed),
        }


def drain_order(classes: Sequence[str]) -> list:
    """Shed order: least-protected first (the reverse of
    :data:`~libskylark_tpu.qos.tenants.CLASSES`). This is the
    *statement* of the ordering contract — the executor implements it
    through per-class admission bounds
    (``MicrobatchExecutor._class_shed_bound`` and the pressure
    fractions), not by consulting this function; tests pin the two
    against each other. Useful for tooling that ranks classes."""
    order = [c for c in reversed(_tenants.CLASSES) if c in classes]
    return order + [c for c in classes if c not in order]


__all__ = ["DeficitScheduler", "drain_order"]
