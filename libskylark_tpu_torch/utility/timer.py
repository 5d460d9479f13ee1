"""Phase timers: per-phase host wall time accumulated across a run (the
port of libskylark_tpu/utility/timer.py), as BlockADMM uses them.

Enablement: ``SKYLARK_TPU_PROFILE`` (any value but empty or ``0``), read
once through ``base.env``, or :func:`set_enabled`. A disabled phase costs
one call and one branch. Phases measure host time: CUDA work is asynchronous, so a phase
that only enqueues work looks free and the next synchronising one absorbs
its cost; a phase that must own its device time ends in a synchronise
(ADMM does so for its iterations only).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

from libskylark_tpu_torch.base import env as _env

_ENABLED: Optional[bool] = None


def timers_enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = bool(_env.TPU_PROFILE.get())
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic switch (overrides the environment)."""
    global _ENABLED
    _ENABLED = bool(on)


class PhaseTimer:
    """Named accumulators: ``with timer.phase("TRANSFORM"): ...``."""

    def __init__(self, name: str = ""):
        self.name = name
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, label: str):
        if not timers_enabled():
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.accumulate(label, time.perf_counter() - t0)

    def accumulate(self, label: str, seconds: float) -> None:
        """Add a phase timed elsewhere."""
        if not timers_enabled():
            return
        self.totals[label] = self.totals.get(label, 0.0) + float(seconds)
        self.counts[label] = self.counts.get(label, 0) + 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self, stream=None) -> str:
        """The phase table, printed to ``stream`` when one is given."""
        lines = [f"== phase timings{' [' + self.name + ']' if self.name else ''} =="]
        width = max((len(k) for k in self.totals), default=5)
        for label in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[label], self.counts[label]
            lines.append(f"{label.ljust(width)}  total {t:10.4f}s  "
                         f"calls {c:6d}  avg {t / c:10.6f}s")
        text = "\n".join(lines)
        if stream is not None:
            print(text, file=stream)
        return text


_REGISTRY: Dict[str, PhaseTimer] = {}


def get_timer(name: str = "default") -> PhaseTimer:
    """The process-wide timer of that name."""
    if name not in _REGISTRY:
        _REGISTRY[name] = PhaseTimer(name)
    return _REGISTRY[name]
