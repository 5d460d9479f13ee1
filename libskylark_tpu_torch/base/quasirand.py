"""Quasi-Monte-Carlo sequences (leaped Halton) for quasi-random features
(the port of libskylark_tpu/base/quasirand.py).

Sequence panels are made on the host in float64 numpy when a transform is
built: they define the transform, and float64 keeps the radical inverse's
integer arithmetic exact.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from libskylark_tpu_torch.base import errors


def _primes(n: int) -> np.ndarray:
    primes: list[int] = []
    cand = 2
    while len(primes) < n:
        if all(cand % p for p in primes if p * p <= cand):
            primes.append(cand)
        cand += 1
    return np.asarray(primes, dtype=np.int64)


def radical_inverse(base: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Vectorized radical inverse of ``idx + 1`` in ``base`` (indexes
    start from 0, as the reference's); ``base`` and ``idx`` broadcast."""
    base = np.asarray(base, dtype=np.int64)
    res = np.broadcast_to(np.asarray(idx, dtype=np.int64) + 1,
                          np.broadcast_shapes(base.shape,
                                              np.shape(idx))).copy()
    basef = base.astype(np.float64)
    r = np.zeros(res.shape, dtype=np.float64)
    m = np.broadcast_to(1.0 / basef, res.shape).copy()
    while (res > 0).any():
        r += m * (res % base)
        res //= base
        m /= basef
    return r


class QMCSequence:
    """A quasi-Monte-Carlo sequence."""

    sequence_type = "qmc"

    def coordinate(self, idx: int, i: int) -> float:
        raise NotImplementedError

    def panel(self, idx_start: int, idx_stop: int, d: int) -> np.ndarray:
        """Coordinates for idx in [idx_start, idx_stop) × dims [0, d):
        shape (idx_stop − idx_start, d)."""
        raise NotImplementedError

    def to_dict(self) -> dict[str, Any]:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "QMCSequence":
        if d.get("sequence_type") == "leaped halton":
            return LeapedHaltonSequence(int(d["d"]), int(d["leap"]))
        raise errors.InvalidParametersError(
            f"unknown QMC sequence type {d.get('sequence_type')!r}")


class LeapedHaltonSequence(QMCSequence):
    """Leaped Halton: coordinate(idx, i) = radical_inverse(prime(i),
    idx·leap); the default leap is prime(d) (0-indexed, prime(0) = 2)."""

    sequence_type = "leaped halton"

    def __init__(self, d: int, leap: int = -1):
        self.d = int(d)
        ps = _primes(self.d + 1)
        self.leap = int(ps[self.d]) if leap in (-1, None) else int(leap)
        self._bases = ps[: self.d]

    def coordinate(self, idx: int, i: int) -> float:
        return float(radical_inverse(self._bases[i],
                                     np.int64(idx) * self.leap))

    def panel(self, idx_start: int, idx_stop: int, d: int) -> np.ndarray:
        if d > self.d:
            raise errors.InvalidParametersError(
                f"panel dimension {d} exceeds the sequence's {self.d}")
        idx = (np.arange(idx_start, idx_stop, dtype=np.int64)
               * self.leap)[:, None]
        return radical_inverse(self._bases[None, :d], idx)

    def to_dict(self) -> dict[str, Any]:
        return {
            "skylark_object_type": "qmc_sequence",
            "sequence_type": "leaped halton",
            "d": self.d,
            "leap": self.leap,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
