"""Deterministic random context: global (seed, counter) state.

The port of libskylark_tpu/base/context.py. Allocation ``i`` of a context
with seed ``s`` is the key ``fold_in(key(s), i)`` in ``jax.random``'s own
key algebra, derived here with the Threefry cipher alone (no JAX):

- ``key(seed)`` is the (2,) uint32 pair (hi, lo) of the seed's bits; a
  seed in the int32 range has hi = 0, as under JAX's default 32-bit mode;
- ``fold_in(key, d)`` is Threefry-2x32 under ``key`` of the counter
  words (0, d).

So one (seed, counter, path) names the same operator in both packages,
and the JSON form is the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.threefry import MASK32, threefry2x32


def key_words(key) -> tuple[int, int]:
    """(k0, k1) as Python ints from any (2,) uint32 key representation."""
    k = np.asarray(key)
    if k.shape != (2,):
        raise errors.InvalidParametersError(
            f"key data must have shape (2,), got {k.shape}")
    return int(k[0]) & MASK32, int(k[1]) & MASK32


def seed_key(seed: int) -> np.ndarray:
    """Key data of ``jax.random.key(seed)``."""
    s = int(seed)
    if -(1 << 31) <= s < (1 << 31):
        return np.array([0, s & MASK32], np.uint32)
    s &= (1 << 64) - 1  # a 64-bit seed is bit-cast to (hi, lo)
    return np.array([s >> 32, s & MASK32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """Key data of ``jax.random.fold_in(key, data)``."""
    d = int(data)
    if not 0 <= d <= MASK32:
        raise errors.InvalidParametersError(
            f"fold_in data must be a uint32, got {d}")
    k0, k1 = key_words(key)
    return np.array(threefry2x32(k0, k1, 0, d), np.uint32)


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A reserved slot of the context's random space, reconstructible
    from (seed, counter) alone; ``path`` folds nested sub-allocations
    into the key in order."""

    seed: int
    counter: int
    path: tuple = ()

    @property
    def key(self) -> np.ndarray:
        """The (2,) uint32 key data of this allocation."""
        k = fold_in(seed_key(self.seed), self.counter)
        for p in self.path:
            k = fold_in(k, p)
        return k

    def child(self, tag: int) -> "Allocation":
        """The nested sub-allocation ``tag`` (e.g. PPT's i-th CWT)."""
        return Allocation(self.seed, self.counter, self.path + (int(tag),))

    def to_dict(self) -> dict[str, Any]:
        d = {"seed": int(self.seed), "counter": int(self.counter)}
        if self.path:
            d["path"] = list(self.path)
        return d

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Allocation":
        return Allocation(
            int(d["seed"]), int(d["counter"]), tuple(d.get("path", ()))
        )


class Context:
    """Global deterministic RNG state = (seed, counter). ``allocate()``
    reserves the next slot and advances the counter."""

    def __init__(self, seed: int = 0, counter: int = 0):
        self._seed = int(seed)
        self._counter = int(counter)

    @property
    def seed(self) -> int:
        return self._seed

    @property
    def counter(self) -> int:
        return self._counter

    def allocate(self) -> Allocation:
        """Reserve the next allocation slot; advances the counter."""
        alloc = Allocation(self._seed, self._counter)
        self._counter += 1
        return alloc

    def random_value(self, sampler, **kwargs):
        """``sampler(key, **kwargs)`` under the next allocation's key data
        (e.g. ``randgen.Normal().sample`` with ``shape=()``)."""
        return sampler(self.allocate().key, **kwargs)

    def to_dict(self) -> dict[str, Any]:
        return {
            "skylark_object_type": "context",
            "seed": self._seed,
            "counter": self._counter,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Context":
        return Context(int(d["seed"]), int(d.get("counter", 0)))

    @staticmethod
    def from_json(s: str) -> "Context":
        return Context.from_dict(json.loads(s))

    def __repr__(self) -> str:
        return f"Context(seed={self._seed}, counter={self._counter})"
