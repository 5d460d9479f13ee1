"""Consistent-hash ring: the fleet router's sticky-affinity structure
(the port of libskylark_tpu/fleet/ring.py; its placements are the
reference's, key for key).

Affinity routing exists because the microbatch executor keeps its
captured flushes per replica: a (bucket, capacity) class served once
serves without a new capture after, but only on that replica. A
consistent-hash ring pins each class to one owner, so the fleet captures
each class once; the dist coordinator places shard tasks on it the same
way, by ``(plan fingerprint, shard index)``.

Every member contributes ``vnodes`` virtual points at
``blake2b(f"{member}#{i}")``; a key hashes to a point and is owned by the
first member clockwise. So:

- **determinism across processes**: blake2b of the key's ``repr``, so
  two rings (or a ring rebuilt after a restart), of either package,
  agree on ownership without coordination;
- **minimal disruption**: removing a member (a DRAINING replica) moves
  only the keys it held;
- **preference order**: :meth:`preference` yields every member in ring
  order from the key's point, the owner first: the failover sequence.

Members are plain strings (replica names); the ring never touches the
replicas themselves.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Iterator, List, Tuple

from libskylark_tpu_torch.base import locks as _locks


def ring_hash(data: str) -> int:
    """64-bit stable hash (NOT Python's randomized ``hash``): ring
    positions must agree across processes and runs."""
    return int.from_bytes(
        hashlib.blake2b(data.encode("utf-8"), digest_size=8).digest(),
        "big")


def key_point(key: object) -> int:
    """Ring position of a routing key (bucket statics tuples have
    stable reprs; see ``engine.request_statics``)."""
    return ring_hash(repr(key))


class HashRing:
    """Thread-safe consistent-hash ring over named members."""

    def __init__(self, members: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self._vnodes = int(vnodes)
        self._lock = _locks.make_lock("fleet.ring")
        self._members: set = set()
        self._points: List[Tuple[int, str]] = []   # sorted (point, member)
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def __contains__(self, member: str) -> bool:
        with self._lock:
            return member in self._members

    def members(self) -> set:
        with self._lock:
            return set(self._members)

    def add(self, member: str) -> None:
        """Idempotent; a re-added member lands on its original points
        (vnode hashes depend only on the name)."""
        member = str(member)
        with self._lock:
            if member in self._members:
                return
            self._members.add(member)
            for i in range(self._vnodes):
                bisect.insort(self._points,
                              (ring_hash(f"{member}#{i}"), member))

    def remove(self, member: str) -> None:
        """Idempotent removal (a DRAINING replica leaves the ring)."""
        with self._lock:
            if member not in self._members:
                return
            self._members.discard(member)
            self._points = [p for p in self._points if p[1] != member]

    def owner(self, key: object) -> str:
        """The member owning ``key`` (first point clockwise).
        Raises :class:`LookupError` on an empty ring."""
        for m in self.preference(key):
            return m
        raise LookupError("hash ring is empty")

    def preference(self, key: object) -> Iterator[str]:
        """Every member once, in ring order starting at ``key``'s
        point — the owner first, then the deterministic failover
        sequence."""
        with self._lock:
            points = list(self._points)
            n_members = len(self._members)
        if not points:
            return
        start = bisect.bisect_left(points, (key_point(key), ""))
        seen: set = set()
        for i in range(len(points)):
            member = points[(start + i) % len(points)][1]
            if member not in seen:
                seen.add(member)
                yield member
                if len(seen) == n_members:
                    return


__all__ = ["HashRing", "key_point", "ring_hash"]
