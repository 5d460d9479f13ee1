"""In-process executable cache: an LRU over compiled solver programs (the
port of libskylark_tpu/engine/cache.py).

One entry is one executable of :mod:`.compiled`: on the card a captured
CUDA graph with its static buffers, its memory pool and the launch counts
of one replay; on the CPU the body itself. Every materialization goes
through :meth:`ExecutableCache.insert`, so the cache's own counters are
the engine's compile counters.

Counter vocabulary:

``hits`` / ``misses``
    lookup outcomes; a miss is followed by exactly one materialization.
``recompiles``
    misses whose key was materialized before in this process: LRU thrash
    (evicted, then needed again) or a key component flapping.
``evictions``
    LRU entries dropped at capacity (``SKYLARK_EXEC_CACHE_SIZE``, default
    128 executables).
``compiles``
    materializations caused by traffic: CUDA-graph captures on the card,
    keyed bodies on the CPU; equal to ``misses``.
``aot_loads`` / ``aot_load_failures``
    materializations a boot made from capture records before traffic
    (a warmup pack's entries, ``engine.warmup.load_pack``: never a miss
    or a compile), and records that could not be used.
``compile_seconds`` / ``load_seconds`` / ``execute_seconds``
    cumulative wall time: warm-up plus capture of traffic's misses, of
    the loads, and the calls' copy-in, replay and output clones.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional

from libskylark_tpu_torch.base import locks as _locks


@dataclasses.dataclass
class EngineStats:
    """Mutable counter block; one global instance plus one per wrapped
    solver (``CompiledFn.stats``)."""

    hits: int = 0
    misses: int = 0
    recompiles: int = 0
    evictions: int = 0
    executions: int = 0
    compiles: int = 0
    aot_loads: int = 0
    aot_load_failures: int = 0
    compile_seconds: float = 0.0
    load_seconds: float = 0.0
    execute_seconds: float = 0.0

    def hit_rate(self) -> Optional[float]:
        n = self.hits + self.misses
        return (self.hits / n) if n else None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate()
        return d

    def reset(self) -> None:
        self.hits = self.misses = self.recompiles = 0
        self.evictions = self.executions = self.compiles = 0
        self.aot_loads = self.aot_load_failures = 0
        self.compile_seconds = self.load_seconds = 0.0
        self.execute_seconds = 0.0

    def merge(self, other: "EngineStats") -> None:
        """Accumulate ``other`` into this block (the lifetime rollup)."""
        self.hits += other.hits
        self.misses += other.misses
        self.recompiles += other.recompiles
        self.evictions += other.evictions
        self.executions += other.executions
        self.compiles += other.compiles
        self.aot_loads += other.aot_loads
        self.aot_load_failures += other.aot_load_failures
        self.compile_seconds += other.compile_seconds
        self.load_seconds += other.load_seconds
        self.execute_seconds += other.execute_seconds


@dataclasses.dataclass
class CacheEntry:
    """One compiled executable plus its provenance."""

    executable: Any           # a captured graph, or the body on the CPU
    name: str                 # wrapped solver name
    compile_seconds: float
    calls: int = 0
    loaded: bool = False      # captured from a record before traffic


class ExecutableCache:
    """Thread-safe LRU of :class:`CacheEntry` keyed on the engine's
    static key tuples. ``seen`` remembers every key ever compiled in
    this process so a re-compile of a previously-compiled key (thrash)
    is distinguishable from a first compile.

    Concurrency contract (``CompiledFn`` may be called from several
    threads): every counter increment and every LRU
    order mutation happens under ``_lock``, and a miss is single-flight
    — :meth:`acquire` hands the compile to exactly one thread while
    the others wait on an in-flight event, so N racing threads on a
    cold key produce ONE miss + one compile + N−1 hits, never N
    materializations of the same executable."""

    def __init__(self, maxsize: int = 128, max_bytes: Optional[int] = None):
        self.maxsize = int(maxsize)
        # device bytes the executables may hold together (trim()); None:
        # the engine's default for the device
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[Hashable, CacheEntry]" = OrderedDict()
        self._seen: set = set()
        self._lock = _locks.make_lock("engine.cache")
        # key -> Event for compiles in flight (single-flight discipline)
        self._inflight: dict = {}
        self.stats = EngineStats()
        # counters folded in at every reset(): the process-lifetime view
        # the CI jit-leak gate reads, immune to tests zeroing `stats`
        self.lifetime = EngineStats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, key: Hashable) -> Optional[CacheEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return entry
            self.stats.misses += 1
            if key in self._seen:
                self.stats.recompiles += 1
            return None

    def acquire(self, key: Hashable,
                count: bool = True) -> Optional[CacheEntry]:
        """Single-flight lookup: an entry on hit, else ``None`` exactly
        once per cold key — the calling thread owns the materialization
        and MUST
        finish with :meth:`insert` or :meth:`abort`. Concurrent callers
        of the same cold key block until the owner resolves it, then
        take the hit path (or inherit the compile if the owner
        aborted). ``count=False`` (a boot's load) counts neither the hit
        nor the miss."""
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    if count:
                        self.stats.hits += 1
                    return entry
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    if count:
                        self.stats.misses += 1
                        if key in self._seen:
                            self.stats.recompiles += 1
                    return None
            ev.wait()

    def insert(self, key: Hashable, entry: CacheEntry) -> None:
        with self._lock:
            self._seen.add(key)
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self.stats.compile_seconds += entry.compile_seconds
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()

    def nbytes(self) -> int:
        """Device bytes the entries' executables hold together (a
        captured graph's ``nbytes``; a CPU body holds none)."""
        with self._lock:
            return sum(getattr(e.executable, "nbytes", 0)
                       for e in self._entries.values())

    def trim(self, max_bytes: int) -> int:
        """Evict least recently used entries while their executables
        hold more than ``max_bytes``, never the most recent one; returns
        how many went. An evicted graph's memory is freed once no call
        still replays it."""
        evicted = 0
        with self._lock:
            total = sum(getattr(e.executable, "nbytes", 0)
                        for e in self._entries.values())
            while total > max_bytes and len(self._entries) > 1:
                _, entry = self._entries.popitem(last=False)
                total -= getattr(entry.executable, "nbytes", 0)
                self.stats.evictions += 1
                evicted += 1
        return evicted

    def abort(self, key: Hashable) -> None:
        """Release an :meth:`acquire`-owned compile that failed; blocked
        waiters re-race, and the next one inherits the compile."""
        with self._lock:
            ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()

    def note_compile(self) -> None:
        """Record one materialization: a capture on the card, a keyed
        body on the CPU."""
        with self._lock:
            self.stats.compiles += 1

    def note_aot_load(self, seconds: float) -> None:
        """Record one load: a capture made from a record before traffic
        (``engine.compiled.loading``)."""
        with self._lock:
            self.stats.aot_loads += 1
            self.stats.load_seconds += seconds

    def note_aot_load_failure(self) -> None:
        """Record one record that could not be used (compat, a torn file,
        a capture that failed or landed on another key)."""
        with self._lock:
            self.stats.aot_load_failures += 1

    def note_execution(self, entry: CacheEntry, seconds: float) -> None:
        """Record one executable dispatch (entry call count + global
        execution counters) atomically."""
        with self._lock:
            entry.calls += 1
            self.stats.executions += 1
            self.stats.execute_seconds += seconds

    def clear(self) -> None:
        """Drop all executables (the ``seen`` set survives — a post-clear
        recompile is still thrash from the gate's point of view; use
        :meth:`reset` for a clean slate)."""
        with self._lock:
            self._entries.clear()

    def reset(self) -> None:
        """Full reset: entries, seen-keys, and counters (tests). The
        window's counters roll into ``lifetime`` first — thrash cannot
        be erased by resetting. In-flight compile events are released so
        a reset mid-compile cannot strand waiters."""
        with self._lock:
            self._entries.clear()
            self._seen.clear()
            self.lifetime.merge(self.stats)
            self.stats.reset()
            inflight = list(self._inflight.values())
            self._inflight.clear()
        for ev in inflight:
            ev.set()

    def keys(self) -> list:
        with self._lock:
            return list(self._entries.keys())

    def snapshot(self) -> list[dict]:
        """Per-entry provenance for bench/debug output."""
        with self._lock:
            return [
                {"name": e.name, "calls": e.calls,
                 "compile_seconds": round(e.compile_seconds, 4),
                 "loaded": e.loaded,
                 "pool_bytes": getattr(e.executable, "pool_bytes", 0),
                 "nbytes": getattr(e.executable, "nbytes", 0)}
                for e in self._entries.values()
            ]
