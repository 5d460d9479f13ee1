"""``engine.compiled``: whole-solver programs served from an explicit
executable cache (the port of libskylark_tpu/engine/compiled.py).

``compiled(fn, ...)`` binds a solver body to the LRU of :mod:`.cache`.
What an executable is depends on where the call's tensors lie:

- **On the card, a CUDA graph captured from the body.** A miss copies
  the arguments into static buffers, runs the body once eagerly on the
  entry's own stream (the warm-up, which also makes cuBLAS's and
  cuSOLVER's handles and records the per-seed inputs), returns that run's
  results, then captures the body (``capture_error_mode="thread_local"``:
  other threads may launch meanwhile) and records the kernel wrappers'
  launch counts of one replay. A hit, under the entry's lock and on its
  stream: copy in each argument that is not the tensor copied in last
  time, unchanged since (the same object at the same version), refill
  the per-seed inputs, replay, add the recorded launch counts, and
  return clones of the outputs (the next replay overwrites its output
  buffers). There is no eager route on the card: a body that cannot be
  captured raises, and its single-flight is released. The graphs' device
  memory is bounded (:func:`byte_budget`: ``cache().max_bytes``, default
  half the card): past it the least recently used are evicted.
- **On the CPU, the body itself**, keyed and counted the same way and run
  under a binding of its own as a capture is, so a per-seed value made
  outside a seeded method raises here too: the kernels' plain versions,
  which is what the tests run.

Positional arguments are tensors (one device for all), numbers (made
0-dim tensors on that device: a new λ is a new input, not a new graph)
and sketch transforms. A transform enters the key by its seed-free
:func:`~libskylark_tpu_torch.sketch.transform.signature` (ROADMAP C20),
and on the card what it makes from its seed, kernel keys included,
becomes graph inputs (:class:`~libskylark_tpu_torch.sketch.transform.
SeedBinding`), so one capture serves every seed, as the reference's
executables do with a traced key. Statics go by keyword. The key:

    (name, code version, statics, key_fn extras, (shape, dtype, device)
     of each tensor and signature of each transform, "unsharded",
     donation, plan fingerprint, precision fingerprint, backend)

The precision fingerprint holds what a capture fixes in place: the
solver precision and the ambient float32 matmul precision, the package's
B1 regime (sketch/params.py), cuBLAS's and cuDNN's TF32 flags and the
preferred linalg library.

Donation: sites opt in (``donate_argnums``) and ``donate="auto"`` sites
only when ``SKYLARK_ENGINE_DONATE=1`` (:func:`donation_enabled`). A
donated tensor is consumed: once it is copied in (on the CPU, once the
body ran) it lets go of its storage and becomes empty, so a later use of
its shape raises.

**Capture records** (:mod:`.aot`). A CUDA graph cannot be serialized, so
where the reference writes each compiled executable into its artifact
store, the port writes a capture record: with ``SKYLARK_AOT_DIR`` set,
each capture writes its key's record (the key, the body's name, its
arguments' shapes, dtypes and devices) under the key's per-digest file
lock, so racing processes write it once. A record makes no graph by
itself: a boot captures before traffic, by serving a warmup pack's
canonical cohorts (:mod:`.warmup`) inside :func:`loading`, where the
capture of a record's key counts as an ``aot_load`` (its warm-up and
capture time in ``load_seconds``), never as a miss or a compile. jax's
persistent compilation cache has no counterpart
(:func:`enable_persistent_cache`).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import inspect
import json
import os
import threading
import time
import warnings
import weakref
from typing import Callable, Optional, Sequence

import torch

from libskylark_tpu_torch import telemetry as _telemetry
from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.engine import aot as _aot
from libskylark_tpu_torch.engine.cache import (CacheEntry, EngineStats,
                                               ExecutableCache)
from libskylark_tpu_torch.kernels import launch as _launch
from libskylark_tpu_torch.resilience import faults as _faults
from libskylark_tpu_torch.sketch.transform import (SeedBinding,
                                                   SketchTransform, signature)

# ---------------------------------------------------------------------------
# global cache + policy switches
# ---------------------------------------------------------------------------

_CACHE = ExecutableCache(maxsize=_env.EXEC_CACHE_SIZE.get())

# the cache's own counters are the compile/hit/miss source (a collector
# snapshots them); only the cold materialization observes a histogram
_COMPILE_HIST = _telemetry.histogram(
    "engine.compile_seconds",
    "Wall time of cold materializations (warm-up and CUDA-graph capture) "
    "through the executable cache")
_LOAD_HIST = _telemetry.histogram(
    "engine.load_seconds",
    "Wall time of a boot's captures of capture-record keys (warm-up and "
    "capture inside engine.compiled.loading) through the executable cache")
_PERSIST_FAIL = _telemetry.counter(
    "engine.persistent_cache_failures",
    "enable_persistent_cache attempts that wired nothing (a CUDA graph "
    "cannot be serialized)")


def _lifetime_rollup() -> EngineStats:
    """The reset-proof rollup (current window included), one
    implementation for the telemetry snapshot and :func:`dump_stats`."""
    lifetime = EngineStats()
    lifetime.merge(_CACHE.lifetime)
    lifetime.merge(_CACHE.stats)
    return lifetime


def _telemetry_engine_block() -> dict:
    return {"stats": _CACHE.stats.to_dict(),
            "lifetime": _lifetime_rollup().to_dict(),
            "cache_entries": len(_CACHE)}


_telemetry.register_collector("engine", _telemetry_engine_block)


def cache() -> ExecutableCache:
    """The process-global executable cache."""
    return _CACHE


def stats() -> EngineStats:
    """Global engine counters (hits/misses/recompiles/compile time)."""
    return _CACHE.stats


def reset() -> None:
    """Drop every executable (and with it each graph's static buffers and
    memory pool) and zero the counters (tests, benches, chip phases)."""
    _CACHE.reset()


def byte_budget(device) -> int:
    """Device bytes the cached graphs may hold together: the cache's
    ``max_bytes`` when set, else half of ``device``'s memory."""
    if _CACHE.max_bytes is not None:
        return int(_CACHE.max_bytes)
    return torch.cuda.get_device_properties(device).total_memory // 2


def donation_enabled() -> bool:
    """Whether solver entry points donate their operands
    (``SKYLARK_ENGINE_DONATE=1``). Off by default: donation consumes the
    caller's tensors."""
    return _env.ENGINE_DONATE.get()


def maybe_donate(argnums: Sequence[int]) -> tuple[int, ...]:
    """``argnums`` when donation is enabled, else ``()``."""
    return tuple(argnums) if donation_enabled() else ()


_persist_warned = False


def enable_persistent_cache(path: Optional[str] = None) -> bool:
    """The reference wires jax's persistent compilation cache at ``path``
    (or ``SKYLARK_EXEC_CACHE_DIR``). The port has nothing to wire: a CUDA
    graph cannot be serialized. Its cross-process artifact is the capture
    record of ``SKYLARK_AOT_DIR`` (:mod:`.aot`), which a warmup pack
    captures from before traffic (:mod:`.warmup`). Returns False; when a
    path was asked for, counts ``engine.persistent_cache_failures`` and
    warns once. Never raises."""
    global _persist_warned
    path = path or _env.EXEC_CACHE_DIR.raw()
    if not path or path.strip().lower() in _env.OFF_WORDS:
        return False
    _PERSIST_FAIL.inc_always(reason="unsupported")
    if not _persist_warned:
        _persist_warned = True
        warnings.warn(
            f"no persistent compilation cache in the port (a CUDA graph "
            f"cannot be serialized): {path!r} is not used; set "
            f"SKYLARK_AOT_DIR for the store of capture records and boot "
            f"from a warmup pack (engine.warmup)",
            RuntimeWarning, stacklevel=2)
    return False


_LOAD_KEYS: set = set()
_load_lock = _locks.make_lock("engine.load_keys")


@contextlib.contextmanager
def loading(keys):
    """Within the block, a cold materialization of one of ``keys``, on
    any thread (an executor's worker flushes too), is an AOT load: a boot
    capturing what a record names before traffic. It counts
    ``aot_loads`` and ``load_seconds`` (the warm-up and the capture),
    never a miss, a compile or ``compile_seconds``, and its entry is
    marked ``loaded``."""
    keys = set(keys)
    with _load_lock:
        _LOAD_KEYS.update(keys)
    try:
        yield
    finally:
        with _load_lock:
            _LOAD_KEYS.difference_update(keys)


def _loading(key) -> bool:
    if not _LOAD_KEYS:
        return False
    with _load_lock:
        return key in _LOAD_KEYS


# ---------------------------------------------------------------------------
# cache-key components
# ---------------------------------------------------------------------------

_code_hashes: dict[str, str] = {}


def _file_hash(path: str) -> str:
    h = _code_hashes.get(path)
    if h is None:
        try:
            with open(path, "rb") as fh:
                h = hashlib.sha256(fh.read()).hexdigest()[:16]
        except OSError:
            h = "unreadable"
        _code_hashes[path] = h
    return h


def code_version(fn: Callable) -> str:
    """Code-version component of the cache key: a hash over the wrapped
    body's defining module plus the engine's own sources."""
    paths = [__file__, os.path.join(os.path.dirname(__file__), "cache.py")]
    try:
        src = inspect.getsourcefile(fn)
        if src:
            paths.append(src)
    except TypeError:
        pass
    return "-".join(_file_hash(p) for p in paths)


def plan_fingerprint() -> str:
    """The autotuner plan cache's content fingerprint
    (:func:`libskylark_tpu_torch.tune.plan_fingerprint`): part of every
    executable key, so a body that baked a cached plan in at capture is
    re-keyed when the cache's plans change."""
    from libskylark_tpu_torch import tune

    return tune.plan_fingerprint()


def digest(obj) -> str:
    """Stable identity of a closed-over collaborator (a kernel, a params
    block) for ``key_fn`` extras: the hash of its JSON serialization when
    it has one (``to_json``), else its ``repr``. A transform's
    serialization holds its seed; a transform passed positionally enters
    the key by its seed-free signature instead (ROADMAP C20)."""
    try:
        doc = obj.to_json()
    except AttributeError:
        doc = repr(obj)
    return hashlib.sha256(str(doc).encode()).hexdigest()[:16]


def _precision_fingerprint() -> tuple:
    from libskylark_tpu_torch.base import precision
    from libskylark_tpu_torch.sketch import params

    return (precision.get_solver_precision(),
            precision.ambient_matmul_precision(),
            params.get_kernel_precision(),
            # the knobs that decide whether a body's B1 applies read a
            # cached plan (its split and regime)
            params.pallas_m_tile_overridden(), params.get_use_plan_cache(),
            bool(torch.backends.cuda.matmul.allow_tf32),
            bool(torch.backends.cudnn.allow_tf32),
            str(torch.backends.cuda.preferred_linalg_library()))


def _arg_key(a) -> tuple:
    if isinstance(a, SketchTransform):
        return ("transform", signature(a))
    return (tuple(a.shape), str(a.dtype), str(a.device))


def _prepare(name: str, args) -> tuple:
    """(arguments, device): tensors as given, numbers as 0-dim tensors on
    the device of the tensors, transforms as given."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors:
        raise errors.InvalidParametersError(
            f"engine.compiled({name}): no tensor argument")
    device = tensors[0].device
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if hasattr(a, "device_mesh"):
                raise errors.UnsupportedError(
                    f"engine.compiled({name}): a DTensor takes its solver's "
                    "eager route")
            if a.device != device:
                raise errors.InvalidParametersError(
                    f"engine.compiled({name}): tensors on {device} and "
                    f"{a.device}")
            out.append(a)
        elif isinstance(a, SketchTransform):
            out.append(a)
        elif isinstance(a, (bool, int, float)):
            out.append(torch.tensor(a).to(device, non_blocking=True))
        else:
            raise TypeError(
                f"engine.compiled({name}): positional arguments are "
                f"tensors, numbers or sketch transforms, got {type(a)}")
    return tuple(out), device


def _flatten(out) -> tuple[list, object]:
    """(leaf tensors, spec) of a tensor or a nest of tuples/lists."""
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (tuple, list)):
        leaves, specs = [], []
        for o in out:
            sub, spec = _flatten(o)
            specs.append((len(sub), spec))
            leaves += sub
        return leaves, (type(out), specs)
    raise TypeError(f"a compiled body returns tensors, got {type(out)}")


def _unflatten(leaves: list, spec):
    if spec is None:
        return leaves[0]
    kind, specs = spec
    out, i = [], 0
    for n, sub in specs:
        out.append(_unflatten(leaves[i:i + n], sub))
        i += n
    return kind(out)


def _consume(args, donate, stream=None) -> None:
    """Consume each donated tensor argument: it lets go of its storage
    (freed once nothing else holds it, after ``stream``'s queued reads of
    it on the card) and becomes an empty 1-D tensor, so a later use of
    its old shape raises."""
    for i in donate:
        a = args[i] if i < len(args) else None
        if not isinstance(a, torch.Tensor):
            continue
        if stream is not None:
            a.record_stream(stream)
        a.set_()


# ---------------------------------------------------------------------------
# executables
# ---------------------------------------------------------------------------


class _Body:
    """The CPU executable: the body called on the arguments."""

    def __init__(self, fn, kwargs):
        self._fn = fn
        self._kwargs = kwargs

    def __call__(self, args, donate):
        device = next(a for a in args if isinstance(a, torch.Tensor)).device
        with SeedBinding(args, device).active():
            out = self._fn(*args, **self._kwargs)
        _consume(args, donate)
        return out


class _Graph:
    """A body captured on the card, with its static input buffers, its
    per-seed inputs (:class:`SeedBinding`), its output buffers, its
    private memory pool and the launch counts of one replay. Built by a
    miss, which keeps the warm-up's outputs in ``first``."""

    def __init__(self, fn, kwargs, args, device, donate):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.lock = _locks.make_lock("engine.graph")
        cur = torch.cuda.current_stream(device)
        self.stream.wait_stream(cur)
        with torch.cuda.device(device), torch.cuda.stream(self.stream):
            self.static = [torch.empty_like(
                a, memory_format=torch.contiguous_format).copy_(a)
                if isinstance(a, torch.Tensor) else a for a in args]
            self.binding = SeedBinding(args, device)
            with self.binding.active():
                first = fn(*self.static, **kwargs)
        self._sources = [self._source(a) for a in args]
        leaves, spec = _flatten(first)
        # a warm-up output that shares a static buffer's storage would be
        # overwritten by the next copy-in
        held = {t.untyped_storage().data_ptr() for t in self.static
                if isinstance(t, torch.Tensor)}
        with torch.cuda.device(device), torch.cuda.stream(self.stream):
            leaves = [t.clone() if t.untyped_storage().data_ptr() in held
                      else t for t in leaves]
        cur.wait_stream(self.stream)
        for t in leaves:
            t.record_stream(cur)
        self.first = _unflatten(leaves, spec)
        _consume(args, donate, self.stream)

        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.stream(self.stream), \
                _launch.recording() as counts, \
                self.binding.active(replay=True):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*self.static, **kwargs)
            except BaseException:
                try:
                    self.graph.capture_end()
                except Exception:  # noqa: BLE001 — the body's error wins
                    pass
                raise
            self.graph.capture_end()
        self.counts = counts
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.out, self.spec = _flatten(out)
        held = [t for t in self.static if isinstance(t, torch.Tensor)]
        held += [slot[-1] for slot in self.binding.slots
                 if slot[-1] is not None]
        self.nbytes = self.pool_bytes + sum(
            t.untyped_storage().nbytes() for t in held)

    @staticmethod
    def _source(a):
        """What identifies a tensor argument copied into a static buffer:
        the object (weakly) and its version counter; None for an
        inference tensor, which keeps no version (always copied in)."""
        if not isinstance(a, torch.Tensor) or a.is_inference():
            return None
        return weakref.ref(a), a._version

    def _holds(self, i: int, a) -> bool:
        """Whether static buffer ``i`` already holds ``a``: the tensor
        copied in last time, not written since (an in-place write, or one
        through a view, moves its version)."""
        src = self._sources[i]
        return src is not None and src[0]() is a and a._version == src[1]

    def __call__(self, args, donate):
        cur = torch.cuda.current_stream(self.device)
        with self.lock:
            self.stream.wait_stream(cur)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                for i, (buf, a) in enumerate(zip(self.static, args)):
                    if isinstance(buf, torch.Tensor) and not self._holds(i, a):
                        buf.copy_(a)
                        self._sources[i] = self._source(a)
                self.binding.refill(args)
                self.graph.replay()
                outs = [t.clone() for t in self.out]
            cur.wait_stream(self.stream)
        for t in outs:
            t.record_stream(cur)
        _launch.add_counts(self.counts)
        _consume(args, donate, self.stream)
        return _unflatten(outs, self.spec)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


class CompiledFn:
    """A solver body bound to the executable cache. Call it like the
    wrapped function; statics go by keyword (``static_argnames``),
    everything positional is a tensor, a number or a sketch transform."""

    def __init__(self, fn: Callable, *, static_argnames: Sequence[str] = (),
                 donate_argnums: Sequence[int] = (),
                 donate: str = "explicit",
                 key_fn: Optional[Callable] = None,
                 name: Optional[str] = None):
        if donate not in ("explicit", "auto"):
            raise ValueError(f"donate must be 'explicit' or 'auto', "
                             f"got {donate!r}")
        self._fn = fn
        self._static_argnames = tuple(static_argnames)
        self._donate_argnums = tuple(donate_argnums)
        self._donate_mode = donate
        self._key_fn = key_fn
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self.stats = EngineStats()
        self._stats_lock = _locks.make_lock("engine.fn_stats")
        self._code_version = None
        functools.update_wrapper(self, fn)

    def _effective_donate(self) -> tuple[int, ...]:
        """``donate="auto"`` sites donate only when the user opted in;
        "explicit" sites always honor their argnums. Part of the key."""
        if self._donate_mode == "auto" and not donation_enabled():
            return ()
        return self._donate_argnums

    def _key(self, args, statics, kwargs, donate_argnums, device) -> tuple:
        if self._code_version is None:
            self._code_version = code_version(self._fn)
        extra = self._key_fn(*args, **kwargs) if self._key_fn else ()
        return (
            self.name,
            self._code_version,
            statics,
            extra,
            tuple(_arg_key(a) for a in args),
            tuple("unsharded" for _ in args),
            donate_argnums,
            plan_fingerprint(),
            _precision_fingerprint(),
            device.type,
        )

    def _materialize(self, key, args, kwargs, device, donate,
                     load: bool) -> tuple:
        """(entry, the call's result or None) for a cold key: the body
        itself on the CPU; on the card the warm-up, whose result this call
        returns, and the capture. ``load``: a boot's capture of a record's
        key (:func:`loading`), counted as an AOT load."""
        t0 = time.perf_counter()
        with _telemetry.span("engine.compile", attrs={"name": self.name}):
            _faults.check("engine.compile", detail=self.name)
            if device.type == "cuda":
                executable = _Graph(self._fn, kwargs, args, device, donate)
                first = executable.first
                executable.first = None
            elif device.type == "cpu":
                executable, first = _Body(self._fn, kwargs), None
            else:
                raise errors.UnsupportedError(
                    f"engine.compiled({self.name}) runs on CUDA or the CPU, "
                    f"got {device}")
        dt = time.perf_counter() - t0
        if load:
            _LOAD_HIST.observe_always(dt, name=self.name)
            with self._stats_lock:
                self.stats.aot_loads += 1
                self.stats.load_seconds += dt
            _CACHE.note_aot_load(dt)
        else:
            _COMPILE_HIST.observe_always(dt, name=self.name)
            with self._stats_lock:
                self.stats.compiles += 1
                self.stats.compile_seconds += dt
            _CACHE.note_compile()
        entry = CacheEntry(executable=executable, name=self.name,
                           compile_seconds=0.0 if load else dt, loaded=load)
        _CACHE.insert(key, entry)
        if device.type == "cuda":
            _CACHE.trim(byte_budget(device))
        self._persist(key, args, device, dt)
        return entry, first

    def _persist(self, key, args, device, seconds: float) -> None:
        """With the store on, write ``key``'s capture record unless it is
        there, under the key's file lock (racing processes write it once;
        a lock not won within ``SKYLARK_AOT_LOCK_TIMEOUT`` is gone
        without). Never raises."""
        if not _aot.enabled():
            return
        try:
            path = _aot.artifact_path(_aot.key_digest(key))
            lock = _aot.lock_for(key)
            held = lock.acquire(timeout=_aot.lock_timeout())
            try:
                if not os.path.exists(path):
                    _aot.save(key, {
                        "name": self.name,
                        "args": [_arg_key(a) for a in args],
                        "statics": key[2], "extra": key[3],
                        "donate": key[6], "device": str(device)},
                        name=self.name, compile_seconds=seconds)
            finally:
                if held:
                    lock.release()
        except Exception as e:  # noqa: BLE001 — a record is optional
            warnings.warn(f"capture record of {self.name!r} not written: "
                          f"{e!r}", RuntimeWarning, stacklevel=2)

    def __call__(self, *args, **kwargs):
        statics = tuple(
            (k, kwargs[k]) for k in self._static_argnames if k in kwargs)
        unknown = set(kwargs) - set(self._static_argnames)
        if unknown:
            raise TypeError(
                f"engine.compiled({self.name}): dynamic arguments must be "
                f"positional; got keyword {sorted(unknown)!r}")
        args, device = _prepare(self.name, args)
        donate_argnums = self._effective_donate()
        key = self._key(args, statics, kwargs, donate_argnums, device)
        load = _loading(key)
        entry = _CACHE.acquire(key, count=not load)
        out = None
        if entry is None:
            if not load:
                with self._stats_lock:
                    self.stats.misses += 1
            try:
                entry, out = self._materialize(key, args, kwargs, device,
                                               donate_argnums, load)
            except BaseException:
                _CACHE.abort(key)
                raise
        else:
            with self._stats_lock:
                self.stats.hits += 1
        t0 = time.perf_counter()
        if out is None:
            out = entry.executable(args, donate_argnums)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.stats.executions += 1
            self.stats.execute_seconds += dt
        _CACHE.note_execution(entry, dt)
        return out


def compiled(fn: Optional[Callable] = None, *,
             static_argnames: Sequence[str] = (),
             donate_argnums: Sequence[int] = (),
             donate: str = "explicit",
             key_fn: Optional[Callable] = None,
             name: Optional[str] = None):
    """Wrap ``fn`` (usable as a decorator) in the donation-aware
    executable cache. See the module docstring for the key's anatomy."""
    if fn is None:
        return functools.partial(
            compiled, static_argnames=static_argnames,
            donate_argnums=donate_argnums, donate=donate, key_fn=key_fn,
            name=name)
    return CompiledFn(fn, static_argnames=static_argnames,
                      donate_argnums=donate_argnums, donate=donate,
                      key_fn=key_fn, name=name)


# ---------------------------------------------------------------------------
# stats dump
# ---------------------------------------------------------------------------


def dump_stats(path: str) -> None:
    """Write the global counters, the lifetime rollup and the per-entry
    snapshot as JSON, atomically (a temporary file, then ``os.replace``:
    a reader at exit never sees a torn file); with the serve executor's
    stats and the telemetry snapshot beside them."""
    doc = {"stats": _CACHE.stats.to_dict(),
           "lifetime": _lifetime_rollup().to_dict(),
           "entries": _CACHE.snapshot(),
           "cache_size": len(_CACHE)}
    try:
        from libskylark_tpu_torch.engine.serve import serve_stats

        doc["serve"] = serve_stats()
    except Exception:  # noqa: BLE001 — the dump carries what it can
        pass
    try:
        doc["telemetry"] = _telemetry.snapshot()
    except Exception:  # noqa: BLE001
        pass
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, default=str)
        fh.write("\n")
    os.replace(tmp, path)


def _install_stats_dump() -> None:
    path = _env.ENGINE_STATS_DUMP.get()
    if not path:
        return
    import atexit

    atexit.register(lambda: _try_dump(path))


def _try_dump(path: str) -> None:
    try:
        dump_stats(path)
    except Exception:  # noqa: BLE001 — an exit hook must not raise
        pass


_install_stats_dump()
