"""``engine.aot``: the persistent artifact store, holding capture records
(the port of libskylark_tpu/engine/aot.py).

The reference serializes each compiled executable (jax's
``serialize_executable``) under a digest of its executable-cache key, so a
fresh process loads instead of compiling. The port's executables are
CUDA graphs, and **a CUDA graph cannot be serialized**: its nodes hold
device pointers and kernel handles of the process that captured it. So
the port's artifact is a **capture record**: the cache key, plus what a
boot needs to capture that key again before traffic (the body's name, its
arguments' shapes, dtypes and devices, its statics and kernel route; a
warmup pack adds the bucket spec whose canonical cohort reproduces the
flush, :mod:`.warmup`). A "load" is that capture, made from the record
before traffic: counted as ``aot_loads`` with its warm-up and capture
time in ``load_seconds``, never as a miss or a compile of traffic.

AOTInductor was weighed and rejected as the artifact's form (ROADMAP
C20):

- it regenerates the bodies' torch operations as Inductor code, whose
  results are not bit-equal to the eager body's, while the reference's
  packs promise "bit-equal results (the executable is byte-identical to
  the builder's)" (``libskylark_tpu/engine/warmup.py:17-22``), and a
  captured graph replays exactly the eager body's launches;
- it cannot trace the kernels the bodies launch through ctypes without a
  custom-op registration of each one.

Safety model, as the reference's:

- **The key is the contract.** A record is looked up by the digest of the
  exact key, so a record can never make another key's graph.
- **Compatibility probing.** Every record carries a compat stamp: the
  store's schema, torch's and CUDA's versions, the backend, the device
  name, compute capability and count, and a hash of the kernel sources
  (``csrc/*.cu``, ``*.cuh``): a key's code version covers only the body's
  file and the engine, but the kernels decide the bits. The stamp is
  probed before the payload is unpickled. A mismatch keeps the file (it
  is valid for the runtime that wrote it: a reference artifact in the
  port, a port record in a reference process); a torn or unreadable file
  is quarantined to ``.bad``.
- **Cross-process single-flight.** :class:`FileLock` is an advisory lock
  file with stale-holder takeover (a dead same-host pid, or an age past
  ``SKYLARK_AOT_LOCK_STALE``); a wait past ``SKYLARK_AOT_LOCK_TIMEOUT``
  gives up and goes on without it (liveness beats exactly-once). The
  engine writes each key's record under its per-digest lock, so racing
  processes write it once, and ``kernels/build.py`` takes one per
  library, so racing cold processes run nvcc once.

``SKYLARK_AOT_DIR`` names the store (an off-word disables it). The
deprecated ``SKYLARK_EXEC_CACHE_DIR`` alone maps to ``<dir>/aot``, with a
one-time ``DeprecationWarning``. The file format is the reference's byte
for byte: ``SKYAOT1\\n``, a big-endian u64 header length, the JSON header,
then a pickle payload; either package's :func:`read_header` and
:func:`list_artifacts` read the other's files.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import socket
import struct
import time
import warnings
from pathlib import Path
from typing import Any, Optional

from libskylark_tpu_torch.base import env as _env

AOT_SCHEMA = 1

_MAGIC = b"SKYAOT1\n"
_SUFFIX = ".skyaot"
# builder-scoped dir override (engine.warmup writes a pack's records
# without touching the process environment)
_DIR_OVERRIDE: Optional[str] = None
_alias_warned = False
_CSRC = Path(__file__).resolve().parent.parent / "csrc"


class AotLoadError(Exception):
    """A record exists but cannot be used (compat mismatch, torn file, a
    payload that does not unpickle, another key's record). ``reason`` is
    a stable slug the failure counters and warnings carry."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


# ---------------------------------------------------------------------------
# store location + policy
# ---------------------------------------------------------------------------


def aot_dir() -> Optional[str]:
    """The store directory, or None when disabled. ``SKYLARK_AOT_DIR``
    wins; set to an off-word it disables the store even when the
    deprecated ``SKYLARK_EXEC_CACHE_DIR`` alias is present."""
    global _alias_warned
    if _DIR_OVERRIDE is not None:
        return _DIR_OVERRIDE
    if _env.AOT_DIR.is_set():
        return _env.AOT_DIR.get()
    legacy = _env.EXEC_CACHE_DIR.get()
    if legacy:
        if not _alias_warned:
            _alias_warned = True
            warnings.warn(
                "SKYLARK_EXEC_CACHE_DIR without SKYLARK_AOT_DIR: using "
                f"{legacy}/aot for capture records. The variable is "
                "deprecated for this purpose; set SKYLARK_AOT_DIR.",
                DeprecationWarning, stacklevel=2)
        return os.path.join(legacy, "aot")
    return None


def enabled() -> bool:
    return aot_dir() is not None


@contextlib.contextmanager
def override_dir(path: Optional[str]):
    """Scoped store override (the warmup-pack builder). Not re-entrant
    across threads: builders are offline, single-threaded tools."""
    global _DIR_OVERRIDE
    prev = _DIR_OVERRIDE
    _DIR_OVERRIDE = path
    try:
        yield
    finally:
        _DIR_OVERRIDE = prev


def lock_stale_seconds() -> float:
    return _env.AOT_LOCK_STALE.get()


def lock_timeout() -> float:
    return _env.AOT_LOCK_TIMEOUT.get()


# ---------------------------------------------------------------------------
# addressing + compatibility
# ---------------------------------------------------------------------------


def key_digest(key: Any) -> str:
    """Content address of one executable-cache key: the key is built from
    primitives with a stable ``repr``, so its repr serializes it."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:32]


_kernels_hash: Optional[str] = None


def kernel_sources_hash() -> str:
    """A hash of the kernel sources (``csrc/*.cu`` and ``*.cuh``), in
    name order: what decides a captured graph's bits besides its key."""
    global _kernels_hash
    if _kernels_hash is None:
        h = hashlib.sha256()
        for p in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        _kernels_hash = h.hexdigest()[:16]
    return _kernels_hash


def compat_stamp() -> dict:
    """The runtime properties a record is valid under: the parts of the
    world the cache key does not capture."""
    import torch

    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    if cuda:
        props = torch.cuda.get_device_properties(0)
        kind, capability = props.name, f"{props.major}.{props.minor}"
    else:
        kind, capability = "cpu", None
    return {
        "schema": AOT_SCHEMA,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": kind,
        "capability": capability,
        "device_count": count,
        "kernels": kernel_sources_hash(),
    }


_COMPAT_FIELDS = ("schema", "torch", "cuda", "backend", "device_kind",
                  "capability", "device_count", "kernels")
_compat_tag_cache: Optional[str] = None


def compat_tag() -> str:
    """Short content hash of this runtime's compat stamp, part of a
    record's file name, so runtimes whose keys coincide address different
    files in a shared store."""
    global _compat_tag_cache
    if _compat_tag_cache is None:
        doc = json.dumps(compat_stamp(), sort_keys=True).encode()
        _compat_tag_cache = hashlib.sha256(doc).hexdigest()[:8]
    return _compat_tag_cache


def compat_probe(stamp: Optional[dict]) -> tuple[bool, Optional[str]]:
    """(ok, why-not) of a record's or pack's stamp against this process.
    A reference stamp (jax, jaxlib) fails on its first missing field."""
    if not isinstance(stamp, dict):
        return False, "no-compat-stamp"
    here = compat_stamp()
    for field in _COMPAT_FIELDS:
        if stamp.get(field) != here[field]:
            return False, (f"{field}-mismatch "
                           f"({stamp.get(field)!r} != {here[field]!r})")
    return True, None


def artifact_path(digest: str, dirpath: Optional[str] = None) -> str:
    """Where this runtime's record for ``digest`` lives: the name carries
    the compat tag."""
    d = dirpath or aot_dir()
    if d is None:
        raise RuntimeError("AOT artifact store is not enabled")
    return os.path.join(d, f"{digest}.{compat_tag()}{_SUFFIX}")


# ---------------------------------------------------------------------------
# file format: MAGIC | u64 header length | JSON header | pickle (the header
# reads without unpickling: probing and inspection never execute bytes
# they might reject)
# ---------------------------------------------------------------------------


def save(key: Any, executable: Any, *, name: str,
         compile_seconds: float = 0.0, meta: Optional[dict] = None,
         dirpath: Optional[str] = None) -> Optional[str]:
    """Write one capture record (``executable``: the record, a dict of
    primitives) under its key's digest; returns its path. Never raises:
    persistence is an optimization, and a failed save returns None. The
    write is atomic (a temporary file, then ``os.replace``)."""
    d = dirpath or aot_dir()
    if d is None:
        return None
    tmp = None
    try:
        os.makedirs(d, exist_ok=True)
        digest = key_digest(key)
        header = {
            "schema": AOT_SCHEMA,
            "digest": digest,
            "name": name,
            "compat": compat_stamp(),
            "created": time.time(),
            "compile_seconds": round(float(compile_seconds), 4),
            "key_repr": repr(key),
            "kind": "capture-record",
        }
        if meta:
            header.update(meta)
        hdr = json.dumps(header, sort_keys=True, default=str).encode()
        path = artifact_path(digest, d)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(_MAGIC)
            fh.write(struct.pack(">Q", len(hdr)))
            fh.write(hdr)
            pickle.dump({"key": key, "record": executable}, fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return path
    except Exception as e:  # noqa: BLE001 — never fail the capture path
        if tmp is not None:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
        warnings.warn(f"capture record save failed for {name!r}: {e!r}",
                      RuntimeWarning, stacklevel=2)
        return None


def read_header(path: str) -> dict:
    """The file's JSON header (no unpickling). Raises
    :class:`AotLoadError` on a torn or foreign file."""
    try:
        with open(path, "rb") as fh:
            magic = fh.read(len(_MAGIC))
            if magic != _MAGIC:
                raise AotLoadError("bad-magic", path)
            (hlen,) = struct.unpack(">Q", fh.read(8))
            if hlen > 1 << 20:
                raise AotLoadError("oversized-header", path)
            return json.loads(fh.read(hlen))
    except AotLoadError:
        raise
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 — torn file, bad json, ...
        raise AotLoadError("unreadable-header", repr(e)) from e


def load_file(path: str) -> tuple[Any, Any, dict]:
    """``(key, record, header)`` of one file. Raises :class:`AotLoadError`
    on a compat or payload problem, a torn file quarantined to ``.bad``
    first (a compat mismatch stays: it is valid for its writer), and
    ``FileNotFoundError`` on a plain miss."""
    try:
        header = read_header(path)
        ok, why = compat_probe(header.get("compat"))
        if not ok:
            raise AotLoadError("compat", why or "")
        try:
            with open(path, "rb") as fh:
                fh.seek(len(_MAGIC))
                (hlen,) = struct.unpack(">Q", fh.read(8))
                fh.seek(len(_MAGIC) + 8 + hlen)
                doc = pickle.load(fh)
            key, record = doc["key"], doc["record"]
        except FileNotFoundError:
            raise
        except Exception as e:  # noqa: BLE001 — a bad payload never loads
            raise AotLoadError("deserialize", repr(e)) from e
        if repr(key) != header.get("key_repr"):
            raise AotLoadError("key-mismatch", path)
    except AotLoadError as e:
        _quarantine(path, e)
        raise
    return key, record, header


def _quarantine(path: str, e: AotLoadError) -> None:
    """Move a broken file to ``.bad``, so later processes do not fail on
    the same bytes; a compat mismatch stays."""
    if e.reason != "compat":
        with contextlib.suppress(OSError):
            os.replace(path, path + ".bad")


def load(key: Any, dirpath: Optional[str] = None
         ) -> Optional[tuple[Any, dict, float]]:
    """``(record, header, read_seconds)`` of ``key``, or None when no
    record exists. Raises :class:`AotLoadError` when one exists but is
    unusable (:func:`load_file`)."""
    d = dirpath or aot_dir()
    if d is None:
        return None
    path = artifact_path(key_digest(key), d)
    t0 = time.perf_counter()
    try:
        stored_key, record, header = load_file(path)
    except FileNotFoundError:
        return None
    if stored_key != key:
        e = AotLoadError("key-mismatch", path)
        _quarantine(path, e)
        raise e
    return record, header, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# cross-process single-flight: a per-digest advisory file lock
# ---------------------------------------------------------------------------


class FileLock:
    """O_EXCL-based advisory lock with stale-holder takeover.

    The holder writes ``{pid, host, t}`` into the lock file. A waiter
    declares the lock stale, and takes it over, when the recorded pid is
    dead (same host only) or the file is older than ``stale_seconds``. A
    takeover unlinks only the exact file it judged stale (inode and
    mtime), so racing reapers cannot remove each other's new locks, and
    the re-creation resolves at ``O_CREAT|O_EXCL``: one contender wins."""

    def __init__(self, path: str, *, stale_seconds: Optional[float] = None,
                 poll: float = 0.05):
        self.path = str(path)
        self.stale_seconds = (lock_stale_seconds()
                              if stale_seconds is None else stale_seconds)
        self.poll = poll
        self.held = False

    def _stale_ident(self) -> Optional[tuple]:
        """The (inode, mtime_ns) of the lock file iff it is stale."""
        try:
            st = os.stat(self.path)
        except OSError:
            return None           # vanished: the create loop retries
        ident = (st.st_ino, st.st_mtime_ns)
        age = time.time() - st.st_mtime
        if age > self.stale_seconds:
            return ident
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
        except Exception:  # noqa: BLE001 — holder died mid-write
            return ident if age > 1.0 else None
        pid, host = doc.get("pid"), doc.get("host")
        if host == socket.gethostname() and isinstance(pid, int):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return ident      # holder is gone
            except PermissionError:
                return None       # alive, another uid
        return None

    def _reap(self, ident: tuple) -> None:
        with contextlib.suppress(OSError):
            st = os.stat(self.path)
            if (st.st_ino, st.st_mtime_ns) == ident:
                os.unlink(self.path)

    def acquire(self, timeout: Optional[float] = None) -> bool:
        """Block until held (True) or ``timeout`` elapses (False: the
        caller goes on without the lock rather than hang)."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            try:
                fd = os.open(self.path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                ident = self._stale_ident()
                if ident is not None:
                    self._reap(ident)
                    continue
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                time.sleep(self.poll)
                continue
            except OSError:
                return False      # directory unwritable: degrade
            with os.fdopen(fd, "w") as fh:
                json.dump({"pid": os.getpid(),
                           "host": socket.gethostname(),
                           "t": time.time()}, fh)
            self.held = True
            return True

    def release(self) -> None:
        """Unlink only a lock this process still owns (a holder past
        ``stale_seconds`` may have been taken over)."""
        if not self.held:
            return
        self.held = False
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
        except Exception:  # noqa: BLE001 — gone or torn: nothing to free
            return
        if (doc.get("pid") == os.getpid()
                and doc.get("host") == socket.gethostname()):
            with contextlib.suppress(OSError):
                os.unlink(self.path)

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def lock_for(key: Any, dirpath: Optional[str] = None) -> FileLock:
    d = dirpath or aot_dir()
    if d is None:
        raise RuntimeError("AOT artifact store is not enabled")
    # an uncreatable store must not fail the capture: acquire() on the
    # impossible path returns False
    with contextlib.suppress(OSError):
        os.makedirs(d, exist_ok=True)
    return FileLock(os.path.join(d, key_digest(key) + ".lock"))


def list_artifacts(dirpath: Optional[str] = None) -> list[dict]:
    """Headers of every readable file in the store (inspection, the
    warmup CLI); unreadable files are skipped."""
    d = dirpath or aot_dir()
    if d is None or not os.path.isdir(d):
        return []
    out = []
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(_SUFFIX):
            continue
        try:
            out.append(read_header(os.path.join(d, fn)))
        except Exception:  # noqa: BLE001 — inspection is best-effort
            continue
    return out


__all__ = [
    "AOT_SCHEMA", "AotLoadError", "FileLock", "aot_dir", "artifact_path",
    "compat_probe", "compat_stamp", "enabled", "key_digest",
    "list_artifacts", "load", "load_file", "lock_for", "lock_timeout",
    "override_dir", "read_header", "save",
]
