"""Build and load the port's CUDA kernels and its host libraries.

Each ``csrc/<name>.cu`` compiles with nvcc, for Hopper only (sm_90a), into
a shared library with a plain C interface, ``build/torch_kernels/
lib<name>.so`` under the checkout's root; the wrappers load it with ctypes.
A library is built at first use and again whenever its source, or a
shared header ``csrc/*.cuh``, is newer.
A failed build raises with nvcc's output: nothing falls back.

Each ``csrc/<name>.cpp`` is host code (the IO parsers), built by g++ into
``build/torch_host/lib<name>.so`` at first use (:func:`load_host`). Its
callers keep the reference's contract: without a toolchain, or when the
build fails, :func:`load_host` returns None and they take their Python
version.

Processes that share a checkout build each library once: a build holds
the library's file lock (``lib<name>.lock`` beside it, an
``engine.aot.FileLock``), and a process that waited on it finds the
library fresh and loads it. The threads of one process share the
named lock ``kernels.build`` (``base.locks.make_lock``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "torch_host"
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = _locks.make_lock("kernels.build")
_libs: dict[str, ctypes.CDLL] = {}
_host_libs: dict[str, ctypes.CDLL | None] = {}


class KernelBuildError(errors.UnsupportedError):
    """A CUDA kernel failed to build (nvcc missing or compile error)."""


def sources() -> list[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.isfile(c):
            return c
    raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header in csrc/."""
    so = library_path(name)
    if not so.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return so.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def _file_locks(paths) -> list:
    """The cross-process locks of ``paths``' libraries, taken in name
    order (two builders of overlapping sets cannot deadlock); one not won
    within ``SKYLARK_AOT_LOCK_TIMEOUT`` is gone without."""
    from libskylark_tpu_torch.engine.aot import FileLock, lock_timeout

    held = []
    for p in sorted(str(p) for p in paths):
        lock = FileLock(p + ".lock")
        if lock.acquire(timeout=lock_timeout()):
            held.append(lock)
    return held


def build(names=None, force: bool = False) -> dict[str, dict]:
    """Build the named kernels (default: all) that are missing or stale,
    one nvcc process per source, all started together, under each
    library's file lock: a library a peer process built while this one
    waited is not built again (unless ``force``). Returns ``{name:
    {"seconds": s, "ptxas": text}}`` for what was built."""
    names = list(names) if names is not None else sources()
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    locks = _file_locks(library_path(n) for n in todo)
    try:
        if not force:
            todo = [n for n in todo if _stale(n)]
        return _build(todo) if todo else {}
    finally:
        for lock in locks:
            lock.release()


def _build(todo: list) -> dict[str, dict]:
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f".lib{n}.{os.getpid()}.so"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    report, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(n))
        report[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def host_library_path(name: str) -> Path:
    return HOST_BUILD_DIR / f"lib{name}.so"


def build_host(name: str, force: bool = False) -> Path:
    """Build ``csrc/<name>.cpp`` with g++ when its library is missing or
    older than the source, under the library's file lock (as
    :func:`build`); raises KernelBuildError with g++'s output."""
    src, so = CSRC / f"{name}.cpp", host_library_path(name)

    def fresh() -> bool:
        return (not force and so.exists()
                and so.stat().st_mtime >= src.stat().st_mtime)

    if fresh():
        return so
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise KernelBuildError("g++ not found on PATH")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    locks = _file_locks([so])
    try:
        if fresh():
            return so
        return _build_host(gxx, name, src, so)
    finally:
        for lock in locks:
            lock.release()


def _build_host(gxx: str, name: str, src: Path, so: Path) -> Path:
    tmp = HOST_BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    p = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"g++ failed for {name}.cpp (exit {p.returncode}):\n{p.stderr}")
    os.replace(tmp, so)
    return so


def load_host(name: str) -> ctypes.CDLL | None:
    """The loaded host library ``name``, built first if needed; None when
    it cannot be built or loaded."""
    with _lock:
        if name not in _host_libs:
            try:
                _host_libs[name] = ctypes.CDLL(str(build_host(name)))
            except (KernelBuildError, OSError, subprocess.SubprocessError):
                _host_libs[name] = None
        return _host_libs[name]
