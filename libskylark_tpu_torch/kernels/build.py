"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc, for Hopper only (sm_90a), into
a shared library with a plain C interface, ``build/torch_kernels/
lib<name>.so`` under the checkout's root; the wrappers load it with ctypes.
A library is built at first use and again whenever its source, or a
shared header ``csrc/*.cuh``, is newer.
A failed build raises with nvcc's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from libskylark_tpu_torch.base import errors

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def build(names=None, force: bool = False) -> dict[str, dict]:
    """Build the named kernels (default: all) that are missing or stale,
    one nvcc process per source, all started together. Returns
    ``{name: {"seconds": s, "ptxas": text}}`` for what was built."""
    names = list(names) if names is not None else sources()
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
