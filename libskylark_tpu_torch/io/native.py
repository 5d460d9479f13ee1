"""The native parsers: ctypes bindings of the port's ``csrc/io_parsers.cpp``
(the port of libskylark_tpu/io/native.py).

The library is built by g++ at first use (kernels/build.py
``load_host``); the port never loads the JAX package's library. Each
entry point returns None when the library cannot be built or loaded,
which tells the caller to take its Python parser, as in the reference.
``runs`` counts which parser each read took.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.kernels.launch import count

# reads by the parser that took them (count_run)
runs = {"native": 0, "python": 0}

_LIB = None
_TRIED = False

_LL = ctypes.c_longlong
_PLL = ctypes.POINTER(ctypes.c_longlong)


def _array(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


def _load():
    """The bound library, or None; tried once per process."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from libskylark_tpu_torch.kernels import build

    lib = build.load_host("io_parsers")
    if lib is None:
        return None
    lib.sl_libsvm_count.restype = ctypes.c_int
    lib.sl_libsvm_count.argtypes = [ctypes.c_char_p, _LL, _PLL, _PLL, _PLL,
                                    _PLL, _LL]
    lib.sl_libsvm_fill.restype = ctypes.c_int
    lib.sl_libsvm_fill.argtypes = [
        ctypes.c_char_p, _LL, _LL, _LL, _LL, _array(np.float64),
        _array(np.int64), _array(np.int64), _array(np.float64)]
    lib.sl_arclist_count.restype = ctypes.c_int
    lib.sl_arclist_count.argtypes = [ctypes.c_char_p, _LL, _PLL]
    lib.sl_arclist_fill.restype = ctypes.c_int
    lib.sl_arclist_fill.argtypes = [
        ctypes.c_char_p, _LL, _LL, _array(np.int64), _array(np.int64),
        _array(np.float64)]
    _LIB = lib
    return _LIB


def count_run(took_native: bool) -> None:
    """Count one read by the parser it took."""
    count(runs, "native" if took_native else "python")


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _read_bytes(source) -> bytes:
    if hasattr(source, "read"):
        data = source.read()
        if hasattr(source, "seek"):
            source.seek(0)
        return data.encode() if isinstance(data, str) else data
    with open(source, "rb") as f:
        return f.read()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise errors.IOError_(f"native {what} failed (code {rc})")


def parse_libsvm(source, max_n: int = -1) -> Optional[tuple]:
    """Native libsvm parse → ``(targets, indices, values, d, nt)``, the
    per-line lists of the Python parser (0-based indices), or None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    data = _read_bytes(source)
    n, nt, d, nnz = (ctypes.c_longlong() for _ in range(4))
    _check(lib.sl_libsvm_count(data, len(data), ctypes.byref(n),
                               ctypes.byref(nt), ctypes.byref(d),
                               ctypes.byref(nnz), int(max_n)),
           "libsvm parse")
    n, nt, d, nnz = n.value, nt.value, d.value, nnz.value
    Y = np.zeros(n * max(nt, 1), dtype=np.float64)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    colind = np.zeros(max(nnz, 1), dtype=np.int64)
    values = np.zeros(max(nnz, 1), dtype=np.float64)
    _check(lib.sl_libsvm_fill(data, len(data), n, nt, nnz, Y, rowptr,
                              colind, values), "libsvm fill")
    targets = [Y[i * nt:(i + 1) * nt] for i in range(n)]
    indices = [colind[rowptr[i]:rowptr[i + 1]] for i in range(n)]
    vals = [values[rowptr[i]:rowptr[i + 1]] for i in range(n)]
    return targets, indices, vals, int(d), int(nt)


def parse_arc_list(source) -> Optional[tuple]:
    """Native arc-list parse → ``(src, dst, w)`` numpy arrays, or None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    data = _read_bytes(source)
    ne = ctypes.c_longlong()
    _check(lib.sl_arclist_count(data, len(data), ctypes.byref(ne)),
           "arc-list parse")
    ne = ne.value
    src = np.zeros(max(ne, 1), dtype=np.int64)
    dst = np.zeros(max(ne, 1), dtype=np.int64)
    w = np.zeros(max(ne, 1), dtype=np.float64)
    _check(lib.sl_arclist_fill(data, len(data), ne, src, dst, w),
           "arc-list fill")
    return src[:ne], dst[:ne], w[:ne]
