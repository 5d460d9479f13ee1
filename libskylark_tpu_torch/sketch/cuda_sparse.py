"""CountSketch of CSR lanes: the wrappers of csrc/sparse_sketch.cu, their
plain version, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_sparse.py (``_sparse_call``,
"exact" mode): for each lane of a stacked cohort of CSR operands, given as
per-nonzero (data, row, col) lanes in CSR row-major order (rows expanded
from the indptr by ``sparse_serve.csr_row_ids``, so non-decreasing),
out[r, h[c]] += v[c]·val rowwise and out[h[r], c] += v[r]·val
columnwise, with h = UniformInt(0, s−1) of sub-stream 0 and v = Rademacher
of sub-stream 1 of the lane's key at the hashed coordinate. The kernel
adds each cell's terms in CSR row-major order, as the plain scatter does
on the CPU, and every v·val is exact: the two are bit-equal.

Rules of the wrappers:

- a CPU tensor takes the plain version, :func:`cwt_sparse_plain`
  (``sparse_serve.cwt_scatter_rows`` lane by lane);
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.sketch import sparse_serve
from libskylark_tpu_torch.sketch.cuda_dense import lane_keys

launches = {"sparse_rowwise": 0, "sparse_columnwise": 0}

# rows per sort tile of the columnwise kernel (csrc/sparse_sketch.cu:
# kRunTile)
RUN_TILE = 2048

_lib = None


def rowwise_chunks(n: int) -> int:
    """Stream chunks of n hashed columns: the rows of the rowwise kernel's
    chunk table (one per 4096 columns, ``randgen.CHUNK``)."""
    return -(-int(n) // randgen.CHUNK)


def chunk_table(key_data, n: int) -> np.ndarray:
    """The rowwise kernel's chunk table of one lane, on the host: for each
    chunk c of n hashed columns, randint's low-draw key
    fold_in(chunk_key(kh, c), 1) and high-draw key fold_in(chunk_key(kh,
    c), 0), then the value stream's chunk_key(kv, c), with kh, kv =
    fold_in(key, 0), fold_in(key, 1): a (chunks, 6) uint32 array (the
    kernel pads each entry to eight words)."""
    k = np.asarray(key_data, dtype=np.uint32).reshape(1, 2)
    c = rowwise_chunks(n)
    kh = randgen.chunk_keys_batched(randgen.fold_in_batched(k, 0), 0, c)[0]
    kv = randgen.chunk_keys_batched(randgen.fold_in_batched(k, 1), 0, c)[0]
    hi = randgen.fold_in_batched(kh, 0)
    lo = randgen.fold_in_batched(kh, 1)
    return np.concatenate([lo, hi, kv], axis=1)


def hash_columns(table: np.ndarray, cols, s_dim: int):
    """(h, v) of the columns ``cols`` from a :func:`chunk_table`, as the
    rowwise kernel derives them per nonzero: two stream words (three when
    randint's multiplier is not zero) at p = col mod 4096 under the
    column's chunk keys. h int64, v float32 ±1."""
    from libskylark_tpu_torch.base import threefry as tf

    cols = np.asarray(cols, dtype=np.int64)
    t = table.astype(np.int64)[cols // randgen.CHUNK]
    p = cols % randgen.CHUNK

    def word(k0, k1):
        x0, x1 = tf.threefry2x32(k0, k1, np.zeros_like(p), p)
        return (x0 ^ x1) & tf.MASK32

    h = word(t[:, 0], t[:, 1]) % s_dim
    mult = randgen.randint_multiplier(s_dim)
    if mult:
        h = ((((word(t[:, 2], t[:, 3]) % s_dim) * mult) & tf.MASK32) + h) \
            & tf.MASK32
        h = h % s_dim
    v = np.where(word(t[:, 4], t[:, 5]) >> 31, -1.0, 1.0).astype(np.float32)
    return torch.from_numpy(h), torch.from_numpy(v)


def supported(dtype) -> bool:
    """The kernel's dispatch rule: float32 values."""
    return dtype == torch.float32


def cwt_sparse_plain(key_data, data: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, s_dim: int, rowwise: bool,
                     shape: tuple) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the lanes' scatters one by
    one, each in CSR row-major order on the CPU."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    return torch.stack([sparse_serve.cwt_scatter_rows(
        kd[i], data[i], rows[i], cols[i], s_dim=s_dim, rowwise=rowwise,
        shape=shape) for i in range(data.shape[0])])


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("sparse_sketch")
        p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
        lib.sk_sparse_rowwise.argtypes = [p] * 7 + [i64] * 5 + [u32, p]
        lib.sk_sparse_columnwise.argtypes = [p] * 8 + [i64] * 5 + [u32, p]
        for fn in (lib.sk_sparse_rowwise, lib.sk_sparse_columnwise):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def cwt_sparse_apply_batched(key_data, data: torch.Tensor,
                             rows: torch.Tensor, cols: torch.Tensor,
                             s_dim: int, rowwise: bool,
                             shape: tuple) -> torch.Tensor:
    """CountSketch of B stacked CSR lanes: ``data``/``rows``/``cols`` (B,
    nnz_pad), ``key_data`` (B, 2) uint32 words, ``shape`` the lanes'
    padded (rows, cols). Returns (B, rows, s_dim) rowwise, (B, s_dim,
    cols) columnwise. Lane b's result does not depend on B."""
    from libskylark_tpu_torch.kernels import launch

    launch.refuse_dtensor(data, rows, cols)
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    if not supported(data.dtype):
        raise errors.UnsupportedError(
            f"sparse CountSketch kernel takes float32, got {data.dtype}")
    if (data.ndim != 2 or rows.shape != data.shape or cols.shape != data.shape
            or kd.shape[0] != data.shape[0] or s_dim <= 0):
        raise errors.InvalidParametersError(
            f"need (B, nnz) data, rows and cols, B keys and s_dim > 0; got "
            f"{tuple(data.shape)}, {tuple(rows.shape)}, {tuple(cols.shape)},"
            f" {kd.shape[0]} keys, s_dim={s_dim}")
    if data.device.type == "cpu":
        return cwt_sparse_plain(kd, data, rows, cols, s_dim, rowwise, shape)
    if data.device.type != "cuda":
        raise errors.UnsupportedError(
            f"sparse CountSketch kernel runs on CUDA or CPU, got "
            f"{data.device}")
    B, nnz = data.shape
    n_rows, n_cols = int(shape[0]), int(shape[1])
    m = n_rows if rowwise else n_cols
    dev = data.device
    # both kernels write every cell
    shape_out = (B, m, s_dim) if rowwise else (B, s_dim, m)
    out = torch.empty(shape_out, dtype=torch.float32, device=dev)
    if B == 0 or nnz == 0:
        return out.zero_()
    data = data.contiguous()
    rows = rows.to(torch.int32).contiguous()
    cols = cols.to(torch.int32).contiguous()
    keys = lane_keys(kd, dev)
    mult = randgen.randint_multiplier(s_dim)
    lib = _load()
    if rowwise:
        # one scratch tensor: end (B ints, zeroed), then the chunk table at
        # a 16-byte boundary
        head = -(-B // 4) * 4
        scratch = torch.zeros(head + B * rowwise_chunks(n_cols) * 8,
                              dtype=torch.int32, device=dev)
        launch.call(lib.sk_sparse_rowwise, dev, keys, data, rows, cols, out,
                    scratch, launch.ptr(scratch) + 4 * head, B, nnz, m,
                    n_cols, s_dim, mult)
    else:
        end = torch.zeros(B, dtype=torch.int32, device=dev)
        slots = -(-n_rows // RUN_TILE) * RUN_TILE
        bucket = torch.empty((B, slots), dtype=torch.int32, device=dev)
        runs = torch.empty((B, slots, 4), dtype=torch.int32, device=dev)
        launch.call(lib.sk_sparse_columnwise, dev, keys, data, rows, cols,
                    out, end, bucket, runs, B, nnz, n_rows, m, s_dim, mult)
    launch.count(launches,
                 "sparse_rowwise" if rowwise else "sparse_columnwise")
    return out


def cwt_sparse_apply(key_data, data: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, s_dim: int, rowwise: bool,
                     shape: tuple) -> torch.Tensor:
    """One lane: :func:`cwt_sparse_apply_batched` at B = 1 (the same bits
    as any lane of a larger launch)."""
    return cwt_sparse_apply_batched(
        np.asarray(key_data, dtype=np.uint32).reshape(1, 2), data[None],
        rows[None], cols[None], s_dim, rowwise, shape)[0]
