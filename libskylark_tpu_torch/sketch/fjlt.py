"""RFUT (randomized fast unitary transform) and FJLT (the port of
libskylark_tpu/sketch/fjlt.py).

RFUT: X → F·D·X, D a Rademacher diagonal (sub-stream 0) and F a fast
unitary transform (sketch/fut.py) scaled to near-orthonormality.
FJLT: S = √(N/S_dim)·R·F·D — mix with the RFUT, then keep S_dim
coordinates drawn uniformly (sub-stream 1). With the ``wht`` mixer this
is the SRHT: a float32 operand with N a power of two ≥ 128 and
S_dim ≤ 2048 takes the panel-free SRHT kernel's route (sketch/cuda_fwht.py),
kernel B5 on a CUDA tensor and its plain version on a CPU tensor; other
shapes take the plain chain, as the reference's own kernel declines them.
A DTensor split on the sketched axis is first laid out split on the kept
axis by one all-to-all (``parallel.mesh._exchange``), then each rank
mixes (RFUT) or sketches (FJLT) its block (sketch/dtensor_apply.py
``WholeAxis``).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.sketch import cuda_fwht
from libskylark_tpu_torch.sketch import fut as fut_mod
from libskylark_tpu_torch.sketch.dtensor_apply import WholeAxis
from libskylark_tpu_torch.sketch.transform import (SketchTransform, register,
                                                   seeded)


def srht_serve_apply(key_data, A: torch.Tensor, *, s_dim: int,
                     rowwise: bool) -> torch.Tensor:
    """The panel-free SRHT as a function of the raw key data ((2,)
    uint32): the same streams as ``FJLT(n, s_dim, fut="wht")``'s
    ``diagonal()``/``sample_indices()``, contracted through the FWHT. n
    (the transform axis) must be a power of two."""
    n = A.shape[1] if rowwise else A.shape[0]
    if n & (n - 1):
        raise errors.InvalidParametersError(
            f"SRHT serve requires power-of-2 n, got {n}")
    if cuda_fwht.supported(n, s_dim, A.dtype):
        return cuda_fwht.srht_apply(key_data, A.contiguous(), s_dim, rowwise)
    return cuda_fwht.srht_apply_plain(key_data, A, s_dim, rowwise)


def _popcount_parity(a: np.ndarray) -> np.ndarray:
    """Elementwise popcount parity of a uint64 array: ``np.bitwise_count``
    where numpy has it (2.0 on), else the xor-fold."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(a) & np.uint64(1)
    for shift in (32, 16, 8, 4, 2, 1):
        a = a ^ (a >> np.uint64(shift))
    return a & np.uint64(1)


@register
class RFUT(WholeAxis, SketchTransform):
    """X → F·D·X (output dim == input dim), D Rademacher."""

    sketch_type = "RFUT"

    def __init__(self, N, S=None, context=None, fut: str = "dct"):
        # RFUT keeps the dimension; (N, context) is accepted too
        if context is None:
            context, S = S, N
        self._fut_name = fut
        self._fut = fut_mod.make_fut(fut, N)
        super().__init__(N, N, context)

    @seeded
    def diagonal(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return randgen.stream_slice(self.subkey(0), randgen.Rademacher(), 0,
                                    self._N, dtype, device)

    def _apply_columnwise(self, A):
        D = self.diagonal(A.dtype, A.device)
        return self._fut.apply(self._fut.scale() * D[:, None] * A, axis=0)

    def _apply_rowwise(self, A):
        D = self.diagonal(A.dtype, A.device)
        return self._fut.apply(self._fut.scale() * D[None, :] * A, axis=1)

    def _extra_params(self) -> dict[str, Any]:
        return {"fut": self._fut_name}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, alloc, fut=d.get("fut", "dct"))


@register
class FJLT(WholeAxis, SketchTransform):
    """Fast Johnson-Lindenstrauss transform: subsampled randomized
    DCT/DHT/WHT."""

    sketch_type = "FJLT"

    def __init__(self, N, S, context, fut: str = "dct"):
        self._fut_name = fut
        self._fut = fut_mod.make_fut(fut, N)
        self._panel_idx_cache = None
        super().__init__(N, S, context)

    @seeded
    def diagonal(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The Rademacher mixing diagonal (sub-stream 0)."""
        return randgen.stream_slice(self.subkey(0), randgen.Rademacher(), 0,
                                    self._N, dtype, device)

    @seeded
    def sample_indices(self, device=None) -> torch.Tensor:
        """The S_dim sampled coordinates (sub-stream 1), int64."""
        return randgen.stream_slice(
            self.subkey(1), randgen.UniformInt(0, self._N - 1), 0, self._S,
            device=device)

    def _host_sample_indices(self) -> np.ndarray:
        """Host uint64 copy of :meth:`sample_indices`, memoized: the
        panel oracle and the panel-free fold gather from the same
        array."""
        if self._panel_idx_cache is None:
            self._panel_idx_cache = self.sample_indices().numpy().astype(
                np.uint64)
        return self._panel_idx_cache

    def _check_wht(self, what: str) -> None:
        if self._fut_name != "wht":
            raise errors.UnsupportedError(
                f"{what} is closed-form only for the 'wht' "
                f"(Sylvester-Hadamard) mixer, not {self._fut_name!r}")

    def operator_panel(self, col_start: int, col_stop: int,
                       dtype=np.float32, diagonal=None) -> np.ndarray:
        """Columns [col_start, col_stop) of the sampled-WHT operator, in
        closed form on the host: S[k, j] = D[j]·(−1)^popcount(idx_k & j)
        / √s. ``diagonal``, when given, is the FULL host diagonal, of
        which only the slice is read."""
        self._check_wht("operator_panel")
        dt = np.dtype(dtype)
        idx = self._host_sample_indices()
        cols = np.arange(col_start, col_stop, dtype=np.uint64)
        par = _popcount_parity(idx[:, None] & cols[None, :])
        signs = (1.0 - 2.0 * par).astype(dt)
        if diagonal is not None:
            diag = np.asarray(diagonal, dtype=dt)[col_start:col_stop]
        else:
            diag = randgen.stream_slice(
                self.subkey(0), randgen.Rademacher(), col_start,
                col_stop).numpy().astype(dt)
        return (signs * diag) / np.asarray(math.sqrt(self._S), dt)

    def fold_rows(self, X, row_start: int, row_stop: int,
                  dtype=torch.float32, diagonal=None) -> torch.Tensor:
        """``operator_panel(row_start, row_stop) @ X`` without the panel:
        the range splits into ≤ 2·log2(n) aligned power-of-two blocks
        [b, b+L), and within one popcount(idx_k & (b+j)) =
        popcount(idx_k & b) + popcount((idx_k mod L) & j), so the block
        adds (−1)^popcount(idx_k & b)·FWHT_L(D_blk ⊙ X_blk)[idx_k mod L].
        ``diagonal`` follows :meth:`operator_panel`'s contract."""
        self._check_wht("fold_rows")
        lo, hi = int(row_start), int(row_stop)
        X = torch.as_tensor(X).to(dtype)
        if X.shape[0] != hi - lo:
            raise errors.InvalidParametersError(
                f"operand rows {X.shape[0]} != range extent {hi - lo}")
        idx = self._host_sample_indices()
        out = torch.zeros((self._S,) + tuple(X.shape[1:]), dtype=dtype,
                          device=X.device)
        off = lo
        while off < hi:
            block = 1 << ((hi - off).bit_length() - 1)
            if off:
                block = min(block, off & -off)
            par = _popcount_parity(idx & np.uint64(off))
            signs = torch.from_numpy(1.0 - 2.0 * par).to(dtype=dtype,
                                                          device=X.device)
            gidx = torch.from_numpy(
                (idx & np.uint64(block - 1)).astype(np.int64)).to(X.device)
            if diagonal is not None:
                d = torch.as_tensor(np.asarray(diagonal)[off:off + block]).to(
                    dtype=dtype, device=X.device)
            else:
                d = randgen.stream_slice(self.subkey(0), randgen.Rademacher(),
                                         off, off + block, dtype, X.device)
            w = d.reshape((-1,) + (1,) * (X.ndim - 1)) * X[off - lo:
                                                           off - lo + block]
            if block > 1:
                w = fut_mod.fwht(w, axis=0)
            s = signs.reshape((-1,) + (1,) * (X.ndim - 1))
            out = out + s * w.index_select(0, gidx)
            off += block
        return (1.0 / math.sqrt(self._S)) * out

    def _kernel_serves(self, A: torch.Tensor) -> bool:
        return self._fut_name == "wht" and cuda_fwht.supported(
            self._N, self._S, A.dtype)

    def _apply(self, A: torch.Tensor, rowwise: bool) -> torch.Tensor:
        if self._kernel_serves(A):
            return cuda_fwht.srht_apply(self.kernel_key(), A.contiguous(),
                                        self._S, rowwise)
        axis = 1 if rowwise else 0
        D = self.diagonal(A.dtype, A.device)
        D = D[None, :] if rowwise else D[:, None]
        mixed = self._fut.apply(self._fut.scale() * D * A, axis=axis)
        scale = math.sqrt(self._N / self._S)
        return scale * mixed.index_select(axis,
                                          self.sample_indices(A.device))

    def _apply_columnwise(self, A):
        return self._apply(A, rowwise=False)

    def _apply_rowwise(self, A):
        return self._apply(A, rowwise=True)

    def _extra_params(self) -> dict[str, Any]:
        return {"fut": self._fut_name}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, fut=d.get("fut", "dct"))
