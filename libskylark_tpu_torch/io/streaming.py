"""Streaming sketch over minibatch iterators (the port of
libskylark_tpu/io/streaming.py).

A CountSketch (CWT) applied batch by batch to an iterator of ``(X, Y)``
minibatches, giving the sketched dataset ``(S·X, S·Y)`` without ever
holding the whole data. The bucket and sign streams are the CWT's
counter streams at each batch's row offset, and each batch is added into
the carried accumulators by B2's accumulate mode (``cuda_hash.cwt_apply(
..., out=acc)``): every cell adds its rows in increasing row order, as
the one-shot scatter does, so the result is ``torch.equal`` to the
one-shot ``CWT.apply`` of the concatenated rows, on the card as on the
CPU.

The batches compute in float32: a float64 batch is rounded to float32
first, as the reference's arrays are with jax's 64-bit mode off.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import resolve_device
from libskylark_tpu_torch.ml.coding import dummy_coding, host_array
from libskylark_tpu_torch.sketch import cuda_hash
from libskylark_tpu_torch.sketch.hash import CWT

# Checkpoint digest-scheme version, the reference's: 2 = sha256 config
# identity + sample_digest of batch 0. A checkpoint recording another
# scheme refuses with a format diagnosis.
_DIGEST_SCHEME = 2


def compute_dtype(dtype) -> torch.dtype:
    """The dtype a batch or an accumulator of ``dtype`` computes in:
    float64 is float32 (the reference's arrays with jax's 64-bit mode
    off), any other dtype itself."""
    t = (dtype if isinstance(dtype, torch.dtype)
         else torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype)
    return torch.float32 if t == torch.float64 else t


def fold_cwt(key, A: torch.Tensor, acc: torch.Tensor, s_dim: int,
             n0: int) -> torch.Tensor:
    """Add the CountSketch of A's rows, the coordinates [n0, n0 + len(A))
    of the streams, into ``acc`` (s_dim, m) in place, each cell's terms
    in increasing row order: B2's accumulate mode on float32 (the plain
    scatter on the CPU). Another dtype takes the plain scatter on the
    CPU and is refused on the card, whose ``index_add_`` adds in no
    fixed order."""
    A = A.to(acc.dtype)
    if cuda_hash.supported(acc.dtype):
        return cuda_hash.cwt_apply(key, A.contiguous(), s_dim, False,
                                   n0=n0, out=acc)
    if acc.device.type != "cpu":
        raise errors.UnsupportedError(
            f"a carried CountSketch in {acc.dtype} on {acc.device} has no "
            "fixed-order fold (B2 takes float32; CUDA index_add_ adds in "
            "no fixed order)")
    return acc.copy_(cuda_hash.accumulate_plain(key, A, s_dim, acc, n0))


class StreamingCWT:
    """Sketch a stream of row-minibatches down to ``s`` rows on
    ``device`` (default: the package default).

    ``n`` is the total number of rows across the stream (the sketched
    dimension, known up front: the hash streams are over row indices).
    """

    def __init__(self, n: int, s: int, context: Context, device=None):
        self._n = int(n)
        self._s = int(s)
        self._cwt = CWT(self._n, self._s, context)
        self._device = resolve_device(device)

    @property
    def transform(self) -> CWT:
        return self._cwt

    def _identity(self, num_classes: int) -> str:
        """Resume fingerprint of the sketch configuration; the stream's
        content is checked by its first batch at resume."""
        h = hashlib.sha256()
        h.update(repr((self._n, self._s, int(num_classes))).encode())
        h.update(self._cwt.to_json().encode())
        return h.hexdigest()

    @staticmethod
    def _batch_hash(X) -> str:
        from libskylark_tpu_torch.utility.checkpoint import sample_digest

        return sample_digest(X)

    def _labels(self, Y, num_classes: int) -> torch.Tensor:
        Y = host_array(Y)
        if num_classes > 2:
            Yb, _ = dummy_coding(Y.reshape(-1),
                                 coding=list(range(num_classes)),
                                 device=self._device)
            return Yb
        Yb = torch.from_numpy(np.ascontiguousarray(Y.astype(np.float32)))
        Yb = Yb.to(self._device)
        return Yb[:, None] if Yb.ndim == 1 else Yb

    def sketch(
        self,
        batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        num_classes: int = 0,
        checkpoint=None,
        checkpoint_every: int = 0,
        prefetch_depth: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Consume ``(X, Y)`` minibatches; return ``(SX, SY)`` on the
        device.

        ``num_classes > 2`` dummy-codes the labels to ±1 one-vs-all
        before sketching. ``prefetch_depth`` sets the parse/copy overlap
        (:func:`libskylark_tpu_torch.io.chunked.prefetch_batches`;
        default ``SKYLARK_STREAM_PREFETCH``); the result is the same
        bits with or without it.

        ``checkpoint`` (a directory or a
        :class:`~libskylark_tpu_torch.utility.TrainCheckpointer`) saves
        the accumulators every ``checkpoint_every`` batches; a rerun over
        the same directory re-reads the stream past the rows already
        folded (without sketching them again) and continues, ending
        ``torch.equal`` to the uninterrupted pass. A resume refuses a
        different configuration or first batch, a batch that straddles
        the saved row offset, and a stream that ends before it."""
        from libskylark_tpu_torch.io.chunked import prefetch_batches

        key = self._cwt.kernel_key()
        SX: Optional[torch.Tensor] = None
        SY: Optional[torch.Tensor] = None
        row0 = 0

        ckpt = None
        ckpt_owned = False
        ident = None
        resume_rows = 0         # rows already folded into (SX, SY)
        last_saved = -1         # step of the newest save in the loop
        saved_b0 = None         # batch-0 hash recorded at the first save
        b0 = None               # batch-0 hash of this pass
        if checkpoint is not None:
            from libskylark_tpu_torch.utility.checkpoint import (
                TrainCheckpointer, as_checkpointer)

            ident = self._identity(num_classes)
            ckpt_owned = not isinstance(checkpoint, TrainCheckpointer)
            ckpt = as_checkpointer(checkpoint)

        try:
            if ckpt is not None and ckpt.latest_step() is not None:
                step0, meta = ckpt.metadata()
                scheme = meta.get("digest_scheme")
                if scheme is not None and scheme != _DIGEST_SCHEME:
                    raise errors.InvalidParametersError(
                        f"checkpoint was written under digest scheme "
                        f"{scheme}; this build uses {_DIGEST_SCHEME} — "
                        "stream identity cannot be compared across "
                        "schemes; re-ingest from scratch")
                if meta.get("identity") != ident:
                    raise errors.InvalidParametersError(
                        "checkpoint belongs to a different streaming "
                        "sketch (n/s/context/num_classes differ) — "
                        "refusing to resume")
                resume_rows = int(meta["rows"])
                saved_b0 = meta.get("batch0_hash")
                if saved_b0 is not None and not isinstance(saved_b0, str):
                    raise errors.InvalidParametersError(
                        "checkpoint was written by an older build "
                        "(float batch-0 fingerprint); stream identity "
                        "cannot be verified — re-ingest from scratch")
                _, state, _ = ckpt.restore(step0)
                SX = torch.from_numpy(state["SX"]).to(self._device)
                SY = torch.from_numpy(state["SY"]).to(self._device)
                if resume_rows >= self._n:
                    return self._finish(SX, SY)
            row0 = resume_rows

            batches_seen = 0
            rows_scanned = 0
            # a resume discards the folded batches: the worker only parses
            # them, and the kept ones move below
            for X, Y in prefetch_batches(batches, depth=prefetch_depth,
                                         to_device=resume_rows == 0,
                                         device=self._device):
                nb = int(X.shape[0])
                if rows_scanned == 0 and ckpt is not None:
                    b0 = self._batch_hash(X)
                    if saved_b0 is not None and b0 != saved_b0:
                        raise errors.InvalidParametersError(
                            "checkpoint belongs to a different stream "
                            "(first batch differs) — refusing to resume")
                rows_scanned += nb
                if rows_scanned <= resume_rows:
                    continue        # fast-forward past folded-in rows
                if rows_scanned - nb < resume_rows:
                    raise errors.InvalidParametersError(
                        f"stream batching changed across runs: a batch "
                        f"straddles the checkpointed row offset "
                        f"{resume_rows} — refusing to resume")
                if row0 + nb > self._n:
                    raise ValueError(
                        f"stream longer than declared n={self._n}")
                X = (X if isinstance(X, torch.Tensor)
                     else torch.from_numpy(np.asarray(X)))
                X = X.to(self._device, compute_dtype(X.dtype))
                Yb = self._labels(Y, num_classes)
                if SX is None:
                    SX = torch.zeros((self._s, X.shape[1]), dtype=X.dtype,
                                     device=self._device)
                    SY = torch.zeros((self._s, Yb.shape[1]),
                                     dtype=Yb.dtype, device=self._device)
                fold_cwt(key, X, SX, self._s, row0)
                fold_cwt(key, Yb, SY, self._s, row0)
                row0 += nb
                batches_seen += 1
                if ckpt is not None and checkpoint_every > 0 \
                        and batches_seen % int(checkpoint_every) == 0 \
                        and row0 < self._n:
                    self._save(ckpt, ident, row0, SX, SY, b0)
                    last_saved = row0
            if rows_scanned < resume_rows:
                # the stream ended before the saved offset: a truncated or
                # different stream. Ending exactly at it is a consistent
                # no-progress rerun.
                raise errors.InvalidParametersError(
                    f"stream ended at {rows_scanned} rows, before the "
                    f"checkpointed offset {resume_rows} — truncated or "
                    "different stream; refusing to resume")
            if SX is None:
                raise ValueError("empty stream")
            if ckpt is not None and row0 > resume_rows \
                    and row0 != last_saved:
                self._save(ckpt, ident, row0, SX, SY, b0)
            return self._finish(SX, SY)
        finally:
            if ckpt is not None and ckpt_owned:
                ckpt.close()

    @staticmethod
    def _save(ckpt, ident, rows, SX, SY, b0) -> None:
        ckpt.save(int(rows), {"SX": SX, "SY": SY},
                  {"identity": ident, "rows": int(rows),
                   "batch0_hash": b0, "digest_scheme": _DIGEST_SCHEME})

    @staticmethod
    def _finish(SX, SY):
        if SY.shape[1] == 1:
            SY = SY[:, 0]
        return SX, SY


__all__ = ["StreamingCWT", "compute_dtype", "fold_cwt"]
