"""Streaming / oversized-dataset ingestion: bounded-memory readers (the
port of libskylark_tpu/io/chunked.py).

Iterate bounded batches off a source and land them on the card, or
sharded over a mesh, never holding the whole dataset on the host. Every
reader takes a path or any iterable of text lines (a file handle, a
gzip stream, :func:`libskylark_tpu_torch.io.webhdfs.webhdfs_lines`).

:func:`prefetch_batches` overlaps the host's parse of batch k+1, and its
copy to the card, with the consumer's work on batch k. A pageable copy
waits for the stream, so the worker thread puts each batch into pinned
host memory and copies it with ``non_blocking=True`` on a side stream of
its own; the consumer's stream waits on that copy's event before the
batch is handed over, and the batch is ``record_stream``-ed on the
consumer's stream, so its memory is not reused before the consumer's
work on it has run. Pinned blocks come from torch's caching host
allocator, which does not hand a block out again before the copies that
read it have finished.

:func:`stream_sketch_libsvm` pipes the batches through
:class:`~libskylark_tpu_torch.io.streaming.StreamingCWT`, whose result is
the one-shot ``CWT.apply`` of the whole file, bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience.policy import RetryPolicy
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

ROWS = "rows"

# batch yields are counted when telemetry is on; HDF5 slice reads open
# ``io.chunked.read`` spans, so retries show on the trace
_BATCHES = _metrics.counter(
    "io.chunked.batches", "Batches yielded by the chunked readers")


def _io_retry() -> RetryPolicy:
    """Default policy of re-executable chunk reads (HDF5 slices). A
    one-shot line stream cannot re-pull a batch: its recovery is the
    WebHDFS reconnect-resume or a checkpoint-resume."""
    return RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=1.0)


def default_prefetch_depth() -> int:
    """``SKYLARK_STREAM_PREFETCH`` (default 2: the double buffer); 0
    turns the overlap off."""
    return max(0, _env.STREAM_PREFETCH.get())


class _PrefetchDone:
    """Sentinel + terminal state of a prefetch worker."""

    def __init__(self):
        self.exc: Optional[BaseException] = None


class _Mover:
    """The copy of a batch's leading array to ``device``: on the CPU a
    tensor; on the card pinned host memory, then a non-blocking copy on
    a side stream (module docstring)."""

    def __init__(self, device):
        from libskylark_tpu_torch.base.device import resolve_device

        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(self.device) if self.cuda
                       else None)

    def send(self, x):
        """(tensor on the device, event of its copy or None). A non-dense
        batch (a SparseMatrix) stays as it is."""
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x, None
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if not self.cuda:
            return t.to(self.device), None
        if t.device.type == "cpu":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            t = host
        with torch.cuda.stream(self.stream):
            dev = t.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return dev, ev

    def receive(self, dev, ev):
        """The batch, safe on the consumer's current stream."""
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            dev.record_stream(cur)
        return dev


def prefetch_batches(
    batches: Iterable[Tuple],
    depth: Optional[int] = None,
    to_device: bool = True,
    device=None,
) -> Iterator[Tuple]:
    """Double-buffered minibatch prefetch: a background thread pulls up
    to ``depth`` batches ahead of the consumer, so the host's parse (and,
    with ``to_device``, the copy of each tuple's first element to
    ``device``, default the package default) overlaps the consumer's work
    on the current batch.

    Yields exactly the input tuples in the input order, the first element
    a tensor on ``device`` when ``to_device`` (a copy moves bytes, it
    never rounds). ``depth=0`` (or ``None`` with
    ``SKYLARK_STREAM_PREFETCH=0``) passes through synchronously. A
    producer exception is raised at the consumer's position, after the
    batches before it. A consumer that abandons the iterator stops the
    worker."""
    if depth is None:
        depth = default_prefetch_depth()
    mover = _Mover(device) if to_device else None

    def move(item):
        if mover is not None and isinstance(item, tuple) and item:
            dev, ev = mover.send(item[0])
            return (dev, ev) + item[1:]
        return item

    def hand_over(item):
        if mover is not None and isinstance(item, tuple) and item:
            return (mover.receive(item[0], item[1]),) + item[2:]
        return item

    if depth <= 0:
        for item in batches:
            yield hand_over(move(item))
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = _PrefetchDone()

    def _put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            for item in batches:
                if not _put(move(item)):
                    return
        except BaseException as e:  # re-raised at the consumer
            done.exc = e
        finally:
            _put(done)

    t = threading.Thread(target=_worker, name="skylark-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if done.exc is not None:
                    raise done.exc
                return
            yield hand_over(item)
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def grid_spans(lo: int, hi: int, batch_rows: int
               ) -> Iterator[Tuple[int, int]]:
    """Split ``[lo, hi)`` on the absolute ``batch_rows`` grid: the
    boundaries are multiples of ``batch_rows`` wherever the range
    starts, so a resumed range read yields the same later boundaries.
    ``batch_rows <= 0`` yields the whole range as one span."""
    if batch_rows <= 0:
        if lo < hi:
            yield lo, hi
        return
    at = lo
    while at < hi:
        nxt = min(hi, (at // batch_rows + 1) * batch_rows)
        yield at, nxt
        at = nxt


def _is_path(source) -> bool:
    return isinstance(source, (str, bytes)) or hasattr(source, "__fspath__")


def _line_iter(source) -> Iterator[str]:
    """Path / file-like / iterable of lines → line iterator."""
    if _is_path(source):
        def gen():
            with open(source, "r") as f:
                yield from f
        return gen()
    return iter(source)


def scan_libsvm_dims(source, max_n: int = -1) -> Tuple[int, int, int]:
    """One streaming O(1)-memory pass → (n_examples, d, n_targets)."""
    n, d, nt = 0, 0, -1
    for line in _line_iter(source):
        if max_n >= 0 and n == max_n:
            break
        line = line.strip()
        if not line or line.startswith("#"):
            break
        toks = line.split()
        if nt < 0:
            nt = 0
            while nt < len(toks) and ":" not in toks[nt]:
                nt += 1
        for t in toks[nt:]:
            d = max(d, int(t.split(":", 1)[0]))
        n += 1
    return n, d, max(nt, 0)


def iter_libsvm_batches(
    source,
    batch_rows: int,
    d: Optional[int] = None,
    sparse: bool = False,
    max_n: int = -1,
    dtype=np.float32,
) -> Iterator[Tuple[Union[np.ndarray, "object"], np.ndarray]]:
    """Yield ``(X_batch, Y_batch)`` of at most ``batch_rows`` examples
    each, parsing the source incrementally (host memory: one batch).

    ``d`` must be given for a stream that can be read only once; for a
    path it defaults to a :func:`scan_libsvm_dims` pass. ``sparse=True``
    yields :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix`
    batches."""
    from libskylark_tpu_torch.base.sparse import SparseMatrix
    from libskylark_tpu_torch.io.libsvm import _parse_lines

    if d is None:
        if not _is_path(source):
            raise errors.InvalidParametersError(
                "iter_libsvm_batches over a one-shot stream needs an "
                "explicit feature dimension d (hint: scan_libsvm_dims on "
                "a separate pass/replica of the stream)")
        _, d, _ = scan_libsvm_dims(source, max_n)
    if batch_rows <= 0:
        raise errors.InvalidParametersError(f"bad batch_rows {batch_rows}")

    it = _line_iter(source)
    seen = 0
    done = False
    while not done:
        lines = []
        while len(lines) < batch_rows:
            if max_n >= 0 and seen + len(lines) >= max_n:
                done = True
                break
            try:
                line = next(it)
            except StopIteration:
                done = True
                break
            if not line.strip() or line.lstrip().startswith("#"):
                done = True
                break
            lines.append(line)
        if not lines:
            break
        # a parser or transport failure surfaces here, once per batch; no
        # retry (the line iterator is one-shot)
        faults.check("io.chunked.batch", detail=f"batch@{seen}")
        targets, indices, values, _, nt = _parse_lines(lines, -1)
        n = len(targets)
        seen += n
        Y = np.zeros((n, nt), dtype=np.float64)
        for i, y in enumerate(targets):
            Y[i, : len(y)] = y
        Yout = Y[:, 0].astype(dtype) if nt == 1 else Y.astype(dtype)
        if sparse:
            rows = np.concatenate(
                [np.full(len(ix), i, dtype=np.int64)
                 for i, ix in enumerate(indices)]
            ) if n else np.zeros(0, np.int64)
            cols = (np.concatenate(indices) if indices
                    else np.zeros(0, np.int64))
            vals = (np.concatenate(values) if values
                    else np.zeros(0, np.float64)).astype(dtype)
            if cols.size and cols.max() >= d:
                raise errors.IOError_(
                    f"feature index {cols.max() + 1} exceeds declared d={d}")
            # counted at the yield: a batch that failed to parse was
            # never handed over
            _BATCHES.inc(source="libsvm")
            yield SparseMatrix.from_coo(rows, cols, vals, (n, d)), Yout
        else:
            X = np.zeros((n, d), dtype=dtype)
            for i, (ix, v) in enumerate(zip(indices, values)):
                if ix.size and ix.max() >= d:
                    raise errors.IOError_(
                        f"feature index {ix.max() + 1} exceeds declared "
                        f"d={d}")
                X[i, ix] = v
            _BATCHES.inc(source="libsvm")
            yield X, Yout


def iter_array_batches(
    X, batch_rows: int, Y=None,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Yield ``(X_batch, Y_batch)`` row slices of in-memory arrays (a
    slice is a view, bytes unchanged), the row-batch stream the sessions
    and their bit-equality checks consume. ``Y=None`` yields
    ``(X_batch, None)``."""
    X = np.asarray(X)
    if Y is not None:
        Y = np.asarray(Y)
        if Y.shape[0] != X.shape[0]:
            raise errors.InvalidParametersError(
                f"iter_array_batches: X has {X.shape[0]} rows but Y "
                f"has {Y.shape[0]}")
    if batch_rows <= 0:
        raise errors.InvalidParametersError(f"bad batch_rows {batch_rows}")
    for lo in range(0, X.shape[0], batch_rows):
        hi = min(lo + batch_rows, X.shape[0])
        _BATCHES.inc(source="array")
        yield X[lo:hi], (Y[lo:hi] if Y is not None else None)


def iter_hdf5_batches(
    path, batch_rows: int, dtype=np.float32,
    retry: Optional[RetryPolicy] = None,
    start_row: int = 0, stop_row: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(X_batch, Y_batch)`` row slices of an HDF5 file in the
    reference's dense layout (datasets ``X`` and ``Y``). ``start_row`` /
    ``stop_row`` bound the read to a row range; the batch boundaries stay
    on the absolute ``batch_rows`` grid (:func:`grid_spans`). A slice
    read is re-executable, so a transient failure (the
    ``io.chunked.read`` fault site) retries under ``retry`` (default
    :func:`_io_retry`)."""
    from libskylark_tpu_torch.io.hdf5 import _require_h5py

    h5py = _require_h5py()
    retry = retry or _io_retry()

    def read_once(ds, lo, hi, name):
        faults.check("io.chunked.read", detail=f"{name}[{lo}:{hi}]")
        return np.asarray(ds[lo:hi], dtype=dtype)

    def read_slice(ds, lo, hi, name):
        # one span around the retry ladder: the retries' events attach
        with _trace.span("io.chunked.read",
                         attrs={"dataset": name, "lo": lo, "hi": hi}):
            return retry.call(read_once, ds, lo, hi, name)

    with h5py.File(path, "r") as f:
        X, Y = f["X"], f["Y"]
        n = X.shape[0]
        if stop_row is not None:
            n = min(n, int(stop_row))
        for lo, hi in grid_spans(max(0, int(start_row)), n, batch_rows):
            batch = (read_slice(X, lo, hi, "X"), read_slice(Y, lo, hi, "Y"))
            _BATCHES.inc(source="hdf5")
            yield batch


def read_libsvm_sharded(
    source,
    mesh,
    axis: str = ROWS,
    batch_rows: int = 4096,
    max_n: int = -1,
    dtype=np.float32,
    dims: Optional[Tuple[int, ...]] = None,
):
    """Stream a libsvm source into a row-sharded DTensor ``(X, Y)`` on
    ``mesh`` (parallel/mesh.py), the rows split over mesh dimension
    ``axis`` and replicated over the others — the reference's
    ``NamedSharding(mesh, P(axis, None))``. Every rank reads the stream
    and keeps its own rows (torch's split: ceil(n/k) rows a rank, the
    last ranks short), so a rank's host memory is one batch plus its
    block. Y is (n,) for one target, (n, nt) otherwise.

    A path is scanned first. A one-shot stream needs ``dims=(n, d)`` (or
    ``(n, d, n_targets)``) from a :func:`scan_libsvm_dims` of another
    copy of it; a stream shorter than ``dims`` raises."""
    from torch.distributed.tensor import Replicate, Shard

    from libskylark_tpu_torch.parallel import mesh as pmesh

    if dims is not None:
        n, d = int(dims[0]), int(dims[1])
        nt = int(dims[2]) if len(dims) > 2 else 1
        # an explicit smaller max_n truncates the plan itself; then the
        # read stops at n rows, so a stream that grew since the scan
        # cannot overrun the plan
        if 0 <= max_n < n:
            n = max_n
        max_n = n
    elif _is_path(source):
        n, d, nt = scan_libsvm_dims(source, max_n)
    else:
        raise errors.InvalidParametersError(
            "read_libsvm_sharded on a one-shot stream needs dims=(n, d): "
            "scan a fresh stream with scan_libsvm_dims first (paths are "
            "scanned automatically)")
    if n == 0:
        raise errors.IOError_(f"read_libsvm_sharded: no examples in "
                              f"{source!r}")
    dim = mesh.mesh_dim_names.index(axis)
    placements = [Shard(0) if i == dim else Replicate()
                  for i in range(mesh.ndim)]
    lo, hi = pmesh._range(n, mesh, placements, 0)
    y_cols = max(nt, 1)
    xs, ys = [], []
    consumed = 0
    # parse-ahead only: the rank's block moves to its device at the end
    for Xb, Yb in prefetch_batches(
            iter_libsvm_batches(source, batch_rows, d=d, max_n=max_n,
                                dtype=dtype),
            to_device=False):
        Yb = Yb.reshape(len(Xb), -1)
        a, b = max(lo - consumed, 0), min(hi - consumed, len(Xb))
        if a < b:
            xs.append(Xb[a:b])
            ys.append(Yb[a:b])
        consumed += len(Xb)
    if dims is not None and consumed < n:
        # a stream that shrank must not have its missing rows made up
        raise errors.IOError_(
            f"read_libsvm_sharded: dims promised {n} examples but the "
            f"stream yielded {consumed}")
    dev = pmesh._mesh_device(mesh)
    X_loc = torch.from_numpy(np.concatenate(xs) if xs
                             else np.zeros((0, d), dtype)).to(dev)
    Y_loc = torch.from_numpy(np.concatenate(ys) if ys
                             else np.zeros((0, y_cols), dtype)).to(dev)
    X = pmesh._from_local(X_loc, mesh, placements, (n, d))
    if nt <= 1:
        Y = pmesh._from_local(Y_loc[:, 0].contiguous(), mesh, placements,
                              (n,))
    else:
        Y = pmesh._from_local(Y_loc, mesh, placements, (n, y_cols))
    return X, Y


def stream_sketch_libsvm(
    source,
    s: int,
    context,
    batch_rows: int = 4096,
    num_classes: int = 0,
    max_n: int = -1,
    checkpoint=None,
    checkpoint_every: int = 0,
    prefetch_depth: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sketch a libsvm file down to ``s`` rows in bounded memory: chunked
    parse → :class:`StreamingCWT` on ``device`` (default: the package
    default). Equal to the one-shot ``CWT.apply`` of the whole file, bit
    for bit. ``prefetch_depth`` tunes the parse/copy overlap (default
    ``SKYLARK_STREAM_PREFETCH``).

    Needs a re-readable path (one pass sizes the streams, one sketches);
    for a one-shot stream run :func:`scan_libsvm_dims` on a copy and feed
    :func:`iter_libsvm_batches` to :class:`StreamingCWT` directly."""
    from libskylark_tpu_torch.io.streaming import StreamingCWT

    if not _is_path(source):
        raise errors.InvalidParametersError(
            "stream_sketch_libsvm needs a re-readable path (streams: "
            "scan_libsvm_dims on a replica + iter_libsvm_batches + "
            "StreamingCWT)")
    n, d, _ = scan_libsvm_dims(source, max_n)
    sk = StreamingCWT(n, s, context, device=device)
    batches = iter_libsvm_batches(source, batch_rows, d=d, max_n=max_n)
    return sk.sketch(batches, num_classes=num_classes,
                     checkpoint=checkpoint,
                     checkpoint_every=checkpoint_every,
                     prefetch_depth=prefetch_depth)


__all__ = ["ROWS", "default_prefetch_depth", "grid_spans",
           "iter_array_batches", "iter_hdf5_batches", "iter_libsvm_batches",
           "prefetch_batches", "read_libsvm_sharded", "scan_libsvm_dims",
           "stream_sketch_libsvm"]
