"""Shard plans: distributed sketching as re-executable units of work
(the port of libskylark_tpu/dist/plan.py).

Sketching transforms are linear, so the sketch of row-sharded data is a
merge of per-shard partial sketches computed independently:
CountSketch, JLT and SRHT partials **add**, sampler (UST) partials
**place** their rows (each output row is owned by exactly one input
shard). A row shard is so a recomputable, idempotent unit of work:

- **re-execution is bit-equal anywhere**: a shard's operator slice is a
  positional function of ``(plan seed, row range)`` (the counter
  streams, ``DenseTransform.s_panel``, ``FJLT.fold_rows``), so any
  executor, or the same one after a crash, recomputes the partial
  exactly;
- **merge order is invariant**: :func:`merge_partials` takes the shards
  in ascending index and reduces them through a fixed pairwise tree, so
  the merged bits depend only on which shards are present;
- **loss is quantified**: a lost shard leaves a valid sketch of the
  surviving rows, and :func:`build_result` reports the exact
  ``coverage`` and the missing row ranges.

A shard's additive fold is the session fold,
:func:`libskylark_tpu_torch.sessions.state.fold_sketch`: ``cwt`` adds
through B2's accumulate mode at the batch's row offset, ``jlt`` adds
``s_panel(lo, hi) @ X`` at the solver precision, ``srht`` adds
``FJLT.fold_rows``; ``ust`` collects its owned sampled rows. Partials, merges and results are tensors on
the compute device (the package default unless ``device=`` names one);
a partial that crossed a process (a fleet process replica's shard task)
arrives as host arrays, and :func:`partial_on` puts it on the merging
device (ROADMAP C24, C28).

The merged result of the full shard set equals :func:`sketch_local`,
the one-shot execution of the same plan in one process, bit for bit,
whatever failed and wherever shards ran.

Fault sites (:mod:`libskylark_tpu_torch.resilience.faults`):
``dist.shard`` at the entry of a shard task, ``dist.ingest`` once per
ingested batch (a transient ingest failure resumes at the consumed
offset), ``dist.merge`` at the entry of a merge.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
# one grid, one implementation: the absolute-batch-boundary invariant
# (bit-equal resume) is io/chunked's — every range reader shares it
from libskylark_tpu_torch.io.chunked import grid_spans as _grid_spans
from libskylark_tpu_torch.ml.coding import host_array
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience.policy import RetryPolicy

KINDS = ("cwt", "jlt", "srht", "ust")

#: kinds whose partials merge by addition (vs ``ust`` placement)
ADDITIVE_KINDS = ("cwt", "jlt", "srht")


def _ingest_retry() -> RetryPolicy:
    """Default policy for mid-shard ingest resume: transient read
    failures back off and re-enter the source at the consumed offset
    (the accumulator is carried — nothing already folded recomputes)."""
    return RetryPolicy(max_attempts=4, base_delay=0.05, max_delay=1.0)


# ---------------------------------------------------------------------------
# the plan: row ranges + transform identity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The (pickleable, JSON-able) identity of one distributed sketch:
    everything a replica needs to compute any shard's partial bit-
    exactly. ``n`` is the total row extent, ``s_dim`` the sketch
    dimension, ``d`` the row width, ``seed`` the transform Context
    seed, ``targets`` the Y columns sketched alongside (0: X only).
    ``shard_rows`` pins the rows per shard task (0 defers to
    ``SKYLARK_DIST_SHARD_ROWS``)."""

    kind: str
    n: int
    s_dim: int
    d: int
    seed: int = 0
    dtype: str = "float32"
    targets: int = 0
    shard_rows: int = 0
    replace: bool = True          # ust: sample with replacement

    def validate(self) -> "ShardPlan":
        if self.kind not in KINDS:
            raise errors.InvalidParametersError(
                f"unknown shard-plan kind {self.kind!r}; expected one "
                f"of {KINDS}")
        if self.n < 1 or self.s_dim < 1 or self.d < 1:
            raise errors.InvalidParametersError(
                f"shard-plan dims must be positive, got n={self.n} "
                f"s_dim={self.s_dim} d={self.d}")
        if self.kind == "srht" and self.n & (self.n - 1):
            raise errors.InvalidParametersError(
                f"srht shard plans need n a power of two (WHT length), "
                f"got {self.n}")
        if self.shard_rows < 0 or self.targets < 0:
            raise errors.InvalidParametersError(
                f"shard_rows/targets must be >= 0, got "
                f"{self.shard_rows}/{self.targets}")
        return self

    # -- shard geometry -------------------------------------------------

    @property
    def rows_per_shard(self) -> int:
        return int(self.shard_rows) or int(_env.DIST_SHARD_ROWS.get())

    @property
    def num_shards(self) -> int:
        return -(-self.n // self.rows_per_shard)

    def shard_range(self, index: int) -> Tuple[int, int]:
        """Global row range ``[lo, hi)`` of shard ``index``."""
        if not 0 <= index < self.num_shards:
            raise errors.InvalidParametersError(
                f"shard index {index} out of range "
                f"[0, {self.num_shards})")
        b = self.rows_per_shard
        return index * b, min((index + 1) * b, self.n)

    def shards(self) -> List[Tuple[int, int, int]]:
        """All ``(index, lo, hi)`` shard tasks, in index order."""
        return [(i, *self.shard_range(i)) for i in range(self.num_shards)]

    # -- identity -------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # pin the effective shard grid into the serialized identity so
        # a replica under a different SKYLARK_DIST_SHARD_ROWS computes
        # the same ranges
        d["shard_rows"] = self.rows_per_shard
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ShardPlan":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)
                      if f.name in d}).validate()

    def fingerprint(self) -> str:
        """Stable digest of the plan — the coordinator's ring-affinity
        key base and the routing identity of every shard task."""
        return hashlib.sha256(
            json.dumps(self.to_dict(), sort_keys=True).encode()
        ).hexdigest()[:16]

    def _transform(self):
        """The global transform this plan shards (lazy, cheap: the
        operator itself is virtual — only stream keys are derived)."""
        from libskylark_tpu_torch.base.context import Context

        ctx = Context(seed=int(self.seed))
        if self.kind == "cwt":
            from libskylark_tpu_torch.sketch.hash import CWT

            return CWT(self.n, self.s_dim, ctx)
        if self.kind == "jlt":
            from libskylark_tpu_torch.sketch.dense import JLT

            return JLT(self.n, self.s_dim, ctx)
        if self.kind == "srht":
            from libskylark_tpu_torch.sketch.fjlt import FJLT

            return FJLT(self.n, self.s_dim, ctx, fut="wht")
        from libskylark_tpu_torch.sketch.ust import UST

        return UST(self.n, self.s_dim, ctx, replace=self.replace)


# ---------------------------------------------------------------------------
# sources: range-readable row streams
# ---------------------------------------------------------------------------




class ShardSource:
    """A row source shard tasks read ranges from. Subclasses are small
    pickleable descriptors (they cross the process-replica pipe);
    ``read(lo, hi)`` yields ``(offset, X, Y)`` batches covering exactly
    ``[lo, hi)`` on the absolute batch grid, re-enterable at any
    previously yielded batch boundary (the ingest-resume seam)."""

    n: int
    d: int
    targets: int = 0

    def read(self, lo: int, hi: int
             ) -> Iterator[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
        raise NotImplementedError

    def subrange(self, lo: int, hi: int) -> "ShardSource":
        """The source a shard task ships with: descriptors return
        ``self`` (the replica reads its own range); in-memory sources
        return just the shard's rows so a task never pickles the whole
        dataset."""
        return self


class ArraySource(ShardSource):
    """In-memory rows, held on the host (a tensor is copied there once).
    ``batch_rows=0`` (default) reads a requested range as one slice; a
    task dispatched to a replica carries only its shard's rows
    (:meth:`subrange`)."""

    def __init__(self, X, Y=None, batch_rows: int = 0, offset: int = 0):
        self._X = host_array(X)
        if self._X.ndim != 2:
            raise errors.InvalidParametersError(
                f"ArraySource expects 2-D rows, got {self._X.shape}")
        self._Y = None
        self.targets = 0
        if Y is not None:
            self._Y = host_array(Y)
            if self._Y.ndim == 1:
                self._Y = self._Y[:, None]
            if self._Y.shape[0] != self._X.shape[0]:
                raise errors.InvalidParametersError(
                    f"ArraySource: X has {self._X.shape[0]} rows but Y "
                    f"has {self._Y.shape[0]}")
            self.targets = int(self._Y.shape[1])
        self._off = int(offset)           # global row of local row 0
        self.n = self._off + int(self._X.shape[0])
        self.d = int(self._X.shape[1])
        self.batch_rows = int(batch_rows)

    def read(self, lo, hi):
        if lo < self._off or hi > self.n:
            raise errors.InvalidParametersError(
                f"ArraySource holds rows [{self._off}, {self.n}); "
                f"read asked for [{lo}, {hi})")
        for a, b in _grid_spans(lo, hi, self.batch_rows):
            i, j = a - self._off, b - self._off
            yield a, self._X[i:j], (
                self._Y[i:j] if self._Y is not None else None)

    def subrange(self, lo, hi):
        i, j = lo - self._off, hi - self._off
        return ArraySource(self._X[i:j],
                           self._Y[i:j] if self._Y is not None else None,
                           batch_rows=self.batch_rows, offset=lo)


@dataclasses.dataclass
class HDF5Source(ShardSource):
    """Rows from an HDF5 file in the reference's dense ``X``/``Y``
    layout (:mod:`libskylark_tpu_torch.io.hdf5`): every replica range-reads
    its own shard's slices off shared storage — only the path crosses
    the wire. Dims are pinned at construction (:meth:`probe`), so a
    replica never re-probes."""

    path: str
    n: int
    d: int
    targets: int = 1
    batch_rows: int = 4096

    @classmethod
    def probe(cls, path: str, batch_rows: int = 4096) -> "HDF5Source":
        from libskylark_tpu_torch.io.hdf5 import _require_h5py

        h5py = _require_h5py()
        with h5py.File(path, "r") as f:
            n, d = f["X"].shape
            y = f["Y"]
            nt = 1 if y.ndim == 1 else int(y.shape[1])
        return cls(path=path, n=int(n), d=int(d), targets=nt,
                   batch_rows=batch_rows)

    def read(self, lo, hi):
        from libskylark_tpu_torch.io.chunked import iter_hdf5_batches

        at = lo
        for X, Y in iter_hdf5_batches(self.path, self.batch_rows,
                                      start_row=lo, stop_row=hi):
            if Y.ndim == 1:
                Y = Y[:, None]
            yield at, X, Y
            at += len(X)


@dataclasses.dataclass
class LibsvmSource(ShardSource):
    """Rows from a libsvm line stream. ``path`` is a filesystem path
    (re-openable in any replica off shared storage); ``opener`` is an
    optional zero-arg callable returning a fresh line iterable — the
    transport seam, e.g. ``functools.partial(webhdfs_lines, url)`` —
    used instead of the path when given. It must be *pickleable* to
    cross a process pipe: a module-level function or ``partial`` of
    one, never a lambda/closure (an unpicklable opener fails each
    dispatch attempt and the shard degrades into the abandoned
    accounting instead of crashing the storm). Line streams have no random access: a range read parses
    from the top and discards rows before ``lo`` (the reference's
    root-reads-and-scatters discipline); a *resume* after a transient
    failure re-opens the stream and skips to the consumed offset —
    nothing already folded recomputes."""

    path: Optional[str]
    n: int
    d: int
    targets: int = 1
    batch_rows: int = 4096
    opener: Optional[object] = None

    def _lines(self):
        if self.opener is not None:
            return self.opener()
        return self.path

    def read(self, lo, hi):
        from libskylark_tpu_torch.io.chunked import iter_libsvm_batches

        row = 0
        for X, Y in iter_libsvm_batches(self._lines(), self.batch_rows,
                                        d=self.d, max_n=hi):
            m = len(X)
            a, b = max(lo, row), min(hi, row + m)
            if a < b:
                Yb = Y[a - row:b - row]
                if Yb.ndim == 1:
                    Yb = Yb[:, None]
                yield a, X[a - row:b - row], Yb
            row += m
            if row >= hi:
                return


# ---------------------------------------------------------------------------
# per-shard partial computation
# ---------------------------------------------------------------------------


class _Folder:
    """Carried-accumulator fold of one shard's rows into a fresh partial
    sketch at absolute row positions, on ``device``: the session fold
    (module docstring) started from zeros at the shard's first row."""

    def __init__(self, plan: ShardPlan, lo: int, device=None):
        from libskylark_tpu_torch.base.device import resolve_device
        from libskylark_tpu_torch.io.streaming import compute_dtype

        self.plan = plan
        self.t = plan._transform()
        self.rows = 0
        self.device = resolve_device(device)
        self._np_dt = np.dtype(plan.dtype)
        self._dt = compute_dtype(self._np_dt)
        if plan.kind in ADDITIVE_KINDS:
            self.sx = self._zeros(plan.d)
            self.sy = self._zeros(plan.targets) if plan.targets else None
        else:                    # ust: collect the owned sampled rows
            self._idx = self.t.sample_indices().numpy()
            self._out: List[np.ndarray] = []
            self._rx: List[torch.Tensor] = []
            self._ry: List[torch.Tensor] = []

    def _zeros(self, width: int) -> torch.Tensor:
        return torch.zeros((self.plan.s_dim, width), dtype=self._dt,
                           device=self.device)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        with warnings.catch_warnings():
            # rows that crossed a process are a read-only slot view; they
            # are only read
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, self._dt)

    def fold(self, off: int, X, Y=None) -> None:
        from libskylark_tpu_torch.sessions.state import fold_sketch

        p = self.plan
        X = np.asarray(host_array(X), dtype=self._np_dt)
        m = X.shape[0]
        if X.ndim != 2 or X.shape[1] != p.d:
            raise errors.InvalidParametersError(
                f"shard batch must be (m, {p.d}), got {X.shape}")
        if p.targets:
            if Y is None:
                raise errors.InvalidParametersError(
                    f"plan carries {p.targets} target column(s); the "
                    "source yielded none")
            Y = np.asarray(host_array(Y), dtype=self._np_dt).reshape(m, -1)
            if Y.shape[1] != p.targets:
                raise errors.InvalidParametersError(
                    f"Y batch must be ({m}, {p.targets}), got {Y.shape}")
        lo, hi = off, off + m
        if m == 0:
            return
        if p.kind in ADDITIVE_KINDS:
            pairs = [(self.sx, self._on_device(X))]
            if p.targets:
                pairs.append((self.sy, self._on_device(Y)))
            fold_sketch(p.kind, self.t, pairs, lo)
        else:                    # ust
            sel = np.nonzero((self._idx >= lo) & (self._idx < hi))[0]
            if sel.size:
                self._out.append(sel.astype(np.int64))
                self._rx.append(self._on_device(X[self._idx[sel] - lo]))
                if p.targets:
                    self._ry.append(self._on_device(Y[self._idx[sel] - lo]))
        self.rows += m

    def partial(self) -> Dict[str, torch.Tensor]:
        p = self.plan
        if p.kind in ADDITIVE_KINDS:
            out = {"SX": self.sx}
            if p.targets:
                out["SY"] = self.sy
            return out

        def cat(lst, w):
            return (torch.cat(lst) if lst else torch.zeros(
                (0, w), dtype=self._dt, device=self.device))

        out = {"out_idx": torch.from_numpy(
                   np.concatenate(self._out) if self._out
                   else np.zeros(0, np.int64)).to(self.device),
               "rows_x": cat(self._rx, p.d)}
        if p.targets:
            out["rows_y"] = cat(self._ry, p.targets)
        return out


def compute_shard(plan: ShardPlan, index: int, source: ShardSource,
                  retry: Optional[RetryPolicy] = None, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Execute shard task ``index``: ingest rows ``[lo, hi)`` from
    ``source`` and fold them into a fresh partial sketch on ``device``.

    The ``dist.shard`` fault site fires at entry. An ingest failure the
    retry policy calls transient re-enters the source at the **consumed
    batch offset**: the carried accumulator keeps everything already
    folded, so a reconnect resumes instead of recomputing."""
    plan.validate()
    faults.check("dist.shard", detail=f"shard{index}")
    lo, hi = plan.shard_range(index)
    retry = retry or _ingest_retry()
    folder = _Folder(plan, lo, device)
    consumed = lo
    delays = retry.delays()
    failures = 0
    while consumed < hi:
        try:
            for off, X, Y in source.read(consumed, hi):
                faults.check("dist.ingest",
                             detail=f"shard{index}@{off}")
                folder.fold(off, X, Y)
                consumed = off + len(X)
            if consumed < hi:
                # a truncated source must not pass for a whole shard; a
                # reconnect may still see the full stream, so the retry
                # ladder gets its turn before this propagates
                raise errors.IOError_(
                    f"shard {index}: source ended at row {consumed} "
                    f"before the shard bound {hi}")
        except BaseException as e:  # noqa: BLE001 — the predicate decides
            failures += 1
            if not retry.retryable(e) or failures >= retry.max_attempts:
                if isinstance(e, errors.SkylarkError):
                    e.append_trace(
                        f"dist ingest: shard {index} failed at row "
                        f"{consumed} (attempt {failures})")
                raise
            retry.sleep(next(delays))
    if folder.rows != hi - lo:
        raise errors.IOError_(
            f"shard {index} expected {hi - lo} rows, source yielded "
            f"{folder.rows}")
    return folder.partial()


def partial_on(partial: Mapping, device=None) -> dict:
    """A shard's partial with its host arrays made tensors on ``device``
    (default: the package default), one copy each: what a process
    replica's shard task sends back. Tensors pass unchanged."""
    from libskylark_tpu_torch.base.device import resolve_device

    if not any(isinstance(v, np.ndarray) for v in partial.values()):
        return dict(partial)
    dev = resolve_device(device)
    with warnings.catch_warnings():
        # a received array may be read-only; it is only copied from
        warnings.simplefilter("ignore", UserWarning)
        return {k: (torch.from_numpy(v).to(dev, copy=True)
                    if isinstance(v, np.ndarray) else v)
                for k, v in partial.items()}


def source_to_wire(source: ShardSource):
    """The cross-replica wire form of a (usually cut) source: an
    :class:`ArraySource` flattens to a dict whose row arrays sit in a
    top-level container (what a process replica's transport ships as
    array segments); anything else passes unchanged."""
    if type(source) is ArraySource:
        wire = {"__kind__": "array_source", "offset": source._off,
                "batch_rows": source.batch_rows, "X": source._X}
        if source._Y is not None:
            wire["Y"] = source._Y
        return wire
    return source


def source_from_wire(obj) -> ShardSource:
    """Inverse of :func:`source_to_wire` (identity for pass-throughs).
    ``ArraySource`` never writes its rows, so a read-only view is used
    as it is."""
    if isinstance(obj, dict) and obj.get("__kind__") == "array_source":
        return ArraySource(obj["X"], obj.get("Y"),
                           batch_rows=int(obj["batch_rows"]),
                           offset=int(obj["offset"]))
    return obj


def execute_task(payload: Mapping, device=None) -> dict:
    """The replica-side entry point of one shard task (a replica's
    ``shard`` verb lands here), on ``device``. The payload carries the
    serialized plan, the shard index and the range-readable source
    (possibly cut to the shard's rows, possibly in
    :func:`source_to_wire` form)."""
    plan = ShardPlan.from_dict(payload["plan"])
    index = int(payload["index"])
    lo, hi = plan.shard_range(index)
    source = source_from_wire(payload["source"])
    return {"index": index, "rows": hi - lo,
            "partial": compute_shard(plan, index, source, device=device)}


# ---------------------------------------------------------------------------
# merge: canonical deterministic tree + coverage accounting
# ---------------------------------------------------------------------------


def merge_partials(plan: ShardPlan, partials: Mapping[int, Mapping],
                   device=None) -> Dict[str, torch.Tensor]:
    """Merge per-shard partials into one sketch, on the device the
    partials are on (``device``, default the package default, when there
    are none).

    Additive kinds take the shards in ascending index and reduce them
    through a fixed pairwise tree: the merged bits depend only on the
    set of present shards, never on arrival order or grouping. ``ust``
    partials place their owned output rows (exact). ``dist.merge`` is the
    fault site."""
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.io.streaming import compute_dtype

    plan.validate()
    faults.check("dist.merge",
                 detail=f"{plan.kind}:{len(partials)} partials")
    order = sorted(int(i) for i in partials)
    dt = compute_dtype(np.dtype(plan.dtype))
    dev = (partials[order[0]]["SX" if plan.kind in ADDITIVE_KINDS
                              else "rows_x"].device
           if order else resolve_device(device))

    def zeros(width):
        return torch.zeros((plan.s_dim, width), dtype=dt, device=dev)

    if plan.kind not in ADDITIVE_KINDS:
        sx = zeros(plan.d)
        sy = zeros(plan.targets) if plan.targets else None
        for i in order:
            p = partials[i]
            idx = p["out_idx"].to(dev)
            sx[idx] = p["rows_x"].to(dev, dt)
            if sy is not None:
                sy[idx] = p["rows_y"].to(dev, dt)
        out = {"SX": sx}
        if sy is not None:
            out["SY"] = sy
        return out
    if not order:
        out = {"SX": zeros(plan.d)}
        if plan.targets:
            out["SY"] = zeros(plan.targets)
        return out
    out = {"SX": _tree([partials[i]["SX"].to(dev, dt) for i in order])}
    if plan.targets:
        out["SY"] = _tree([partials[i]["SY"].to(dev, dt) for i in order])
    return out


def _tree(arrs: list) -> torch.Tensor:
    """The fixed pairwise reduction over the canonical order: log-depth,
    and one association order for a given present set."""
    while len(arrs) > 1:
        arrs = [arrs[k] + arrs[k + 1] if k + 1 < len(arrs) else arrs[k]
                for k in range(0, len(arrs), 2)]
    return arrs[0]


def missing_ranges(plan: ShardPlan, merged: Iterator[int]
                   ) -> Tuple[Tuple[int, int], ...]:
    """Coalesced global row ranges of the shards NOT in ``merged``."""
    present = set(int(i) for i in merged)
    out: List[List[int]] = []
    for i, lo, hi in plan.shards():
        if i in present:
            continue
        if out and out[-1][1] == lo:
            out[-1][1] = hi
        else:
            out.append([lo, hi])
    return tuple((a, b) for a, b in out)


# ---------------------------------------------------------------------------
# results: coverage is part of the answer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistSketchResult:
    """A merged distributed sketch (tensors on the compute device) plus
    its exact coverage accounting. ``coverage`` is the fraction of the
    plan's ``n`` rows folded into the merge (``1.0`` = every shard
    present); ``missing`` the coalesced global row ranges of abandoned
    shards. ``SY`` is ``None`` when the plan carries no targets."""

    kind: str
    SX: torch.Tensor
    SY: Optional[torch.Tensor]
    rows_merged: int
    coverage: float
    missing: Tuple[Tuple[int, int], ...]
    shards: int
    shards_merged: int

    @property
    def degraded(self) -> bool:
        return self.coverage < 1.0

    def require(self, min_coverage: float) -> "DistSketchResult":
        """Gate: raise :class:`~libskylark_tpu_torch.base.errors.
        SketchCoverageError` when the merge covered less than
        ``min_coverage`` of the declared rows — the never-silently-
        partial contract."""
        if self.coverage < float(min_coverage):
            raise errors.SketchCoverageError(
                f"distributed sketch covered {self.coverage:.6f} of the "
                f"rows (< min_coverage={min_coverage}); missing row "
                f"ranges: {list(self.missing)}",
                coverage=self.coverage, missing=self.missing)
        return self


class DegradedSketchResult(DistSketchResult):
    """A merge that lost at least one shard for good: a valid sketch of
    the surviving rows, with the loss quantified (``coverage`` < 1 and
    the exact ``missing`` ranges). Returned only when the caller's
    ``min_coverage`` admits it; below the gate the coordinator raises
    instead."""


def build_result(plan: ShardPlan, partials: Mapping[int, Mapping],
                 device=None) -> DistSketchResult:
    """Merge + exact coverage accounting in one step."""
    merged = merge_partials(plan, partials, device)
    rows = sum(hi - lo for i, lo, hi in plan.shards() if i in partials)
    missing = missing_ranges(plan, partials.keys())
    cls = DistSketchResult if rows == plan.n else DegradedSketchResult
    return cls(kind=plan.kind, SX=merged["SX"], SY=merged.get("SY"),
               rows_merged=rows, coverage=rows / plan.n,
               missing=missing, shards=plan.num_shards,
               shards_merged=len(partials))


def sketch_local(plan: ShardPlan, source: ShardSource,
                 retry: Optional[RetryPolicy] = None,
                 device=None) -> DistSketchResult:
    """The one-shot reference: every shard computed in turn in this
    process on ``device``, merged through the same canonical tree. A
    full-coverage distributed run, whatever crashed, retried or was
    reassigned on the way, is bit-equal to this by construction."""
    partials = {i: compute_shard(plan, i, source, retry=retry,
                                 device=device)
                for i, _, _ in plan.shards()}
    return build_result(plan, partials, device)


__all__ = [
    "ADDITIVE_KINDS", "ArraySource", "DegradedSketchResult",
    "DistSketchResult", "HDF5Source", "KINDS", "LibsvmSource",
    "ShardPlan", "ShardSource", "build_result", "compute_shard",
    "execute_task", "merge_partials", "missing_ranges", "partial_on",
    "sketch_local",
    "source_from_wire", "source_to_wire",
]
