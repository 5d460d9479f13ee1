"""Shape-bucketed microbatch serving: concurrent small requests coalesced
into one batched program per flush (the port of the core of
libskylark_tpu/engine/serve.py).

Requests enter through the future-returning :meth:`MicrobatchExecutor.
submit` on three endpoints — ``sketch_apply`` (JLT, CT, CWT and the SRHT
``FJLT(fut="wht")`` on dense operands), ``fastfood_features`` (Fastfood
feature maps) and ``sparse_sketch_apply`` (CWT, JLT and CT on CSR
operands) — and are grouped by **bucket**: the endpoint statics (family,
sketch dim, orientation, dtype) and the pow2 shape class of
:mod:`libskylark_tpu_torch.engine.bucket`; sparse buckets add the pow2
nnz class. A bucket flushes when it holds ``max_batch`` requests or its
oldest request has waited ``linger_us``. A flush stacks the cohort at its
capacity class (filler lanes replicate the last request), runs one
batched program over the stack, and resolves each future with its lane,
cut back to the request's own extent. Past ``max_queue`` pending
requests ``submit`` waits, then raises :class:`ServeOverloadedError`.

Exactness: zero padding is exact (the sketch streams are positional), and
every lane runs the same program whatever the capacity, so a request's
bits do not depend on its cohort.

**Flush programs.** On a CUDA executor every bucket whose host-side
qualification passes flushes through its kernel, and that qualification
runs before anything is keyed or launched: JLT/CT through B1-batched
(``cuda_dense.serve_batched_apply``, one launch for the cohort), Fastfood
(``fut="wht"``, NB a power of two the kernel holds) through B4-batched,
sparse CWT through B3, sparse JLT/CT densified in the flush
(``sparse_serve.scatter_dense``) and then B1-batched, and dense CWT and
SRHT through B2 and B5, one counted launch per lane. All need float32. A
bucket that fails qualification runs the plain program, and the reason is
counted under ``stats()["kernel"]["by_reason"]``. ``kernel="plain"``
chooses the plain programs explicitly; ``kernel="cuda"`` on a CPU
executor raises at construction. The CPU executor always runs the plain
programs. Nothing re-runs a failed kernel flush on the plain program:
the reference's XLA default flush and its poisoning of a bucket after a
compile rejection have no counterpart here.

**Failure isolation.** A failed flush is retried by bisection: the
cohort splits in half and each half runs again, until the failure is
pinned to single requests, which alone receive the exception.

Futures resolve to tensors on the executor's device, after the flush's
work on the card has finished (the reference resolves to host numpy
arrays). Flusher and worker threads set the executor's device, since
CUDA's current device is per thread; the kernels launch on that thread's
current stream.

Not ported yet (later slices): QoS tenants and scheduling, the adaptive
controller, the result cache and residency, sessions and training jobs,
the dist endpoints and mesh sharding, deadlines and DEGRADED shedding,
telemetry spans, warmup packs and AOT, and the other endpoints.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import resolve_device
from libskylark_tpu_torch.base.sparse import as_sparse
from libskylark_tpu_torch.engine import bucket as bucketing

ENDPOINTS = ("sketch_apply", "fastfood_features", "sparse_sketch_apply")
KERNEL_CHOICES = ("cuda", "plain")

# the reference's SKYLARK_SPARSE_NNZ_FLOOR and SKYLARK_SPARSE_MIN_DENSITY
# defaults
SPARSE_NNZ_FLOOR = 64
SPARSE_MIN_DENSITY = 0.25

SERVING = "SERVING"
DRAINING = "DRAINING"
STOPPED = "STOPPED"

_EX_SEQ = itertools.count()


class ServeOverloadedError(RuntimeError):
    """The queue stayed at ``max_queue`` past the submit timeout, or the
    executor is draining or stopped."""


@dataclasses.dataclass
class _Request:
    arrays: dict            # per-request operands (host numpy or tensors)
    true_shapes: dict       # name -> original shape (unpad, waste)
    meta: dict              # endpoint bits: orientation, true extents
    future: Future = dataclasses.field(default_factory=Future)
    t_submit: float = dataclasses.field(default_factory=time.monotonic)


@dataclasses.dataclass
class _Bucket:
    key: tuple
    ctx: dict               # what the flush program needs
    reqs: list = dataclasses.field(default_factory=list)

    @property
    def oldest(self) -> float:
        return self.reqs[0].t_submit if self.reqs else float("inf")


def _percentile(sorted_vals: list, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def _dtype_name(A) -> str:
    if isinstance(A, torch.Tensor):
        return str(torch.empty((), dtype=A.dtype).numpy().dtype)
    return str(A.dtype)


def _as_operand(A):
    """A tensor as given, anything else as a numpy array."""
    return A if isinstance(A, torch.Tensor) else np.asarray(A)


# ---------------------------------------------------------------------------
# bucket statics: (statics, info) per endpoint, the reference's tuples
# ---------------------------------------------------------------------------


def _sketch_family(transform):
    """(family tag, dist) of a transform the sketch endpoints serve."""
    from libskylark_tpu_torch.sketch.dense import DenseTransform
    from libskylark_tpu_torch.sketch.fjlt import FJLT
    from libskylark_tpu_torch.sketch.hash import CWT

    if isinstance(transform, CWT):
        return "CWT", None
    if isinstance(transform, FJLT):
        if transform._fut_name != "wht":
            raise errors.UnsupportedError(
                "FJLT serves panel-free only with the 'wht' "
                f"(Sylvester-Hadamard) mixer, not {transform._fut_name!r}")
        return "SRHT", None
    if isinstance(transform, DenseTransform):
        return transform.sketch_type, transform.dist
    raise TypeError(
        "sketch endpoints batch dense (JLT/CT), CWT and FJLT/SRHT "
        "transforms (Fastfood feature maps go through submit_fastfood); "
        f"got {type(transform).__name__}")


def _rowwise(dimension) -> bool:
    from libskylark_tpu_torch.sketch.transform import (COLUMNWISE,
                                                       Dimension)

    return Dimension(dimension or COLUMNWISE) == Dimension.ROWWISE


def _sketch_statics(transform, A, dimension, pad_floor):
    rowwise = _rowwise(dimension)
    A = _as_operand(A)
    if A.ndim == 1:
        A = A[None, :] if rowwise else A[:, None]
    n = A.shape[1] if rowwise else A.shape[0]
    if n != transform.input_dim:
        raise ValueError(f"operand dim {n} != transform input dim "
                         f"{transform.input_dim}")
    family, dist = _sketch_family(transform)
    if family == "SRHT":
        # the transform length is the operator: only the free axis pads
        if n & (n - 1):
            raise ValueError(f"SRHT serve requires a power-of-2 transform "
                             f"dim, got {n}")
        pad_axes = (0,) if rowwise else (1,)
    else:
        pad_axes = (0, 1)
    padded = bucketing.pad_shape(tuple(A.shape), pad_axes, pad_floor)
    statics = ("sketch_apply", family, repr(dist), transform.sketch_dim,
               rowwise, _dtype_name(A), padded)
    return statics, {"A": A, "family": family, "dist": dist,
                     "rowwise": rowwise, "padded": padded}


def _fastfood_statics(transform, A, pad_floor):
    from libskylark_tpu_torch.sketch.frft import FastRFT

    if not isinstance(transform, FastRFT):
        raise TypeError("fastfood_features serves FastRFT-family "
                        f"transforms; got {type(transform).__name__}")
    A = _as_operand(A)
    squeeze = A.ndim == 1
    if squeeze:
        A = A[None, :]
    if A.shape[1] != transform.input_dim:
        raise ValueError(f"operand dim {A.shape[1]} != transform input dim "
                         f"{transform.input_dim}")
    sm_kind, sm_param = transform._sm_spec()
    m_pad = bucketing.pow2_pad(A.shape[0], pad_floor)
    statics = ("fastfood_features", transform._fut_name, sm_kind,
               repr(sm_param), transform.sketch_dim, A.shape[1],
               _dtype_name(A), m_pad)
    return statics, {"A": A, "squeeze": squeeze, "m_pad": m_pad,
                     "fut": transform._fut_name, "sm_kind": sm_kind,
                     "sm_param": sm_param}


def _sparse_sketch_statics(transform, A, dimension, pad_floor):
    rowwise = _rowwise(dimension)
    A = as_sparse(A)
    n = A.width if rowwise else A.height
    if n != transform.input_dim:
        raise ValueError(f"operand dim {n} != transform input dim "
                         f"{transform.input_dim}")
    family, dist = _sketch_family(transform)
    if family == "SRHT":
        raise errors.UnsupportedError(
            "sparse_sketch_apply serves CWT, JLT and CT")
    padded = bucketing.pad_shape(A.shape, (0, 1), pad_floor)
    nnz_cls = bucketing.nnz_class(A.nnz, SPARSE_NNZ_FLOOR)
    dtype = str(np.dtype(A.device_dtype))
    statics = ("sparse_sketch_apply", family, repr(dist),
               transform.sketch_dim, rowwise, dtype, padded, nnz_cls)
    return statics, {"A": A, "family": family, "dist": dist,
                     "rowwise": rowwise, "padded": padded,
                     "nnz_class": nnz_cls, "dtype": dtype}


def derive_request(endpoint: str, *, pad_floor: int = bucketing.PAD_FLOOR,
                   **kwargs) -> tuple:
    """``(statics, info)`` of a request: the bucket statics and what the
    executor's packing reuses."""
    kwargs.pop("timeout", None)
    if endpoint == "sketch_apply":
        return _sketch_statics(kwargs["transform"], kwargs["A"],
                               kwargs.get("dimension"), pad_floor)
    if endpoint == "fastfood_features":
        return _fastfood_statics(kwargs["transform"], kwargs["A"], pad_floor)
    if endpoint == "sparse_sketch_apply":
        return _sparse_sketch_statics(kwargs["transform"], kwargs["A"],
                                      kwargs.get("dimension"), pad_floor)
    raise ValueError(f"unknown serve endpoint {endpoint!r}; expected one of "
                     f"{ENDPOINTS}")


def request_statics(endpoint: str, *, pad_floor: int = bucketing.PAD_FLOOR,
                    **kwargs) -> tuple:
    """The bucket statics a request of ``endpoint`` with these operands
    lands in: (endpoint, family, dist, sketch dim, orientation, dtype,
    shape class, ...), as the reference's executor keys them."""
    return derive_request(endpoint, pad_floor=pad_floor, **kwargs)[0]


# ---------------------------------------------------------------------------
# kernel qualification and the flush programs
# ---------------------------------------------------------------------------


def qualify(ctx: dict) -> tuple[bool, str]:
    """Host-side (ok, reason) of a bucket's kernel, from its statics alone:
    float32; Fastfood with the wht core and an NB the kernel holds; SRHT
    with n a power of two the kernel takes; JLT/CT with a distribution
    the dense kernel generates."""
    from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood,
                                             cuda_fwht)
    from libskylark_tpu_torch.sketch.frft import block_geometry

    if ctx["dtype"] != "float32":
        return False, f"dtype {ctx['dtype']} != float32"
    s_dim = ctx["s_dim"]
    if ctx["endpoint"] == "fastfood_features":
        if ctx["fut"] != "wht":
            return False, f"fut {ctx['fut']!r} has no kernel (wht core only)"
        NB, _ = block_geometry(ctx["n_dim"], s_dim, ctx["fut"])
        if not cuda_fastfood.supported(NB, torch.float32):
            return False, (f"NB={NB} outside the kernel's range (a power of "
                           f"two <= {cuda_fastfood.MAX_NB})")
        return True, "ok"
    family, (rows, cols) = ctx["family"], ctx["padded"]
    n = cols if ctx["rowwise"] else rows
    if family == "CWT":
        return True, "ok"
    if family == "SRHT":
        if not cuda_fwht.supported(n, s_dim, torch.float32):
            return False, (f"SRHT n={n}, s={s_dim} outside the kernel's "
                           f"range (n a power of two >= {cuda_fwht.MIN_N}, "
                           f"s <= {cuda_fwht.MAX_S})")
        return True, "ok"
    if not cuda_dense.supported(ctx["dist"], torch.float32):
        return False, f"distribution {ctx['dist']!r} has no kernel"
    return True, "ok"


def run_flush(ctx: dict, route: str, kd: np.ndarray, scale: np.ndarray,
              arrays: dict) -> torch.Tensor:
    """One flush's batched program over the stacked cohort: the kernels'
    wrappers for ``route == "cuda"``, their plain versions for
    ``"plain"``. ``kd`` (B, 2) uint32 and ``scale`` (B,) are host arrays;
    ``arrays`` holds the stacked operand tensors."""
    from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood,
                                             cuda_fwht, cuda_hash,
                                             cuda_sparse, sparse_serve)

    kernel = route == "cuda"
    endpoint = ctx["endpoint"]
    if endpoint == "fastfood_features":
        fn = (cuda_fastfood.serve_features_batched if kernel
              else cuda_fastfood.serve_features_plain)
        return fn(kd, arrays["A"], ctx["n_dim"], ctx["s_dim"], ctx["fut"],
                  ctx["sm_kind"], ctx["sm_param"])
    family, s_dim, rowwise = ctx["family"], ctx["s_dim"], ctx["rowwise"]
    if endpoint == "sketch_apply":
        A = arrays["A"]
        if family == "CWT":
            fn = (cuda_hash.cwt_apply_batched if kernel
                  else cuda_hash.cwt_apply_batched_plain)
            return fn(kd, A, s_dim, rowwise)
        if family == "SRHT":
            fn = (cuda_fwht.srht_apply_batched if kernel
                  else cuda_fwht.srht_apply_batched_plain)
            return fn(kd, A, s_dim, rowwise)
    else:
        data, indices, indptr = (arrays["data"], arrays["indices"],
                                 arrays["indptr"])
        if family == "CWT":
            rows = sparse_serve.csr_row_ids(indptr, data.shape[1])
            fn = (cuda_sparse.cwt_sparse_apply_batched if kernel
                  else cuda_sparse.cwt_sparse_plain)
            return fn(kd, data, rows, indices, s_dim, rowwise, ctx["padded"])
        A = sparse_serve.scatter_dense(data, indices, indptr,
                                       shape=ctx["padded"])
    fn = (cuda_dense.serve_batched_apply if kernel
          else cuda_dense.serve_batched_plain)
    return fn(kd, scale, A, ctx["dist"], s_dim, rowwise)


def _unpad(endpoint: str, out: torch.Tensor, lane: int, r: _Request):
    if endpoint == "fastfood_features":
        p = out[lane, :r.meta["m"], :]
        return p[0] if r.meta["squeeze"] else p
    if endpoint == "sketch_apply":
        h, w = r.true_shapes["A"]
    else:
        h, w = r.meta["shape"]
    if r.meta["rowwise"]:
        return out[lane, :h, :]
    return out[lane, :, :w]


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


class MicrobatchExecutor:
    """Thread-safe microbatching executor over the three sketch endpoints.

    ::

        ex = engine.MicrobatchExecutor(max_batch=8, linger_us=2000)
        fut = ex.submit_sketch(transform, A, dimension=sk.ROWWISE)
        SA = fut.result()
        ex.shutdown()

    ``device`` is where flushes run and results live (the package default,
    "cuda", unless given); ``kernel`` is None (each qualified bucket's
    kernel on a CUDA executor), ``"cuda"`` (the same, refused on a CPU
    executor) or ``"plain"`` (the plain programs). ``workers`` flush
    cohorts concurrently. Submission is a host-side pack and a queue
    append, safe from any thread.
    """

    def __init__(self, max_batch: int = 8, linger_us: int = 2000,
                 max_queue: int = 1024, workers: int = 1,
                 pad_floor: int = bucketing.PAD_FLOOR,
                 kernel: Optional[str] = None, name: Optional[str] = None,
                 device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if kernel is not None and kernel not in KERNEL_CHOICES:
            raise ValueError(f"kernel must be one of {KERNEL_CHOICES} or "
                             f"None, got {kernel!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if kernel == "cuda" and self.device.type != "cuda":
            raise errors.UnsupportedError(
                f"kernel='cuda' needs a CUDA executor, got device "
                f"{self.device}")
        self.name = str(name) if name else f"ex-{next(_EX_SEQ)}"
        self.max_batch = int(max_batch)
        self.linger = float(linger_us) * 1e-6
        self.max_queue = int(max_queue)
        self.pad_floor = int(pad_floor)
        self.kernel = kernel

        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)
        self._space_cv = threading.Condition(self._lock)
        self._idle_cv = threading.Condition(self._lock)
        self._buckets: dict[tuple, _Bucket] = {}
        self._routes: dict[tuple, tuple] = {}
        self._pending = 0
        self._inflight = 0
        self._stop = False
        self._draining = False

        self._stats_lock = threading.Lock()
        self._counts = collections.Counter()
        self._kernel_sel = collections.Counter()
        self._kernel_dec = collections.Counter()
        self._sparse_sel = collections.Counter()
        self._sparse_nnz_hist = collections.Counter()
        self._batch_hist = collections.Counter()
        self._cohort_hist = collections.Counter()
        self._pad_real = 0
        self._pad_total = 0
        self._latency = collections.deque(maxlen=8192)
        self._by_bucket: dict[tuple, collections.Counter] = {}

        self._workq: queue.Queue = queue.Queue()
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"skylark-serve-worker-{i}", daemon=True)
            for i in range(max(int(workers), 1))]
        for t in self._workers:
            t.start()
        self._flusher = threading.Thread(target=self._flusher_loop,
                                         name="skylark-serve-flusher",
                                         daemon=True)
        self._flusher.start()

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------

    def submit(self, endpoint: str, /, **kwargs) -> Future:
        """Queue one request; the future resolves to what the endpoint's
        sequential apply returns, as a tensor on the executor's device.
        ``timeout`` (seconds, default 30) bounds the backpressure wait."""
        timeout = kwargs.pop("timeout", 30.0)
        statics, info = derive_request(endpoint, pad_floor=self.pad_floor,
                                       **kwargs)
        transform = kwargs["transform"]
        if endpoint == "sketch_apply":
            ctx, req = self._prep_sketch(transform, statics, info)
        elif endpoint == "fastfood_features":
            ctx, req = self._prep_fastfood(transform, statics, info)
        else:
            ctx, req = self._prep_sparse(transform, statics, info)
        self._enqueue(statics, ctx, req, timeout)
        return req.future

    def submit_sketch(self, transform, A, dimension=None, **kw) -> Future:
        return self.submit("sketch_apply", transform=transform, A=A,
                           dimension=dimension, **kw)

    def submit_fastfood(self, transform, A, **kw) -> Future:
        """Fastfood feature-map endpoint: resolves to
        ``transform.apply(A, ROWWISE)`` (1-D input gives (S,))."""
        return self.submit("fastfood_features", transform=transform, A=A,
                           **kw)

    def submit_sparse(self, transform, A, dimension=None, **kw) -> Future:
        """Sparse sketch endpoint: ``A`` a SparseMatrix or scipy sparse
        operand; resolves to ``transform.apply(A.todense(), dimension)``.
        An operand at or above the density ``SPARSE_MIN_DENSITY`` goes
        densified through the dense endpoint (counted as ``densified``)."""
        A = as_sparse(A)
        densify = A.density >= SPARSE_MIN_DENSITY
        with self._stats_lock:
            self._counts["sparse_submits"] += 1
            self._sparse_nnz_hist[bucketing.nnz_class(
                A.nnz, SPARSE_NNZ_FLOOR)] += 1
            if densify:
                self._counts["sparse_densified"] += 1
        if densify:
            Ad = np.asarray(A.to_scipy().toarray(), dtype=A.device_dtype)
            return self.submit("sketch_apply", transform=transform, A=Ad,
                               dimension=dimension, **kw)
        return self.submit("sparse_sketch_apply", transform=transform, A=A,
                           dimension=dimension, **kw)

    # -- per-endpoint packing -----------------------------------------

    def _operand(self, A):
        """A tensor moved to the executor's device; a numpy operand stays
        on the host until its flush stacks it."""
        return A.to(self.device) if isinstance(A, torch.Tensor) else A

    def _prep_sketch(self, transform, statics, info):
        A = self._operand(info["A"])
        ctx = {"endpoint": "sketch_apply", "dist": info["dist"],
               "family": info["family"], "s_dim": transform.sketch_dim,
               "rowwise": info["rowwise"], "padded": info["padded"],
               "dtype": statics[5]}
        req = _Request(
            arrays={"kd": transform.allocation.key,
                    "scale": float(getattr(transform, "scale", 1.0)),
                    "A": A},
            true_shapes={"A": tuple(A.shape)},
            meta={"rowwise": info["rowwise"]})
        return ctx, req

    def _prep_fastfood(self, transform, statics, info):
        A = self._operand(info["A"])
        ctx = {"endpoint": "fastfood_features", "fut": info["fut"],
               "sm_kind": info["sm_kind"], "sm_param": info["sm_param"],
               "n_dim": A.shape[1], "s_dim": transform.sketch_dim,
               "padded": (info["m_pad"], A.shape[1]), "dtype": statics[6]}
        req = _Request(
            arrays={"kd": transform.allocation.key, "scale": 1.0, "A": A},
            true_shapes={"A": tuple(A.shape)},
            meta={"m": A.shape[0], "squeeze": info["squeeze"]})
        return ctx, req

    @staticmethod
    def _pack_csr(A, rows_pad: int, nnz_class: int, dtype):
        """One request's CSR lanes: data/indices zero-padded to the nnz
        class (value 0.0 at index 0), indptr padded with the true nnz to
        the padded row extent."""
        data, indices, indptr = A.csr_parts(dtype)
        nnz = len(data)
        d = np.zeros(int(nnz_class), dtype=dtype)
        d[:nnz] = data
        idx = np.zeros(int(nnz_class), dtype=np.int32)
        idx[:nnz] = indices
        ptr = np.full(int(rows_pad) + 1, nnz, dtype=np.int32)
        ptr[:len(indptr)] = indptr
        return d, idx, ptr

    def _prep_sparse(self, transform, statics, info):
        A = info["A"]
        dtype = np.dtype(info["dtype"])
        data, idx, ptr = self._pack_csr(A, info["padded"][0],
                                        info["nnz_class"], dtype)
        ctx = {"endpoint": "sparse_sketch_apply", "dist": info["dist"],
               "family": info["family"], "s_dim": transform.sketch_dim,
               "rowwise": info["rowwise"], "padded": info["padded"],
               "nnz_class": info["nnz_class"], "dtype": info["dtype"]}
        req = _Request(
            arrays={"kd": transform.allocation.key,
                    "scale": float(getattr(transform, "scale", 1.0)),
                    "data": data, "indices": idx, "indptr": ptr},
            true_shapes={"data": (A.nnz,)},
            meta={"rowwise": info["rowwise"], "shape": A.shape})
        return ctx, req

    # ------------------------------------------------------------------
    # queueing and the flusher
    # ------------------------------------------------------------------

    def _route_locked(self, statics, ctx) -> tuple:
        """(route, decline reason or None) of a bucket, decided once, from
        its statics, before anything of it is launched."""
        r = self._routes.get(statics)
        if r is None:
            if self.device.type != "cuda" or self.kernel == "plain":
                r = ("plain", None)
            else:
                ok, why = qualify(ctx)
                r = ("cuda", None) if ok else ("plain", why)
            self._routes[statics] = r
        return r

    def _refuse_if_unavailable_locked(self) -> None:
        if self._stop or self._draining:
            raise ServeOverloadedError(
                f"executor {self.name!r} is "
                f"{'draining' if self._draining else 'stopped'}")

    def _enqueue(self, key, ctx, req, timeout) -> None:
        deadline = time.monotonic() + (timeout or 0)
        with self._lock:
            self._refuse_if_unavailable_locked()
            while self._pending >= self.max_queue:
                wait = deadline - time.monotonic() if timeout else None
                if (timeout and wait <= 0) or not self._space_cv.wait(wait):
                    with self._stats_lock:
                        self._counts["rejected"] += 1
                    raise ServeOverloadedError(
                        f"serve queue at bound ({self.max_queue}) for "
                        f"{timeout}s")
                self._refuse_if_unavailable_locked()
            b = self._buckets.get(key)
            if b is None:
                self._route_locked(key, ctx)
                b = self._buckets[key] = _Bucket(key=key, ctx=ctx)
            b.reqs.append(req)
            self._pending += 1
            with self._stats_lock:
                self._counts["submitted"] += 1
                self._counts["queued_peak"] = max(
                    self._counts["queued_peak"], self._pending)
            # a full cohort goes straight to the workers; the flusher owns
            # linger expiry, drain and partial flushes
            if len(b.reqs) >= self.max_batch:
                self._workq.put(self._pop_cohort_locked(key))
            else:
                self._work_cv.notify_all()

    def _pop_cohort_locked(self, key) -> tuple:
        b = self._buckets[key]
        cohort, b.reqs = b.reqs[:self.max_batch], b.reqs[self.max_batch:]
        if not b.reqs:
            del self._buckets[key]
        self._pending -= len(cohort)
        self._inflight += 1
        self._space_cv.notify_all()
        return b, cohort

    def _cohort_done_locked(self) -> None:
        self._inflight -= 1
        if self._pending == 0 and self._inflight == 0:
            self._idle_cv.notify_all()

    def _flusher_loop(self) -> None:
        """Dispatch every bucket that is full, has lingered out, or must
        go because the executor drains or stops — the oldest first."""
        while True:
            with self._lock:
                if self._stop and not self._buckets:
                    break
                now = time.monotonic()
                wait, ready = None, None
                for key, b in self._buckets.items():
                    if (len(b.reqs) >= self.max_batch or self._stop
                            or self._draining
                            or now - b.oldest >= self.linger):
                        if ready is None or b.oldest < \
                                self._buckets[ready].oldest:
                            ready = key
                    else:
                        w = b.oldest + self.linger - now
                        wait = w if wait is None else min(wait, w)
                if ready is None:
                    self._work_cv.wait(timeout=wait)
                    continue
                self._workq.put(self._pop_cohort_locked(ready))
        for _ in self._workers:
            self._workq.put(None)

    def _worker_loop(self) -> None:
        broken = None
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        except Exception as e:  # noqa: BLE001 — fanned to the futures
            broken = e
        while True:
            work = self._workq.get()
            if work is None:
                return
            if broken is None:
                self._dispatch_cohort(*work)
                continue
            b, cohort = work
            for r in cohort:
                r.future.set_exception(broken)
            with self._lock:
                self._cohort_done_locked()

    def _dispatch_cohort(self, b: _Bucket, cohort: list) -> None:
        """Run one cohort through the isolating executor; an exception
        that escapes it reaches every unresolved future."""
        try:
            self._run_cohort(b, cohort)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — fanned to the futures
            for r in cohort:
                if not r.future.done():
                    r.future.set_exception(e)
            with self._stats_lock:
                self._counts["failed"] += len(cohort)
        finally:
            with self._lock:
                self._cohort_done_locked()

    def flush(self) -> None:
        """Flush every pending cohort from the calling thread, and return
        once every in-flight cohort has resolved too."""
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            while True:
                with self._lock:
                    work = (self._pop_cohort_locked(next(iter(self._buckets)))
                            if self._buckets else None)
                if work is None:
                    break
                self._dispatch_cohort(*work)
        with self._lock:
            while self._inflight:
                self._idle_cv.wait(timeout=0.1)

    # ------------------------------------------------------------------
    # failure isolation: bisection converges on the failing request
    # ------------------------------------------------------------------

    def _run_cohort(self, b: _Bucket, cohort: list, depth: int = 0) -> None:
        """Execute a cohort; on failure split it in half and execute each
        half, until the failure pins to single requests, which alone get
        the exception (every lane runs the same program at any capacity,
        so the survivors' bits are those of the full flush)."""
        try:
            self._execute(b, cohort)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — isolated below
            with self._stats_lock:
                self._counts["flush_failures"] += 1
            if len(cohort) == 1:
                if not cohort[0].future.done():
                    cohort[0].future.set_exception(e)
                with self._stats_lock:
                    self._counts["failed"] += 1
                    self._counts["poisoned"] += 1
                return
            mid = len(cohort) // 2
            with self._stats_lock:
                self._counts["isolation_retries"] += 2
                self._counts["isolation_depth_peak"] = max(
                    self._counts["isolation_depth_peak"], depth + 1)
            self._run_cohort(b, cohort[:mid], depth + 1)
            self._run_cohort(b, cohort[mid:], depth + 1)

    # ------------------------------------------------------------------
    # one flush: stack → program → unpad
    # ------------------------------------------------------------------

    def _stack(self, cohort: list, name: str, shape, capacity: int,
               dtype) -> torch.Tensor:
        return bucketing.stack_pad_tensor(
            [r.arrays[name] for r in cohort], shape, capacity, dtype,
            self.device)

    def _execute(self, b: _Bucket, cohort: list) -> None:
        k = len(cohort)
        capacity = bucketing.capacity_class(k, self.max_batch)
        ctx = b.ctx
        endpoint = ctx["endpoint"]
        with self._lock:
            route, declined = self._route_locked(b.key, ctx)
        dtype = getattr(torch, ctx["dtype"])
        kd = bucketing.stack_pad([r.arrays["kd"] for r in cohort], (2,),
                                 capacity, np.uint32)
        scale = bucketing.stack_pad([np.float64(r.arrays["scale"])
                                     for r in cohort], (), capacity,
                                    np.dtype(ctx["dtype"]))
        if endpoint == "sparse_sketch_apply":
            nnz_pad = ctx["nnz_class"]
            ptr_len = ctx["padded"][0] + 1
            arrays = {
                "data": self._stack(cohort, "data", (nnz_pad,), capacity,
                                    dtype),
                "indices": self._stack(cohort, "indices", (nnz_pad,),
                                       capacity, torch.int32),
                "indptr": self._stack(cohort, "indptr", (ptr_len,),
                                      capacity, torch.int32)}
            padded, primary = (nnz_pad,), "data"
        else:
            padded, primary = ctx["padded"], "A"
            arrays = {"A": self._stack(cohort, "A", padded, capacity,
                                       dtype)}
        out = run_flush(ctx, route, kd, scale, arrays)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        now = time.monotonic()
        done = 0
        for i, r in enumerate(cohort):
            try:
                r.future.set_result(_unpad(endpoint, out, i, r))
                done += 1
            except Exception as e:  # noqa: BLE001 — reaches its future
                if not r.future.done():
                    r.future.set_exception(e)
        with self._stats_lock:
            self._counts["flushes"] += 1
            self._counts["completed"] += done
            self._counts["failed"] += k - done
            if k > 1:
                self._counts["coalesced"] += k
            self._kernel_sel[route] += 1
            if declined:
                self._kernel_dec[declined] += 1
            if endpoint == "sparse_sketch_apply":
                self._sparse_sel[route] += 1
            self._batch_hist[capacity] += 1
            self._cohort_hist[k] += 1
            pad_total = bucketing.padded_elements(padded, capacity)
            pad_real = bucketing.real_elements(
                [r.true_shapes[primary] for r in cohort])
            self._pad_total += pad_total
            self._pad_real += pad_real
            obs = self._by_bucket.setdefault(b.key, collections.Counter())
            obs.update(flushes=1, requests=done, capacity=capacity,
                       pad_real=pad_real, pad_total=pad_total)
            for r in cohort:
                self._latency.append(now - r.t_submit)

    # ------------------------------------------------------------------
    # state, stats, drain and shutdown
    # ------------------------------------------------------------------

    @property
    def state(self) -> str:
        """``SERVING`` | ``DRAINING`` | ``STOPPED``."""
        with self._lock:
            if self._stop:
                return STOPPED
            return DRAINING if self._draining else SERVING

    def stats(self) -> dict:
        """Snapshot of the serving counters, under the reference's names
        where the reference has them."""
        with self._stats_lock:
            lat = sorted(self._latency)
            c = dict(self._counts)
            ksel, kdec = dict(self._kernel_sel), dict(self._kernel_dec)
            sp_sel = dict(self._sparse_sel)
            sp_nnz = dict(sorted(self._sparse_nnz_hist.items()))
            batch_hist = dict(sorted(self._batch_hist.items()))
            cohort_hist = dict(sorted(self._cohort_hist.items()))
            pad_real, pad_total = self._pad_real, self._pad_total
            by_bucket = {repr(k): {
                "route": self._routes.get(k, ("plain", None))[0],
                "flushes": v["flushes"], "completed": v["requests"],
                "mean_capacity": v["capacity"] / v["flushes"],
                "padding_waste_ratio": round(
                    1.0 - v["pad_real"] / v["pad_total"], 4)}
                for k, v in self._by_bucket.items()}
        with self._lock:
            queued = self._pending
        return {
            "state": self.state,
            "device": str(self.device),
            "submitted": c.get("submitted", 0),
            "completed": c.get("completed", 0),
            "failed": c.get("failed", 0),
            "rejected": c.get("rejected", 0),
            "poisoned": c.get("poisoned", 0),
            "flush_failures": c.get("flush_failures", 0),
            "isolation_retries": c.get("isolation_retries", 0),
            "isolation_depth_peak": c.get("isolation_depth_peak", 0),
            "queued": queued,
            "queued_peak": c.get("queued_peak", 0),
            "coalesced": c.get("coalesced", 0),
            "flushes": c.get("flushes", 0),
            "kernel": {
                "by_backend": {k: {"flushes": int(v)}
                               for k, v in sorted(ksel.items())},
                "by_reason": {k: {"declined_flushes": int(v)}
                              for k, v in sorted(kdec.items())},
            },
            "sparse": {
                "submits": c.get("sparse_submits", 0),
                "densified": c.get("sparse_densified", 0),
                "by_backend": {k: {"kernel_flushes": int(v)}
                               for k, v in sorted(sp_sel.items())},
                "nnz_class_hist": sp_nnz,
            },
            "by_bucket": by_bucket,
            "batch_capacity_hist": batch_hist,
            "cohort_size_hist": cohort_hist,
            "padding_waste_ratio": (round(1.0 - pad_real / pad_total, 4)
                                    if pad_total else None),
            "latency_s": {
                "p50": _percentile(lat, 0.50),
                "p99": _percentile(lat, 0.99),
                "mean": (sum(lat) / len(lat)) if lat else None,
                "n": len(lat),
            },
        }

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop intake (new submits raise :class:`ServeOverloadedError`),
        flush every queued cohort, wait for every in-flight future, then
        stop the threads. Returns whether that finished inside
        ``timeout``; the executor stops either way."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if self._stop:
                return True
            self._draining = True
            self._work_cv.notify_all()
            self._space_cv.notify_all()
            drained = True
            while self._pending or self._inflight or self._buckets:
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    drained = False
                    break
                self._idle_cv.wait(timeout=0.1 if rem is None
                                   else min(rem, 0.1))
        self.shutdown(wait=drained)
        return drained

    def shutdown(self, wait: bool = True) -> None:
        """Stop intake, flush everything pending, join the threads."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
            self._work_cv.notify_all()
            self._space_cv.notify_all()
        if wait:
            self._flusher.join()
            for t in self._workers:
                t.join()

    def __enter__(self) -> "MicrobatchExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
