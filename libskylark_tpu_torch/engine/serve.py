"""Shape-bucketed microbatch serving: concurrent small requests coalesced
into one batched program per flush (the port of the core of
libskylark_tpu/engine/serve.py).

Requests enter through the future-returning :meth:`MicrobatchExecutor.
submit` on the reference's twelve local endpoints:

- the sketches: ``sketch_apply`` (JLT, CT, CWT and the SRHT
  ``FJLT(fut="wht")`` on dense operands), ``fastfood_features``
  (Fastfood feature maps) and ``sparse_sketch_apply`` (CWT, JLT and CT
  on CSR operands);
- the solves and factorizations built on a sketch: ``solve_l2_sketched``
  and ``sparse_solve_l2_sketched`` (JLT or CWT sketch-and-solve),
  ``compressed_matmul`` ((A·Sᵀ)(S·B) with one CWT or SRHT S, and its
  error scale) and ``lowrank`` (the two-sketch dominant subspace);
- the endpoints with no sketch: ``krr_predict``, ``rlsc_predict``,
  ``condest``, ``graph_ase`` and ``graph_ppr``.

Requests are grouped by **bucket**: the endpoint statics (family, sketch
dim, orientation, dtype, exact extents) and the pow2 shape class of
:mod:`libskylark_tpu_torch.engine.bucket`; CSR buckets add the pow2 nnz
class, and KRR/RLSC buckets the identity of the caller's model objects.
A bucket flushes when it holds ``max_batch`` requests or its oldest
request has waited ``linger_us``. A flush stacks the cohort at its
capacity class (filler lanes replicate the last request), runs one
batched program over the stack, and resolves each future with its lane,
cut back to the request's own extent. Past ``max_queue`` pending
requests ``submit`` waits, then raises :class:`ServeOverloadedError`.

Exactness: zero padding is exact (the sketch streams are positional), and
every lane runs the same program whatever the capacity, so a request's
bits do not depend on its cohort. Where a flush's program has a library
half (QR, SVD, solve, matmul, Gram, eigh, CSR products), each lane
runs it as its own call on a fresh copy of its lane, of one shape at
every capacity: a batched QR or SVD need not round like the unbatched one
(the reference's vmapped solve and lowrank do not, ROADMAP C15).

**Flush programs.** On a CUDA executor every bucket whose host-side
qualification passes flushes its sketches through the batched kernels,
one launch per operand per flush, and that qualification runs before
anything is keyed or launched:

- JLT/CT sketches through B1-batched (``cuda_dense.serve_batched_apply``),
  Fastfood (``fut="wht"``, NB a power of two the kernel holds) through
  B4-batched, dense CWT and SRHT through ``hash_batched`` (B2) and
  ``fwht_batched`` (B5), sparse CWT through B3, sparse JLT/CT densified
  in the flush (``sparse_serve.scatter_dense``) and then B1-batched;
- ``solve_l2_sketched``: A and B each through B1-batched columnwise (JLT)
  or ``hash_batched`` (CWT), then ``solve_l2_exact`` lane by lane;
  ``sparse_solve_l2_sketched``: A through B3 columnwise (CWT) or densified
  and B1-batched (JLT), B as the dense solve's;
- ``compressed_matmul``: A rowwise and B columnwise through
  ``fwht_batched`` (SRHT; a CSR A densified first) or ``hash_batched``
  (CWT; a CSR A through B3 rowwise), then (A·Sᵀ)(S·B) lane by lane;
- ``lowrank``: A rowwise through B1-batched once under each transform's
  key, then QR, the cross product's SVD and the truncation lane by lane.

All need float32. A bucket that fails qualification runs the plain
program, and the reason is counted under ``stats()["kernel"]
["by_reason"]``. The plain programs are the reference's single-request
functions lane by lane (``regression.sketched_solve_serve``,
``sparse_serve.sparse_solve_serve``, ``lowrank.lowrank_serve_apply``) or
the kernels' plain versions (the sketch endpoints, and compressed
matmul's sketches before its lanes' products). ``kernel="plain"`` chooses the
plain programs explicitly; ``kernel="cuda"`` on a CPU executor raises at
construction. The CPU executor always runs the plain programs. The
endpoints with no sketch have no kernel in the reference either: their
route is ``"library"`` on every executor (``ml.krr.krr_predict_kernel``,
``ml.rlsc.rlsc_predict_kernel``, ``nla.condest.condest_serve_apply``,
``ml.graph.ase_serve_apply``/``ppr_serve_apply`` lane by lane), counted
under ``stats()["library"]``, never as a kernel bucket. Nothing re-runs a
failed kernel flush on the plain program: the reference's XLA default
flush and its poisoning of a bucket after a compile rejection have no
counterpart here.

A KRR/RLSC model (X_train, coef) is uploaded to the executor's device
once per bucket, at the first submit that names it, and pinned with the
caller's objects for the executor's life (``stats()["models"]``).

**Failure isolation.** A failed flush is retried by bisection: the
cohort splits in half and each half runs again, until the failure is
pinned to single requests, which alone receive the exception.

Futures resolve to tensors on the executor's device, after the flush's
work on the card has finished (the reference resolves to host numpy
arrays); ``compressed_matmul`` to (estimate, bound), and ``rlsc_predict``
with ``coding`` to a host array of labels. Flusher and worker threads set
the executor's device, since CUDA's current device is per thread; the
kernels launch on that thread's current stream.

**Deadlines and health.** ``submit(deadline=...)`` (seconds or a
:class:`~libskylark_tpu_torch.resilience.Deadline`) bounds a request's
queued life: before every execution attempt, bisection retries included,
expired requests resolve to :class:`ServeOverloadedError` and are never
stacked or launched. Each root attempt's outcome feeds a window of
``failure_window`` flushes; at a failure ratio of ``degraded_threshold``
the executor is ``DEGRADED`` and sheds intake class by class (best_effort
first, interactive last, at ``max_queue`` times the class's shed
fraction), and it returns to ``SERVING`` as flushes succeed. Every
transition (``SERVING``, ``DEGRADED``, ``DRAINING``, ``STOPPED``) is
published through :mod:`libskylark_tpu_torch.resilience.health`. The
fault sites ``qos.admit`` (once per submit) and ``serve.flush`` (once per
attempt, before anything is stacked or launched) make this testable. A
failed flush is never re-run on the plain program, and DEGRADED never
reroutes a bucket: a CUDA bucket stays on its kernels.

**QoS.** A request's ``tenant=`` resolves, through a
:class:`~libskylark_tpu_torch.qos.TenantRegistry` (``tenants=``, else
the process-wide one), to a priority class and charges the tenant's
token bucket (:class:`~libskylark_tpu_torch.base.errors.
TenantQuotaError` when empty). The class rides the bucket key, so classes
queue apart and share programs; the flusher drains the class queues by
weighted-fair deficit round robin (8:4:1). ``adaptive=True`` starts a
:class:`~libskylark_tpu_torch.qos.AdaptiveController`, which moves each
bucket's linger and batch targets and never what a lane computes.

**Result cache and residency** (:mod:`libskylark_tpu_torch.engine.
resultcache`; ``cache=True`` or ``SKYLARK_CACHE``). A request's content
address (:func:`request_digest`, the reference's hex) is looked up in
the pinned results, then the byte-bounded cache of device tensors, then
the single-flight table, where identical concurrent requests coalesce
onto one leader: one flush serves them all, and each caller gets its own
clone. A failed leader fans its exception to every follower. All of it
is bypassed while DEGRADED. :meth:`MicrobatchExecutor.register_operand`
uploads an operand once and returns an
:class:`~libskylark_tpu_torch.engine.resultcache.OperandRef`; a submit
that passes the ref as ``A=`` ships no bytes of A, and a flush stacks the
resident operand by a device-to-device copy.

**Statistics and tracing.** :meth:`MicrobatchExecutor.stats` (with its
``qos`` and ``cache`` blocks), and across every live executor
:func:`serve_stats`, :func:`qos_stats` and :func:`cache_stats`, also the
``serve``, ``qos`` and ``cache`` collectors of ``telemetry.snapshot()``.
With telemetry on, ``serve.submit`` and ``serve.flush`` spans carry each
request's id across the thread hop, and a ``serve.flush`` span's
``torch.profiler`` range encloses the flush's launches.

**Captured flushes.** The sketch endpoints' flushes, ``sketch_apply``
(JLT, CT, CWT, SRHT) and ``fastfood_features``, run through the
executable cache (:mod:`libskylark_tpu_torch.engine.compiled`), as the
reference's ``_compiled_for`` runs them through ``engine_compile``: one
``CompiledFn`` per bucket's statics and route, named
``serve.sketch_apply`` / ``serve.fastfood_features`` and keyed on the
statics plus ``("kernel", route)``, the stacked keys ((B, 2) int32 on the
card), scales and operand its inputs, the operand donated. On the card the
first flush of a (bucket, capacity) captures a CUDA graph of the kernel
route and every later one replays it: the keys reach the kernels, and
Fastfood's streams are made from them, on the card, inside the graph. On
the CPU the body runs. Eager, with the reason counted under
``stats()["capture"]``: the other endpoints' flushes (ROADMAP B-ii 10),
FastMaternRFT's (its Gamma loop reads the host each round) and the plain
route on the card (its programs make their streams on the host). A flush
that cannot be captured raises to its futures; nothing reruns it eagerly.

**Kernel selection.** A kernel bucket's route, per (bucket, capacity),
follows the reference's precedence: the executor's ``kernel=``; then
``SKYLARK_SERVE_KERNEL`` (``pallas`` is the port's ``cuda`` and ``xla``
its ``plain``), with ``SKYLARK_FWHT_KERNEL`` for SRHT buckets and
``SKYLARK_SPARSE_KERNEL`` for sparse ones ahead of it; then a decision a
warmup pack restored (:meth:`MicrobatchExecutor.restore_kernel_choice`,
declined under any pin); then the autotuner's plan for the bucket's
serve workload (libskylark_tpu_torch/tune/, ``pallas`` or ``xla``; off
with ``SKYLARK_USE_PLAN_CACHE=0``); then the kernel, held to
:func:`qualify`. The plan choices and the restored decisions hold for one
plan-cache fingerprint: a changed cache drops them (and re-keys every
captured flush, whose key holds the fingerprint). A ``cuda`` choice,
whatever its source, that the bucket does not qualify for runs the plain
program, its reason counted. ``stats()["kernel"]["by_source"]`` counts
each flush's source (``arg``, ``env``, ``pack``, ``plan``, ``qualify``).
:meth:`MicrobatchExecutor.load_warmup_pack` boots an executor from a pack
(:mod:`libskylark_tpu_torch.engine.warmup`).

**Stateful sessions** (:mod:`libskylark_tpu_torch.sessions`): the
executor also hosts sketch sessions that live across requests —
:meth:`MicrobatchExecutor.open_sketch_session`,
:meth:`~MicrobatchExecutor.session_append` and
:meth:`~MicrobatchExecutor.session_finalize` on its registry
(:attr:`~MicrobatchExecutor.sessions`, built on first use, its
accumulators on the executor's device). Every accepted append is
journaled under ``SKYLARK_SESSION_DIR`` before its future resolves; a
drain checkpoints every live session, so a peer executor resumes a
drained, or killed, executor's sessions from checkpoint plus journal
tail, bit-equal, a duplicate sequence number a no-op. DRAINING refuses
appends; DEGRADED sheds them before any one-shot traffic (counted
``session_shed``); an expired deadline resolves without a journal write.

**Training jobs** (:mod:`libskylark_tpu_torch.train`):
:meth:`MicrobatchExecutor.submit_train_job` opens a ``kind="train"``
session on the registry (operands persisted first) and runs the job's
slices as best-effort work: the flusher offers the deficit scheduler a
train entry only when no higher class has pending work, so a slice runs
in an idle slot and interactive traffic displaces the job at the next
slice boundary (counted as ``preemptions``). A killed executor's job
resumes elsewhere (:meth:`~MicrobatchExecutor.resume_train_job`) from its
checkpoint and journal tail, bit-equal; a drain checkpoints and releases
the jobs. DEGRADED sheds train submits (``stats()["train"]["shed"]``).

**Distributed sketches** (:mod:`libskylark_tpu_torch.dist`):
:meth:`MicrobatchExecutor.submit_dist_sketch`,
:meth:`~MicrobatchExecutor.submit_dist_lstsq` and
:meth:`~MicrobatchExecutor.submit_dist_svd` admit a job through QoS and
the result cache (content-addressed by the source and the plan; single
flight; a degraded result is never cached), then drive a
:class:`~libskylark_tpu_torch.dist.serve.DistServeJob` on a thread of its
own, its shards on explicit ``replicas=`` or, with none, on the
executor's device.

Not ported yet (later slices): the executor's ``mesh`` (ROADMAP A6).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import math
import queue
import sys
import threading
import time
import warnings
import weakref
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from libskylark_tpu_torch import telemetry as _telemetry
from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.base.context import Allocation, seed_key
from libskylark_tpu_torch.base.device import resolve_device
from libskylark_tpu_torch.base.sparse import SparseMatrix, as_sparse
from libskylark_tpu_torch.engine import bucket as bucketing
from libskylark_tpu_torch.engine import resultcache as _rcache
from libskylark_tpu_torch.qos import scheduler as _qsched
from libskylark_tpu_torch.qos import tenants as _qtenants
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience import health as _health
from libskylark_tpu_torch.resilience.policy import Deadline
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

ENDPOINTS = ("sketch_apply", "fastfood_features", "solve_l2_sketched",
             "krr_predict", "sparse_sketch_apply",
             "sparse_solve_l2_sketched", "graph_ase", "graph_ppr",
             "condest", "lowrank", "rlsc_predict", "compressed_matmul")
KERNEL_CHOICES = ("cuda", "plain")

# endpoints whose flush is a sketch alone, one batched program
_SKETCH_ENDPOINTS = ("sketch_apply", "fastfood_features",
                     "sparse_sketch_apply")
# endpoints with no sketch, hence no kernel: their route is "library"
_LIBRARY_ENDPOINTS = ("krr_predict", "rlsc_predict", "condest",
                      "graph_ase", "graph_ppr")
# endpoints whose route the env pins and warmup packs decide (the
# reference's _KERNEL_ENDPOINTS)
_KERNEL_ENDPOINTS = ("sketch_apply", "fastfood_features",
                     "sparse_sketch_apply")
# endpoints whose flush runs through the executable cache
_CAPTURED_ENDPOINTS = ("sketch_apply", "fastfood_features")
# the reference's flush backends (env pins, pack tokens) as the port's
# routes
_BACKEND_ROUTES = {"pallas": "cuda", "xla": "plain", "cuda": "cuda",
                   "plain": "plain"}
# the backends a serve plan (tune/) names, as the port's routes
_PLAN_ROUTES = {"pallas": "cuda", "xla": "plain"}

_SPARSE_SUBMITS = _metrics.counter(
    "serve.sparse_submits",
    "Sparse (CSR) serve submissions accepted by submit_sparse / "
    "submit_sparse_solve, before the densify decision")
_SPARSE_DENSIFIED = _metrics.counter(
    "serve.sparse_densified",
    "Sparse submissions densified onto the dense serve path (operand "
    "density >= SKYLARK_SPARSE_MIN_DENSITY)")
_SPARSE_KERNEL_FLUSHES = _metrics.counter(
    "serve.sparse_kernel_flushes",
    "Sparse-bucket flushes by route (cuda = B3, plain = its plain "
    "version)")
_SPARSE_NNZ_HIST = _metrics.histogram(
    "serve.sparse_nnz_class",
    "pow2 nnz class of accepted sparse submissions",
    buckets=tuple(float(1 << p) for p in range(6, 21)))
_FWHT_FLUSHES = _metrics.counter(
    "serve.fwht_flushes",
    "SRHT sketch_apply flushes by route (cuda = B5)")
_CM_SUBMITS = _metrics.counter(
    "serve.compressed_matmul_submits",
    "Compressed-matmul submissions reaching the flush path (cache hits "
    "are not counted)")
_QOS_ADMITTED = _metrics.counter(
    "qos.admitted",
    "Requests admitted past QoS admission, by priority class and tenant")
_QOS_SHED = _metrics.counter(
    "qos.shed",
    "Requests shed by the class-ordered shed policy (DEGRADED or queue "
    "pressure), by priority class and tenant")
_QOS_RATE_LIMITED = _metrics.counter(
    "qos.rate_limited",
    "Requests refused at admission by a tenant token bucket "
    "(TenantQuotaError), by priority class and tenant")
_QOS_QUEUE_DEPTH = _metrics.gauge(
    "qos.queue_depth",
    "Queued (not yet dispatched) requests, by priority class and replica")
_QOS_LATENCY = _metrics.histogram(
    "qos.request_latency",
    "Request latency (submit to resolve, seconds), by priority class")

#: the flusher's stand-in "bucket" for a training slice: offered to the
#: deficit scheduler as best-effort work, and routed by
#: ``_dispatch_cohort`` to the train manager
_TRAIN_KEY = object()

SERVING = "SERVING"
DEGRADED = "DEGRADED"
DRAINING = "DRAINING"
STOPPED = "STOPPED"

_EX_SEQ = itertools.count()


class ServeOverloadedError(RuntimeError):
    """The queue stayed at ``max_queue`` past the submit timeout, a load
    shed (DEGRADED, queue pressure, draining), a request whose deadline
    expired while queued, or a stopped executor."""


@dataclasses.dataclass
class _Request:
    arrays: dict            # per-request operands (host numpy or tensors)
    true_shapes: dict       # name -> original shape (unpad, waste)
    meta: dict              # endpoint bits: orientation, true extents
    future: Future = dataclasses.field(default_factory=Future)
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    deadline: Optional[Deadline] = None   # expires-while-queued bound
    tags: frozenset = frozenset()         # fault-injection tags
    request_id: Optional[str] = None      # telemetry request identity
    tctx: Optional[object] = None         # telemetry SpanContext handoff
    qos_class: str = "standard"           # resolved priority class
    tenant: str = ""                      # resolved tenant name
    flight: Optional[object] = None       # the single-flight it leads


@dataclasses.dataclass
class _Bucket:
    key: tuple              # the queue: statics (+ model ids) + class
    statics: tuple          # routes, targets and stats (no class)
    ctx: dict               # what the flush program needs
    reqs: list = dataclasses.field(default_factory=list)
    qos_class: str = "standard"

    @property
    def oldest(self) -> float:
        return self.reqs[0].t_submit if self.reqs else float("inf")


def dispatch_loop(workq) -> None:
    """Flush-worker loop over a dispatch queue of ``(executor, (bucket,
    cohort))`` items (``None`` stops one worker): each executor's own
    workers run it, and so do the threads of whoever owns a queue handed
    to several executors as ``dispatch_queue=``."""
    while True:
        item = workq.get()
        if item is None:
            return
        ex, work = item
        ex._dispatch_cohort(*work)


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


def _cast(A, dtype: str):
    """A numpy operand or a tensor in the dtype named ``dtype``."""
    if isinstance(A, torch.Tensor):
        return A.to(getattr(torch, dtype))
    return A.astype(np.dtype(dtype), copy=False)


def _host(x, dtype) -> np.ndarray:
    """A small operand (a vector) as a host numpy array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.dtype(dtype))


def _fro(A) -> float:
    """‖A‖_F as a Python float: numpy's norm of a host array (the
    reference's), torch's of a tensor."""
    if isinstance(A, torch.Tensor):
        return float(torch.linalg.vector_norm(A))
    return float(np.linalg.norm(A))


def _is_sparse(A) -> bool:
    if isinstance(A, SparseMatrix):
        return True
    import scipy.sparse as sp

    return sp.issparse(A)


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
    nnz_cls = bucketing.nnz_class(A.nnz, _env.SPARSE_NNZ_FLOOR.get())
    dtype = str(np.dtype(A.device_dtype))
    statics = ("sparse_sketch_apply", family, repr(dist),
               transform.sketch_dim, rowwise, dtype, padded, nnz_cls)
    return statics, {"A": A, "family": family, "dist": dist,
                     "rowwise": rowwise, "padded": padded,
                     "nnz_class": nnz_cls, "dtype": dtype}


def _solve_statics(transform, A, B, method, pad_floor):
    """(statics, info) of a solve_l2_sketched request: A (n, d), B (n, t)
    or (n,); n pads, d and t are exact (a zero column would make the
    compressed problem singular)."""
    A, B = _as_operand(A), _as_operand(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if A.ndim != 2 or B.shape[0] != A.shape[0]:
        raise ValueError(f"solve expects (n,d) A and (n,t) B, got "
                         f"{tuple(A.shape)} / {tuple(B.shape)}")
    if A.shape[0] != transform.input_dim:
        raise ValueError(f"operand rows {A.shape[0]} != transform input "
                         f"dim {transform.input_dim}")
    family, dist = _sketch_family(transform)
    if family not in ("JLT", "CWT"):
        raise TypeError(f"solve serve path supports JLT/CWT, got {family}")
    n_pad = bucketing.pow2_pad(A.shape[0], pad_floor)
    statics = ("solve_l2_sketched", family, transform.sketch_dim, method,
               A.shape[1], B.shape[1], _dtype_name(A), n_pad)
    return statics, {"A": A, "B": B, "squeeze": squeeze, "family": family,
                     "dist": dist, "n_pad": n_pad}


def _sparse_solve_statics(transform, A, B, method, pad_floor):
    """(statics, info) of a sparse_solve_l2_sketched request: a CSR
    design matrix and a dense target block."""
    A = as_sparse(A)
    B = _as_operand(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if B.shape[0] != A.height:
        raise ValueError(f"solve expects (n,d) A and (n,t) B, got "
                         f"{A.shape} / {tuple(B.shape)}")
    if A.height != transform.input_dim:
        raise ValueError(f"operand rows {A.height} != transform input dim "
                         f"{transform.input_dim}")
    family, dist = _sketch_family(transform)
    if family not in ("JLT", "CWT"):
        raise TypeError(f"sparse solve serve path supports JLT/CWT, got "
                        f"{family}")
    n_pad = bucketing.pow2_pad(A.height, pad_floor)
    nnz_cls = bucketing.nnz_class(A.nnz, _env.SPARSE_NNZ_FLOOR.get())
    dtype = str(np.dtype(A.device_dtype))
    statics = ("sparse_solve_l2_sketched", family, transform.sketch_dim,
               method, A.width, B.shape[1], dtype, n_pad, nnz_cls)
    return statics, {"A": A, "B": B, "squeeze": squeeze, "family": family,
                     "dist": dist, "n_pad": n_pad, "nnz_class": nnz_cls,
                     "dtype": dtype}


def _seed_key_data(seed: int) -> np.ndarray:
    """The key data of ``jax.random.key(seed)``: the key of the
    seed-addressed endpoints (graph_ase, condest)."""
    return seed_key(int(seed))


def _graph_ase_statics(A, k, iters, pad_floor):
    """(statics, info) of a graph_ase request: the adjacency as CSR
    lanes; ``k`` and ``iters`` are statics, the seed an operand."""
    from libskylark_tpu_torch.ml.graph import coerce_adjacency

    S = coerce_adjacency(A)[0]
    padded = bucketing.pad_shape(S.shape, (0, 1), pad_floor)
    nnz_cls = bucketing.nnz_class(S.nnz, _env.SPARSE_NNZ_FLOOR.get())
    dtype = str(np.dtype(S.device_dtype))
    k = int(k)
    iters = max(int(iters), 1)
    if not 0 < k <= S.height:
        raise ValueError(f"embedding dim k={k} must be in (0, {S.height}]")
    statics = ("graph_ase", k, iters, dtype, padded, nnz_cls)
    return statics, {"A": S, "padded": padded, "nnz_class": nnz_cls,
                     "dtype": dtype, "k": k, "iters": iters}


def _graph_ppr_statics(A, s, alpha, iters, pad_floor):
    """(statics, info) of a graph_ppr request: ``alpha`` and ``iters``
    are statics; the personalization vector is an operand."""
    from libskylark_tpu_torch.ml.graph import coerce_adjacency

    S = coerce_adjacency(A)[0]
    padded = bucketing.pad_shape(S.shape, (0, 1), pad_floor)
    nnz_cls = bucketing.nnz_class(S.nnz, _env.SPARSE_NNZ_FLOOR.get())
    dtype = str(np.dtype(S.device_dtype))
    s = _host(s, dtype)
    if s.shape != (S.height,):
        raise ValueError(f"personalization vector shape {s.shape} != "
                         f"({S.height},)")
    alpha = float(alpha)
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    statics = ("graph_ppr", alpha, max(int(iters), 1), dtype, padded,
               nnz_cls)
    return statics, {"A": S, "s": s, "padded": padded,
                     "nnz_class": nnz_cls, "dtype": dtype, "alpha": alpha,
                     "iters": max(int(iters), 1)}


def _condest_statics(A, steps, pad_floor):
    """(statics, info) of a condest request: fixed-step Golub–Kahan."""
    A = _as_operand(A)
    if A.ndim != 2:
        raise ValueError(f"condest expects a matrix, got {tuple(A.shape)}")
    steps = max(int(steps), 1)
    if steps >= min(A.shape):
        raise ValueError(
            f"steps={steps} must be < min(shape)={min(A.shape)} "
            "(the Krylov space is exhausted past that)")
    padded = bucketing.pad_shape(A.shape, (0, 1), pad_floor)
    statics = ("condest", steps, _dtype_name(A), padded)
    return statics, {"A": A, "padded": padded, "steps": steps}


def _lowrank_statics(transform_s, transform_t, A, k, pad_floor):
    """(statics, info) of a lowrank request: a matched pair of dense
    transforms; the rows pad, the features are exact."""
    fam_s, dist_s = _sketch_family(transform_s)
    fam_t, dist_t = _sketch_family(transform_t)
    if fam_s != fam_t or repr(dist_s) != repr(dist_t):
        raise TypeError(f"lowrank serves a matched dense transform pair, "
                        f"got {fam_s}/{fam_t}")
    if dist_s is None:
        raise TypeError("lowrank serves dense families (JLT/CT); CWT has "
                        "no dense virtual panel here")
    A = _as_operand(A)
    if A.ndim != 2 or A.shape[1] != transform_s.input_dim \
            or A.shape[1] != transform_t.input_dim:
        raise ValueError(
            f"operand {tuple(A.shape)} does not match transform input dims "
            f"{transform_s.input_dim}/{transform_t.input_dim}")
    k = int(k)
    if not 0 < k <= transform_s.sketch_dim:
        raise ValueError(f"k={k} must be in (0, {transform_s.sketch_dim}]")
    m_pad = bucketing.pow2_pad(A.shape[0], pad_floor)
    dtype = _dtype_name(A)
    statics = ("lowrank", fam_s, repr(dist_s), transform_s.sketch_dim,
               transform_t.sketch_dim, k, A.shape[1], dtype, m_pad)
    return statics, {"A": A, "family": fam_s, "dist": dist_s,
                     "padded": (m_pad, A.shape[1]), "k": k,
                     "dtype": dtype}


def _lowrank_key_data(transform, dtype):
    """(key data, scale) of one lowrank transform, shared with the eager
    twin (``nla.lowrank.lowrank_serve``)."""
    return (np.asarray(transform.allocation.key, dtype=np.uint32),
            np.asarray(getattr(transform, "scale", 1.0),
                       dtype=np.dtype(str(dtype))))


def _kernel_identity(kernel) -> str:
    """What keys a KRR/RLSC bucket's kernel: the reference's
    ``engine.digest``, the first 16 hex digits of the sha256 of its JSON
    serialization (of its ``repr`` without one)."""
    to_json = getattr(kernel, "to_json", None)
    doc = to_json() if callable(to_json) else repr(kernel)
    return hashlib.sha256(str(doc).encode()).hexdigest()[:16]


def _krr_statics(kernel, X_new, X_train, coef, pad_floor,
                 endpoint: str = "krr_predict"):
    """(statics, info) of a krr_predict request, and with ``endpoint=
    "rlsc_predict"`` of its classification twin. Shape-only on the model
    operands; the query rows pad."""
    X_new = _as_operand(X_new)
    squeeze_q = X_new.ndim == 1
    if squeeze_q:
        X_new = X_new[None, :]
    train_shape = tuple(int(e) for e in np.shape(X_train))
    coef_shape = tuple(int(e) for e in np.shape(coef))
    if len(coef_shape) == 1:
        coef_shape = coef_shape + (1,)
    if X_new.shape[1] != train_shape[1]:
        raise ValueError(f"query dim {X_new.shape[1]} != train dim "
                         f"{train_shape[1]}")
    q_pad = bucketing.pow2_pad(X_new.shape[0], pad_floor)
    statics = (endpoint, _kernel_identity(kernel), train_shape, coef_shape,
               _dtype_name(X_new), q_pad)
    return statics, {"X_new": X_new, "squeeze_q": squeeze_q,
                     "q_pad": q_pad}


def default_cmm_transform(A, *, s_dim: Optional[int] = None,
                          seed: int = 0):
    """The transform ``submit_compressed_matmul`` builds when the caller
    holds none: SRHT (FJLT, ``wht``) when A's contraction dim is a power
    of two, CWT otherwise, at ``s_dim`` (default ``SKYLARK_FWHT_CM_SDIM``),
    from the allocation (seed, 0)."""
    n = int(A.shape[1] if hasattr(A, "shape") else np.asarray(A).shape[1])
    s = int(s_dim or _env.FWHT_CM_SDIM.get())
    alloc = Allocation(int(seed), 0)
    if n & (n - 1):
        from libskylark_tpu_torch.sketch.hash import CWT

        return CWT(n, s, alloc)
    from libskylark_tpu_torch.sketch.fjlt import FJLT

    return FJLT(n, s, alloc, fut="wht")


def _cmm_statics(transform, A, B, pad_floor):
    """(statics, info) of a compressed_matmul request: estimate A·B (A
    (m, n) dense or CSR, B (n, p) dense) as (A·Sᵀ)(S·B) with one CWT or
    SRHT S. n is exact, m and p pad; the error scale ‖A‖_F·‖B‖_F·√(2/s)
    is computed here, on the host for host operands."""
    family, _dist = _sketch_family(transform)
    if family not in ("CWT", "SRHT"):
        raise TypeError(
            f"compressed_matmul serves CWT/SRHT sketches, got {family} (a "
            "dense virtual panel would cost more than the product it "
            "estimates)")
    B = _as_operand(B)
    if B.ndim != 2:
        raise ValueError(f"compressed_matmul expects a (n, p) B, got "
                         f"{tuple(B.shape)}")
    sparse = _is_sparse(A)
    if sparse:
        A = as_sparse(A)
        m, n = A.shape
        dtype = str(np.dtype(A.device_dtype))
        norm_a = float(np.linalg.norm(A.csr_parts(np.dtype(dtype))[0]))
    else:
        A = _as_operand(A)
        if A.ndim != 2:
            raise ValueError(f"compressed_matmul expects a (m, n) A, got "
                             f"{tuple(A.shape)}")
        m, n = A.shape
        dtype = _dtype_name(A)
        norm_a = _fro(A)
    if B.shape[0] != n:
        raise ValueError(f"contraction mismatch: A is {(m, n)}, B is "
                         f"{tuple(B.shape)}")
    if n != transform.input_dim:
        raise ValueError(f"contraction dim {n} != transform input dim "
                         f"{transform.input_dim}")
    if family == "SRHT" and n & (n - 1):
        raise ValueError(f"SRHT compressed_matmul requires a power-of-2 "
                         f"contraction dim, got {n}")
    s_dim = transform.sketch_dim
    bound = norm_a * _fro(B) * math.sqrt(2.0 / s_dim)
    m_pad = bucketing.pow2_pad(m, pad_floor)
    p_pad = bucketing.pow2_pad(B.shape[1], pad_floor)
    nnz_cls = (bucketing.nnz_class(A.nnz, _env.SPARSE_NNZ_FLOOR.get())
               if sparse else 0)
    statics = ("compressed_matmul", family, s_dim, sparse, n, dtype, m_pad,
               p_pad, nnz_cls)
    return statics, {"A": A, "B": B, "family": family, "sparse": sparse,
                     "s_dim": s_dim, "n": n, "m": m, "p": B.shape[1],
                     "bound": bound, "padded_A": (m_pad, n),
                     "padded_B": (n, p_pad), "nnz_class": nnz_cls,
                     "dtype": dtype}


def derive_request(endpoint: str, *, pad_floor: int = bucketing.PAD_FLOOR,
                   **kwargs) -> tuple:
    """``(statics, info)`` of a request: the bucket statics and what the
    executor's packing reuses. Transport keywords (``timeout``,
    ``deadline``, ``request_id``, ``tenant``, ``qos_class``, ``_digest``)
    are ignored."""
    for transport in ("timeout", "deadline", "request_id", "tenant",
                      "qos_class", "_digest"):
        kwargs.pop(transport, None)
    if endpoint == "sketch_apply":
        return _sketch_statics(kwargs["transform"], kwargs["A"],
                               kwargs.get("dimension"), pad_floor)
    if endpoint == "fastfood_features":
        return _fastfood_statics(kwargs["transform"], kwargs["A"], pad_floor)
    if endpoint == "solve_l2_sketched":
        return _solve_statics(kwargs["transform"], kwargs["A"], kwargs["B"],
                              kwargs.get("method", "qr"), pad_floor)
    if endpoint == "krr_predict":
        return _krr_statics(kwargs["kernel"], kwargs["X_new"],
                            kwargs["X_train"], kwargs["coef"], pad_floor)
    if endpoint == "sparse_sketch_apply":
        return _sparse_sketch_statics(kwargs["transform"], kwargs["A"],
                                      kwargs.get("dimension"), pad_floor)
    if endpoint == "sparse_solve_l2_sketched":
        return _sparse_solve_statics(kwargs["transform"], kwargs["A"],
                                     kwargs["B"], kwargs.get("method", "qr"),
                                     pad_floor)
    if endpoint == "graph_ase":
        return _graph_ase_statics(kwargs["A"], kwargs["k"],
                                  kwargs.get("iters", 2), pad_floor)
    if endpoint == "graph_ppr":
        return _graph_ppr_statics(kwargs["A"], kwargs["s"],
                                  kwargs.get("alpha", 0.85),
                                  kwargs.get("iters", 16), pad_floor)
    if endpoint == "condest":
        return _condest_statics(kwargs["A"], kwargs.get("steps", 8),
                                pad_floor)
    if endpoint == "lowrank":
        return _lowrank_statics(kwargs["transform_s"], kwargs["transform_t"],
                                kwargs["A"], kwargs["k"], pad_floor)
    if endpoint == "rlsc_predict":
        return _krr_statics(kwargs["kernel"], kwargs["X_new"],
                            kwargs["X_train"], kwargs["coef"], pad_floor,
                            endpoint="rlsc_predict")
    if endpoint == "compressed_matmul":
        return _cmm_statics(kwargs["transform"], kwargs["A"], kwargs["B"],
                            pad_floor)
    raise ValueError(f"unknown serve endpoint {endpoint!r}; expected one of "
                     f"{ENDPOINTS}")


def request_statics(endpoint: str, *, pad_floor: int = bucketing.PAD_FLOOR,
                    **kwargs) -> tuple:
    """The bucket statics a request of ``endpoint`` with these operands
    lands in: (endpoint, family, dist, sketch dim, orientation, dtype,
    shape class, ...), as the reference's executor keys them (a KRR/RLSC
    kernel by its JSON where the reference has its digest)."""
    return derive_request(endpoint, pad_floor=pad_floor, **kwargs)[0]


def request_digest(endpoint: str, derived: tuple, kwargs: dict, *,
                   host: Optional[dict] = None, d2h=None) -> str:
    """The request's content address, the reference's hex: blake2b-256
    over the bucket statics and everything else that reaches the flush —
    the transform's key data (the same operand under another seed is
    another request), its scale, the operand bytes (CSR operands by their
    (data, indices, indptr) parts, never densified), and the model or
    seed material of each endpoint.

    ``derived`` is :func:`derive_request`'s ``(statics, info)`` and
    ``kwargs`` the endpoint keywords it was derived from. ``host`` maps
    an operand name to host bytes to hash in its place (a resident
    operand's, so that a submit by reference copies nothing off the
    card); ``d2h`` receives the bytes of each CUDA tensor copied to the
    host to be hashed."""
    statics, info = derived
    kd = MicrobatchExecutor._key_data
    host = host or {}

    def scale_of(t):
        return np.float64(getattr(t, "scale", 1.0))

    def csr(A, dtype):
        data, indices, indptr = A.csr_parts(np.dtype(dtype))
        return [("shape", repr(tuple(A.shape))), ("data", data),
                ("indices", indices), ("indptr", indptr)]

    def operand(name):
        a = info[name]
        h = host.get(name)
        return a if h is None else np.reshape(h, tuple(a.shape))

    if endpoint in ("sketch_apply", "fastfood_features"):
        t = kwargs["transform"]
        parts = [("kd", kd(t)), ("scale", scale_of(t)),
                 ("A", operand("A"))]
    elif endpoint == "solve_l2_sketched":
        t = kwargs["transform"]
        parts = [("kd", kd(t)), ("scale", scale_of(t)),
                 ("A", operand("A")), ("B", info["B"])]
    elif endpoint in ("krr_predict", "rlsc_predict"):
        # the model's content is part of the address (the bucket key's
        # object ids only keep cohorts unmixed)
        parts = [("Xq", info["X_new"]),
                 ("X_train", _rcache.host_bytes(kwargs["X_train"], d2h)),
                 ("coef", _rcache.host_bytes(kwargs["coef"], d2h)),
                 ("coding", repr(kwargs.get("coding")))]
    elif endpoint in ("sparse_sketch_apply", "sparse_solve_l2_sketched"):
        t = kwargs["transform"]
        parts = [("kd", kd(t)), ("scale", scale_of(t))]
        parts += csr(info["A"], info["dtype"])
        if endpoint == "sparse_solve_l2_sketched":
            parts.append(("B", info["B"]))
    elif endpoint == "graph_ase":
        parts = [("seed", repr(int(kwargs.get("seed", 0))))]
        parts += csr(info["A"], info["dtype"])
    elif endpoint == "graph_ppr":
        parts = csr(info["A"], info["dtype"]) + [("s", info["s"])]
    elif endpoint == "condest":
        parts = [("seed", repr(int(kwargs.get("seed", 0)))),
                 ("A", operand("A"))]
    elif endpoint == "lowrank":
        ts, tt = kwargs["transform_s"], kwargs["transform_t"]
        parts = [("kd_s", kd(ts)), ("scale_s", scale_of(ts)),
                 ("kd_t", kd(tt)), ("scale_t", scale_of(tt)),
                 ("A", operand("A"))]
    elif endpoint == "compressed_matmul":
        t = kwargs["transform"]
        parts = [("kd", kd(t)), ("scale", scale_of(t))]
        if info["sparse"]:
            parts += csr(info["A"], info["dtype"])
        else:
            parts.append(("A", operand("A")))
        parts.append(("B", info["B"]))
    else:
        raise ValueError(f"unknown serve endpoint {endpoint!r}; "
                         f"expected one of {ENDPOINTS}")
    return _rcache.operand_digest(parts, statics=statics, d2h=d2h)


# ---------------------------------------------------------------------------
# kernel qualification and the flush programs
# ---------------------------------------------------------------------------


def qualify(ctx: dict) -> tuple[bool, str]:
    """Host-side (ok, reason) of a bucket's kernels, from its statics
    alone: float32; Fastfood with the wht core and an NB the kernel holds;
    SRHT with n a power of two the kernel takes; JLT/CT with a
    distribution the dense kernel generates; CWT always."""
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
    family = ctx["family"]
    if family == "CWT":
        return True, "ok"
    if family == "SRHT":
        if ctx["endpoint"] == "compressed_matmul":
            n = ctx["n"]
        else:
            rows, cols = ctx["padded"]
            n = cols if ctx["rowwise"] else rows
        if not cuda_fwht.supported(n, s_dim, torch.float32):
            return False, (f"SRHT n={n}, s={s_dim} outside the kernel's "
                           f"range (n a power of two >= {cuda_fwht.MIN_N}, "
                           f"s <= {cuda_fwht.MAX_S})")
        return True, "ok"
    if not cuda_dense.supported(ctx["dist"], torch.float32):
        return False, f"distribution {ctx['dist']!r} has no kernel"
    return True, "ok"


def _sketch_flush(ctx: dict, kernel: bool, kd, scale, arrays: dict):
    """The sketch endpoints' batched program: the kernel's wrapper, or its
    plain version."""
    from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood,
                                             cuda_fwht, cuda_hash,
                                             cuda_sparse, sparse_serve)

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
            rows = sparse_serve.csr_row_ids(indptr, data.shape[1],
                                            torch.int32)
            fn = (cuda_sparse.cwt_sparse_apply_batched if kernel
                  else cuda_sparse.cwt_sparse_plain)
            return fn(kd, data, rows, indices, s_dim, rowwise, ctx["padded"])
        A = sparse_serve.scatter_dense(data, indices, indptr,
                                       shape=ctx["padded"])
    fn = (cuda_dense.serve_batched_apply if kernel
          else cuda_dense.serve_batched_plain)
    return fn(kd, scale, A, ctx["dist"], s_dim, rowwise)


def sketch_stage(ctx: dict, kd, scale, arrays: dict,
                 plain: bool = False) -> tuple:
    """The kernel route's sketches of a solve, compressed-matmul or
    lowrank flush over the stacked cohort: one batched launch per operand
    (the wrappers take their plain versions on CPU tensors, and all of
    them with ``plain``). Returns the sketched operands the lanes' library
    half takes: (S·A, S·B) of a solve, (A·Sᵀ, S·B) of a compressed
    matmul, (A·Sᵀ, A·Tᵀ) of a lowrank request."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fwht,
                                             cuda_hash, cuda_sparse,
                                             sparse_serve)

    dense = (cuda_dense.serve_batched_plain if plain
             else cuda_dense.serve_batched_apply)
    hashed = (cuda_hash.cwt_apply_batched_plain if plain
              else cuda_hash.cwt_apply_batched)
    srht = (cuda_fwht.srht_apply_batched_plain if plain
            else cuda_fwht.srht_apply_batched)
    endpoint, family, s_dim = ctx["endpoint"], ctx["family"], ctx["s_dim"]
    if endpoint == "lowrank":
        A = arrays["A"]
        return (dense(kd, scale, A, ctx["dist"], s_dim, True),
                dense(arrays["kd_t"], arrays["scale_t"], A, ctx["dist"],
                      ctx["t_dim"], True))
    a_rowwise = endpoint == "compressed_matmul"
    if "data" in arrays:
        data, indices, indptr = (arrays["data"], arrays["indices"],
                                 arrays["indptr"])
        if family == "CWT":
            rows = sparse_serve.csr_row_ids(indptr, data.shape[1],
                                            torch.int32)
            sparse = (cuda_sparse.cwt_sparse_plain if plain
                      else cuda_sparse.cwt_sparse_apply_batched)
            SA = sparse(kd, data, rows, indices, s_dim, a_rowwise,
                        ctx["padded_A"])
            return SA, hashed(kd, arrays["B"], s_dim, False)
        A = sparse_serve.scatter_dense(data, indices, indptr,
                                       shape=ctx["padded_A"])
    else:
        A = arrays["A"]
    B = arrays["B"]
    if family == "CWT":
        return hashed(kd, A, s_dim, a_rowwise), hashed(kd, B, s_dim, False)
    if family == "SRHT":
        return srht(kd, A, s_dim, a_rowwise), srht(kd, B, s_dim, False)
    return (dense(kd, scale, A, randgen.Normal(), s_dim, False),
            dense(kd, scale, B, randgen.Normal(), s_dim, False))


def _lane(x: torch.Tensor) -> torch.Tensor:
    """A lane as a fresh tensor: the library calls then see the same
    operand, alignment included, at every capacity."""
    return x.clone()


def _lane_stage(ctx: dict, sketched: tuple) -> list:
    """The library half of a kernel flush, lane by lane."""
    from libskylark_tpu_torch.algorithms.regression import solve_l2_exact
    from libskylark_tpu_torch.nla.lowrank import _lowrank_tail

    X, Y = sketched
    endpoint = ctx["endpoint"]
    out = []
    for i in range(X.shape[0]):
        x, y = _lane(X[i]), _lane(Y[i])
        if endpoint == "lowrank":
            out.append(_lowrank_tail(x, y, ctx["k"]))
        elif endpoint == "compressed_matmul":
            out.append(x @ y)
        else:
            out.append(solve_l2_exact(x, y, method=ctx["method"],
                                      device=x.device))
    return out


def _plain_lanes(ctx: dict, kd, scale, arrays: dict) -> list:
    """The plain program of a solve or lowrank flush: the single-request
    program lane by lane, each on a fresh copy of its lane. A compressed
    matmul's is the kernels' plain versions, then its lanes' products, as
    the sketch endpoints'."""
    from libskylark_tpu_torch.algorithms.regression import \
        sketched_solve_serve
    from libskylark_tpu_torch.nla.lowrank import lowrank_serve_apply
    from libskylark_tpu_torch.sketch.sparse_serve import sparse_solve_serve

    endpoint = ctx["endpoint"]
    out = []
    for i in range(len(kd)):
        if endpoint == "solve_l2_sketched":
            out.append(sketched_solve_serve(
                kd[i], scale[i], _lane(arrays["A"][i]), _lane(arrays["B"][i]),
                sketch_type=ctx["family"], s_dim=ctx["s_dim"],
                method=ctx["method"]))
        elif endpoint == "sparse_solve_l2_sketched":
            out.append(sparse_solve_serve(
                kd[i], scale[i], *(_lane(arrays[n][i]) for n in (
                    "data", "indices", "indptr", "B")),
                sketch_type=ctx["family"], s_dim=ctx["s_dim"],
                method=ctx["method"], shape=ctx["padded_A"]))
        else:
            out.append(lowrank_serve_apply(
                kd[i], scale[i], arrays["kd_t"][i], arrays["scale_t"][i],
                _lane(arrays["A"][i]), dist=ctx["dist"], s=ctx["s_dim"],
                t=ctx["t_dim"], k=ctx["k"]))
    return out


def _library_lanes(ctx: dict, kd, arrays: dict) -> list:
    """The programs of the endpoints with no sketch, lane by lane."""
    from libskylark_tpu_torch.ml.graph import (ase_serve_apply,
                                               ppr_serve_apply)
    from libskylark_tpu_torch.ml.krr import krr_predict_kernel
    from libskylark_tpu_torch.nla.condest import condest_serve_apply

    endpoint = ctx["endpoint"]
    out = []
    for i in range(len(kd)):
        if endpoint in ("krr_predict", "rlsc_predict"):
            X_train, coef = ctx["model"]
            y = krr_predict_kernel(ctx["kernel"], _lane(arrays["Xq"][i]),
                                   X_train, coef)
            if endpoint == "rlsc_predict":
                y = torch.argmax(y, dim=1).to(torch.int32)
        elif endpoint == "condest":
            y = condest_serve_apply(kd[i], _lane(arrays["A"][i]),
                                    steps=ctx["steps"])
        elif endpoint == "graph_ase":
            y = ase_serve_apply(kd[i], *(_lane(arrays[n][i]) for n in (
                "data", "indices", "indptr")), k=ctx["k"],
                iters=ctx["iters"], shape=ctx["padded"],
                nnz=int(arrays["nnz"][i]))
        else:
            y = ppr_serve_apply(*(_lane(arrays[n][i]) for n in (
                "data", "indices", "indptr", "s")), alpha=ctx["alpha"],
                iters=ctx["iters"], shape=ctx["padded"],
                nnz=int(arrays["nnz"][i]), deg=_lane(arrays["deg"][i]))
        out.append(y)
    return out


def run_flush(ctx: dict, route: str, kd: np.ndarray, scale: np.ndarray,
              arrays: dict):
    """One flush's program over the stacked cohort. ``route`` is "cuda"
    (the batched kernels' wrappers, then the library half lane by lane),
    "plain" (the kernels' plain versions, or the single-request program
    lane by lane) or "library" (the endpoints with no sketch). ``kd`` (B,
    2) uint32 and ``scale`` (B,) are host arrays; ``arrays`` holds the
    stacked operands, tensors and host arrays. A sketch flush whose ctx
    holds the executor's ``flush_fn`` (a ``CompiledFn``) runs through it,
    on :func:`flush_args`. Returns the (B, ...) result."""
    from libskylark_tpu_torch.base.precision import solver_precision

    endpoint = ctx["endpoint"]
    if endpoint in _SKETCH_ENDPOINTS:
        fn = ctx.get("flush_fn")
        if fn is not None:
            return fn(*flush_args(ctx, kd, scale, arrays))
        return _sketch_flush(ctx, route == "cuda", kd, scale, arrays)
    # the solve and KRR programs run at the solvers' matmul precision,
    # as the reference's flushes of these endpoints do
    with solver_precision():
        if route == "library":
            out = _library_lanes(ctx, kd, arrays)
        elif route == "plain" and endpoint != "compressed_matmul":
            out = _plain_lanes(ctx, kd, scale, arrays)
        else:
            out = _lane_stage(ctx, sketch_stage(ctx, kd, scale, arrays,
                                                plain=route == "plain"))
    return torch.stack(out)


def flush_args(ctx: dict, kd: np.ndarray, scale: np.ndarray,
               arrays: dict) -> tuple:
    """A captured sketch flush's inputs on the operand's device: the keys
    as the kernels' (B, 2) int32 words, the (B,) scales (not for
    Fastfood) and the stacked operand."""
    A = arrays["A"]
    words = np.ascontiguousarray(np.asarray(kd, dtype=np.uint32))
    keys = torch.from_numpy(words.view(np.int32)).to(A.device,
                                                     non_blocking=True)
    if ctx["endpoint"] == "fastfood_features":
        return keys, A
    scales = torch.from_numpy(np.ascontiguousarray(scale)).to(
        A.device, non_blocking=True)
    return keys, scales, A


def _env_route(statics) -> Optional[str]:
    """The route an environment pin names for a kernel bucket, or None:
    ``SKYLARK_FWHT_KERNEL`` (SRHT buckets) and ``SKYLARK_SPARSE_KERNEL``
    (sparse buckets) ahead of ``SKYLARK_SERVE_KERNEL``."""
    statics = tuple(statics)
    if not statics or statics[0] not in _KERNEL_ENDPOINTS:
        return None
    pins = []
    if statics[0] == "sketch_apply" and len(statics) > 1 \
            and statics[1] == "SRHT":
        pins.append(_env.FWHT_KERNEL.get())
    if statics[0] == "sparse_sketch_apply":
        pins.append(_env.SPARSE_KERNEL.get())
    pins.append(_env.SERVE_KERNEL.get())
    for pin in pins:
        if pin is not None:
            return _BACKEND_ROUTES[pin]
    return None


def _build_flush_fn(statics, ctx: dict, route: str):
    """The ``CompiledFn`` of a sketch bucket's flush on ``route``, keyed
    on its statics plus ``("kernel", route)`` (the reference's
    ``_compiled_for``), the stacked operand donated: the executor stacked
    it for this flush alone."""
    from libskylark_tpu_torch.engine.compiled import compiled

    kernel = route == "cuda"
    extra = tuple(statics) + ("kernel", route)

    def key_fn(*args):
        return extra

    if ctx["endpoint"] == "fastfood_features":
        def batched_fastfood(kd, A):
            return _sketch_flush(ctx, kernel, kd, None, {"A": A})

        return compiled(batched_fastfood, name="serve.fastfood_features",
                        donate_argnums=(1,), key_fn=key_fn)

    def batched_sketch(kd, scale, A):
        return _sketch_flush(ctx, kernel, kd, scale, {"A": A})

    return compiled(batched_sketch, name="serve.sketch_apply",
                    donate_argnums=(2,), key_fn=key_fn)


def _unpad(endpoint: str, out: torch.Tensor, lane: int, r: _Request):
    if endpoint == "fastfood_features":
        p = out[lane, :r.meta["m"], :]
        return p[0] if r.meta["squeeze"] else p
    if endpoint in ("sketch_apply", "sparse_sketch_apply"):
        if endpoint == "sketch_apply":
            h, w = r.true_shapes["A"]
        else:
            h, w = r.meta["shape"]
        if r.meta["rowwise"]:
            return out[lane, :h, :]
        return out[lane, :, :w]
    if endpoint in ("solve_l2_sketched", "sparse_solve_l2_sketched"):
        x = out[lane]
        return x[:, 0] if r.meta["squeeze"] else x
    if endpoint == "compressed_matmul":
        return out[lane, :r.meta["m"], :r.meta["p"]], r.meta["bound"]
    if endpoint == "graph_ase":
        return out[lane, :r.meta["n"], :]
    if endpoint == "graph_ppr":
        return out[lane, :r.meta["n"]]
    if endpoint == "condest":
        return out[lane]
    if endpoint == "lowrank":
        return out[lane, :r.meta["m"], :]
    if endpoint == "rlsc_predict":
        p = out[lane, :r.meta["q"]]
        coding = r.meta["coding"]
        if coding is not None:
            p = np.asarray([coding[int(i)] for i in p.tolist()])
        return p[0] if r.meta["squeeze_q"] else p
    p = out[lane, :r.meta["q"], :]
    if r.meta["squeeze_t"]:
        p = p[:, 0]
    return p[0] if r.meta["squeeze_q"] else p


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


class MicrobatchExecutor:
    """Thread-safe microbatching executor over the twelve local endpoints.

    ::

        ex = engine.MicrobatchExecutor(max_batch=8, linger_us=2000)
        fut = ex.submit_sketch(transform, A, dimension=sk.ROWWISE)
        SA = fut.result()
        ex.shutdown()

    ``device`` is where flushes run and results live (the package default,
    "cuda", unless given); ``kernel`` is None (each qualified bucket's
    kernel on a CUDA executor), ``"cuda"`` (the same, refused on a CPU
    executor) or ``"plain"`` (the plain programs). ``workers`` flush
    cohorts concurrently; with ``dispatch_queue`` (a ``queue.Queue``)
    the executor puts its cohorts there instead and starts no workers, and
    the queue's owner runs :func:`dispatch_loop` threads (several
    executors may share one). ``degraded_threshold``, ``failure_window``
    and ``shed_fraction`` set the DEGRADED detector and its shed bounds;
    ``tenants`` the :class:`~libskylark_tpu_torch.qos.TenantRegistry`;
    ``adaptive`` starts the adaptive batching controller; ``cache`` (None:
    ``SKYLARK_CACHE``) turns on the result cache of ``cache_bytes``
    (None: ``SKYLARK_CACHE_MAX_BYTES``) bytes of device memory.
    Submission is a host-side pack and a queue append, safe from any
    thread.
    """

    def __init__(self, max_batch: int = 8, linger_us: int = 2000,
                 max_queue: int = 1024, workers: int = 1,
                 pad_floor: int = bucketing.PAD_FLOOR,
                 degraded_threshold: float = 0.5,
                 failure_window: int = 32,
                 shed_fraction: float = 0.25,
                 name: Optional[str] = None,
                 dispatch_queue=None,
                 kernel: Optional[str] = None,
                 tenants=None,
                 adaptive: bool = False,
                 cache: Optional[bool] = None,
                 cache_bytes: Optional[int] = None,
                 device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if kernel is not None and kernel not in KERNEL_CHOICES:
            raise ValueError(f"kernel must be one of {KERNEL_CHOICES} or "
                             f"None, got {kernel!r}")
        if not 0.0 < degraded_threshold <= 1.0:
            raise ValueError("degraded_threshold must be in (0, 1]")
        if not 0.0 < shed_fraction <= 1.0:
            raise ValueError("shed_fraction must be in (0, 1]")
        self.device = resolve_device(device)
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
        self.degraded_threshold = float(degraded_threshold)
        self.shed_fraction = float(shed_fraction)

        self._lock = _locks.make_lock("serve.state")
        self._work_cv = threading.Condition(self._lock)
        self._space_cv = threading.Condition(self._lock)
        self._idle_cv = threading.Condition(self._lock)
        self._buckets: dict[tuple, _Bucket] = {}
        self._routes: dict[tuple, tuple] = {}
        self._qualified: dict[tuple, tuple] = {}
        # (statics, capacity) -> route a warmup pack restored, and ->
        # (route, source) of the plan cache's choice; both for the plan
        # fingerprint _plan_fp
        self._restored: dict[tuple, str] = {}
        self._plan_memo: dict[tuple, tuple] = {}
        self._plan_fp: Optional[str] = None
        # (statics, route) -> the flush's CompiledFn
        self._compiled: dict[tuple, object] = {}
        self._pending = 0
        self._inflight = 0
        self._stop = False
        self._draining = False
        # QoS: the registry resolves tenants to classes and charges their
        # buckets; the deficit scheduler orders the class queues; the
        # per-bucket (linger, cap) targets move only under the controller
        self._tenants = (tenants if tenants is not None
                         else _qtenants.get_registry())
        self._sched = _qsched.DeficitScheduler(quantum=self.max_batch)
        self._class_pending = collections.Counter()     # under _lock
        self._qos_targets: dict[tuple, list] = {}      # under _lock

        self._stats_lock = _locks.make_lock("serve.stats")
        self._counts = collections.Counter()
        self._kernel_sel = collections.Counter()
        self._kernel_dec = collections.Counter()
        self._kernel_src = collections.Counter()
        self._capture = collections.Counter()
        self._sparse_sel = collections.Counter()
        self._sparse_nnz_hist = collections.Counter()
        self._fwht_sel = collections.Counter()
        self._batch_hist = collections.Counter()
        self._cohort_hist = collections.Counter()
        self._pad_real = 0
        self._pad_total = 0
        self._latency = collections.deque(maxlen=8192)
        self._by_bucket: dict[tuple, collections.Counter] = {}
        # QoS accounting: (kind, class, tenant) counts, per-class latency
        # and queue-wait windows, per-bucket controller observations
        self._qos_counts = collections.Counter()
        self._latency_by_class = {
            c: collections.deque(maxlen=4096) for c in _qtenants.CLASSES}
        self._wait_by_class = {
            c: collections.deque(maxlen=4096) for c in _qtenants.CLASSES}
        self._bucket_obs: dict = {}
        # the DEGRADED detector's evidence: root flush outcomes, 1.0 failed
        self._health = collections.deque(maxlen=max(int(failure_window), 4))
        self._pub_lock = _locks.make_lock("serve.pub")
        self._published_state = SERVING
        # KRR/RLSC models on the device, one per bucket key, each pinned
        # with the caller's objects whose ids key it
        self._models: dict[tuple, tuple] = {}
        # the result cache (opt-in) and the residency table (always: an
        # OperandRef must resolve on a cache-off executor too)
        if cache is None:
            cache = bool(_env.CACHE.get())
        self._cache = (_rcache.ResultCache(name=self.name,
                                           max_bytes=cache_bytes)
                       if cache else None)
        self._residency = _rcache.ResidencyTable(name=self.name,
                                                 device=self.device)
        # the session registry, built by the first session verb; the
        # train manager, by the first train verb
        self._session_registry = None
        self._train_mgr = None
        # the dist endpoints' local coordinator (made once) and their
        # shard dispatches by replica
        self._dist_local_co = None
        self._dist_by_replica = collections.Counter()

        if dispatch_queue is not None:
            self._workq = dispatch_queue
            self._workers = []
        else:
            self._workq = queue.Queue()
            self._workers = [
                threading.Thread(target=dispatch_loop, args=(self._workq,),
                                 name=f"skylark-serve-worker-{i}",
                                 daemon=True)
                for i in range(max(int(workers), 1))]
            for t in self._workers:
                t.start()
        self._flusher = threading.Thread(target=self._flusher_loop,
                                         name="skylark-serve-flusher",
                                         daemon=True)
        self._flusher.start()
        self._controller = None
        if adaptive:
            from libskylark_tpu_torch.qos.controller import \
                AdaptiveController

            self._controller = AdaptiveController(self)
        _EXECUTORS.add(self)

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------

    def _device_scope(self):
        """The executor's CUDA device as the current one (CUDA's current
        device is per thread), or nothing on a CPU executor."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _admit(self, endpoint: str, tenant, qos_class) -> tuple:
        """(tenant, class) of a request past QoS admission: a tenant's
        class from the registry, its token bucket charged
        (:class:`~libskylark_tpu_torch.base.errors.TenantQuotaError` when
        empty); a request with ``qos_class=`` was admitted by a front
        door already and is not charged again."""
        if qos_class is None:
            try:
                tenant, qos_class = self._tenants.admit(tenant)
            except errors.TenantQuotaError as e:
                cls = self._tenants.resolve(tenant)[1]
                with self._stats_lock:
                    self._qos_counts[("rate_limited", cls, e.tenant)] += 1
                _QOS_RATE_LIMITED.inc(**{"class": cls, "tenant": e.tenant})
                raise
            # unregistered names account under the anonymous tenant, so
            # label sets cannot grow with arbitrary caller strings
            tenant = self._tenants.accounting_name(tenant)
        else:
            qos_class = _qtenants.coerce_class(qos_class)
            tenant = str(tenant) if tenant else ""
        faults.check("qos.admit", tags=faults.current_tags(),
                     detail=f"{endpoint} {tenant or '-'} {qos_class}")
        return tenant, qos_class

    def submit(self, endpoint: str, /, **kwargs) -> Future:
        """Queue one request; the future resolves to what the endpoint's
        sequential program returns, as a tensor on the executor's device.
        ``timeout`` (seconds, default 30) bounds the backpressure wait;
        ``deadline`` (seconds or a
        :class:`~libskylark_tpu_torch.resilience.Deadline`) bounds the
        request's queued life; ``tenant`` (or a front door's resolved
        ``qos_class``) its priority class; ``request_id`` names it in the
        trace. An ``A=`` that is an :class:`~libskylark_tpu_torch.engine.
        resultcache.OperandRef` takes the resident operand."""
        timeout = kwargs.pop("timeout", 30.0)
        deadline = Deadline.coerce(kwargs.pop("deadline", None))
        rid = kwargs.pop("request_id", None)
        tenant, qos_class = self._admit(endpoint, kwargs.pop("tenant", None),
                                        kwargs.pop("qos_class", None))
        digest = kwargs.pop("_digest", None)
        host = None
        if _rcache.is_ref(kwargs.get("A")):
            d = _rcache.as_ref(kwargs["A"]).digest
            host = {"A": self._residency.host(d)}
            kwargs["A"] = self._residency.resolve(d)
        derived = None
        flight = None
        leader = Future()
        if self._cache is not None and not self._is_degraded():
            if digest is None:
                derived = derive_request(endpoint, pad_floor=self.pad_floor,
                                         **kwargs)
                digest = request_digest(endpoint, derived, kwargs, host=host,
                                        d2h=self._cache.note_digest_d2h)
            pinned = self._residency.result(digest)
            if pinned is not None:
                self._cache.note_hit(qos_class, pinned)
                return self._bypass_future(qos_class, pinned)
            kind, got = self._cache.claim(digest, qos_class, leader)
            if kind == "hit":
                return self._bypass_future(qos_class, got)
            if kind == "follow":
                with self._lock:
                    self._sched.note_bypass(qos_class)
                return got
            flight = got
        if rid is None and _telemetry.enabled():
            rid = _trace.new_request_id()
        try:
            # the submit span covers pack and enqueue; its context rides
            # the request into the flush thread
            with _trace.span("serve.submit", attrs={"endpoint": endpoint},
                             request_id=rid) as sp:
                key, ctx, req = self._prepare(endpoint, _derived=derived,
                                              **kwargs)
                req.future = leader
                req.deadline = deadline
                req.request_id = rid
                req.qos_class = qos_class
                req.tenant = tenant or ""
                req.flight = flight
                if sp is not None:
                    req.tctx = sp.context()
                req.tags = faults.current_tags()
                self._enqueue(key, ctx, req, timeout)
        except BaseException as e:
            if flight is not None:
                self._cache.abort_flight(flight, e)
            raise
        if flight is not None:
            leader.add_done_callback(
                lambda f, _fl=flight: self._cache.settle_flight(
                    _fl, f, insert=not self._is_degraded()))
        return leader

    def _prepare(self, endpoint: str, _derived=None, **kwargs) -> tuple:
        """(bucket key, ctx, request) of one request, packed on the host
        (``_derived``: its :func:`derive_request`, when already made)."""
        if _derived is None:
            _derived = derive_request(endpoint, pad_floor=self.pad_floor,
                                      **kwargs)
        statics, info = _derived
        prep = {"sketch_apply": self._prep_sketch,
                "fastfood_features": self._prep_fastfood,
                "sparse_sketch_apply": self._prep_sparse,
                "solve_l2_sketched": self._prep_solve,
                "sparse_solve_l2_sketched": self._prep_sparse_solve,
                "compressed_matmul": self._prep_cmm,
                "lowrank": self._prep_lowrank,
                "krr_predict": self._prep_krr,
                "rlsc_predict": self._prep_krr,
                "condest": self._prep_condest,
                "graph_ase": self._prep_graph,
                "graph_ppr": self._prep_graph}[endpoint]
        return prep(statics, info, kwargs)

    def _bypass_future(self, cls: str, value) -> Future:
        """A request served without a flush (a pinned result or a cache
        hit): a resolved future holding the caller's own clone, made on
        the executor's device and finished, and noted in the scheduler's
        fairness ledger."""
        with self._lock:
            self._sched.note_bypass(cls)
        with self._device_scope():
            out = _rcache.handout_synced(value)
        f: Future = Future()
        f.set_result(out)
        return f

    # -- residency -----------------------------------------------------

    def register_operand(self, A, transform=None, dimension=None,
                         **kw) -> "_rcache.OperandRef":
        """Pin ``A`` resident on the executor's device (uploaded once) and
        return its :class:`~libskylark_tpu_torch.engine.resultcache.
        OperandRef`, the digest of its bytes. A later submit may pass the
        ref as ``A=`` of any dense endpoint: no bytes of A are shipped, the
        flush stacks the resident operand by a device-to-device copy, and
        with the cache on the request digest is that of the raw bytes.
        With ``transform=`` the operand is sketched once, by an ordinary
        submit, and the sketch pinned under the request's digest: a later
        ``submit_sketch(transform, ref)`` on a cache-on executor is served
        from the pin with no launch. Pins live until
        :meth:`unregister_operand`; registering the same bytes again is a
        no-op. A CUDA ``A`` is copied to the host once to be digested."""
        host = _rcache.host_bytes(
            A, self._cache.note_digest_d2h if self._cache is not None
            else None)
        d = _rcache.operand_digest([("A", host)])
        resident = (A if isinstance(A, torch.Tensor)
                    and A.device.type != "cpu" else None)
        self._residency.pin(d, host, resident=resident)
        ref = _rcache.OperandRef(d)
        if transform is not None:
            value = self.submit("sketch_apply", transform=transform, A=ref,
                                dimension=dimension, **kw).result()
            kwargs = {"transform": transform,
                      "A": self._residency.resolve(d),
                      "dimension": dimension}
            derived = derive_request("sketch_apply",
                                     pad_floor=self.pad_floor, **kwargs)
            rd = request_digest("sketch_apply", derived, kwargs,
                                host={"A": host})
            self._residency.pin_result(rd, value, owner=d)
        return ref

    def unregister_operand(self, ref) -> bool:
        """Unpin a registered operand and every result pinned with it;
        whether it was resident. Cache entries of its requests stay
        (ordinary quota-bounded entries)."""
        return self._residency.unpin(_rcache.as_ref(ref).digest)

    def resident_operands(self) -> list:
        """Digests of the operands pinned here, sorted."""
        return self._residency.digests()

    def _cache_stats_block(self) -> Optional[dict]:
        """The ``stats()["cache"]`` block: the cache's counters and the
        residency sub-block; None on a cache-off executor with nothing
        pinned."""
        res = self._residency.stats()
        if self._cache is None:
            if not res["resident_operands"] and not res["pinned_results"]:
                return None
            return {"residency": res}
        blk = self._cache.stats()
        blk["residency"] = res
        return blk

    def submit_sketch(self, transform, A, dimension=None, **kw) -> Future:
        return self.submit("sketch_apply", transform=transform, A=A,
                           dimension=dimension, **kw)

    def submit_fastfood(self, transform, A, **kw) -> Future:
        """Fastfood feature-map endpoint: resolves to
        ``transform.apply(A, ROWWISE)`` (1-D input gives (S,))."""
        return self.submit("fastfood_features", transform=transform, A=A,
                           **kw)

    def submit_solve(self, A, B, transform, method: str = "qr",
                     **kw) -> Future:
        """Sketch-and-solve endpoint: A (n, d), B (n, t) or (n,), a JLT or
        CWT transform of input dim n; resolves to the (d, t) (or (d,))
        solution of the sketched problem, what ``regression.
        sketched_solve_serve`` computes."""
        return self.submit("solve_l2_sketched", A=A, B=B,
                           transform=transform, method=method, **kw)

    def _note_sparse_intake(self, A) -> bool:
        """Count one sparse submission; whether to densify it (density at
        or above ``SKYLARK_SPARSE_MIN_DENSITY``: the padded CSR lanes
        would carry more bytes than the dense operand)."""
        nnz_cls = bucketing.nnz_class(A.nnz, _env.SPARSE_NNZ_FLOOR.get())
        densify = A.density >= _env.SPARSE_MIN_DENSITY.get()
        _SPARSE_SUBMITS.inc_always()
        _SPARSE_NNZ_HIST.observe_always(float(nnz_cls))
        with self._stats_lock:
            self._counts["sparse_submits"] += 1
            self._sparse_nnz_hist[nnz_cls] += 1
            if densify:
                self._counts["sparse_densified"] += 1
        if densify:
            _SPARSE_DENSIFIED.inc_always()
        return densify

    @staticmethod
    def _densified(A) -> np.ndarray:
        return np.asarray(A.to_scipy().toarray(), dtype=A.device_dtype)

    def submit_sparse(self, transform, A, dimension=None, **kw) -> Future:
        """Sparse sketch endpoint: ``A`` a SparseMatrix or scipy sparse
        operand; resolves to ``transform.apply(A.todense(), dimension)``.
        An operand at or above ``SKYLARK_SPARSE_MIN_DENSITY`` goes
        densified through the dense endpoint (counted as ``densified``)."""
        A = as_sparse(A)
        if self._note_sparse_intake(A):
            return self.submit("sketch_apply", transform=transform,
                               A=self._densified(A), dimension=dimension,
                               **kw)
        return self.submit("sparse_sketch_apply", transform=transform, A=A,
                           dimension=dimension, **kw)

    def submit_sparse_solve(self, A, B, transform, method: str = "qr",
                            **kw) -> Future:
        """Sparse sketch-and-solve: a CSR design matrix ``A`` and a dense
        target block ``B``; resolves to what ``solve_l2_sketched(A.
        todense(), B, transform)``'s serve program returns. The densify
        rule of :meth:`submit_sparse`."""
        A = as_sparse(A)
        if self._note_sparse_intake(A):
            return self.submit("solve_l2_sketched", A=self._densified(A),
                               B=B, transform=transform, method=method,
                               **kw)
        return self.submit("sparse_solve_l2_sketched", A=A, B=B,
                           transform=transform, method=method, **kw)

    def submit_krr_predict(self, kernel, X_new, X_train, coef,
                           **kw) -> Future:
        """KRR prediction endpoint: resolves to ``kernel.gram(X_new,
        X_train) @ coef``. The model (X_train, coef) keys the bucket by
        the identity of the caller's objects and is uploaded once."""
        return self.submit("krr_predict", kernel=kernel, X_new=X_new,
                           X_train=X_train, coef=coef, **kw)

    def submit_graph_ase(self, A, k: int, *, seed: int = 0,
                         iters: int = 2, **kw) -> Future:
        """Adjacency spectral embedding endpoint: ``A`` a Graph, a
        SparseMatrix, scipy sparse or a dense square adjacency; resolves
        to the (n, k) embedding of ``ml.graph.graph_ase_serve`` with the
        same seed."""
        return self.submit("graph_ase", A=A, k=k, seed=seed, iters=iters,
                           **kw)

    def submit_graph_ppr(self, A, s, *, alpha: float = 0.85,
                         iters: int = 16, **kw) -> Future:
        """Personalized PageRank endpoint: ``s`` the (n,) personalization
        vector in adjacency row order; resolves to the (n,) vector of
        ``ml.graph.graph_ppr_serve``."""
        return self.submit("graph_ppr", A=A, s=s, alpha=alpha, iters=iters,
                           **kw)

    def submit_condest(self, A, *, steps: int = 8, seed: int = 0,
                       **kw) -> Future:
        """Condition estimation endpoint: fixed-step Golub–Kahan; resolves
        to the (3,) tensor (cond, sigma_max, sigma_min) of
        ``nla.condest.condest_serve``."""
        return self.submit("condest", A=A, steps=steps, seed=seed, **kw)

    def submit_lowrank(self, transform_s, transform_t, A, k: int,
                       **kw) -> Future:
        """Dominant-subspace endpoint: the two-sketch basis from a matched
        dense transform pair; resolves to the (m, k) basis of
        ``nla.lowrank.lowrank_serve``."""
        return self.submit("lowrank", transform_s=transform_s,
                           transform_t=transform_t, A=A, k=k, **kw)

    def submit_compressed_matmul(self, A, B, transform=None, *,
                                 s_dim: Optional[int] = None,
                                 seed: int = 0, **kw) -> Future:
        """Compressed approximate matmul: estimate ``A @ B`` as (A·Sᵀ)(S·B)
        with one S; resolves to (estimate, bound), the (m, p) estimate and
        the expected-error scale ‖A‖_F·‖B‖_F·√(2/s). ``A`` may be dense or
        CSR. Pass a CWT or FJLT(``wht``) transform, or let ``s_dim`` and
        ``seed`` build one (:func:`default_cmm_transform`)."""
        if transform is None:
            transform = default_cmm_transform(A, s_dim=s_dim, seed=seed)
        return self.submit("compressed_matmul", transform=transform, A=A,
                           B=B, **kw)

    def submit_rlsc_predict(self, kernel, X_new, X_train, coef,
                            coding=None, **kw) -> Future:
        """RLSC classification endpoint: argmax over the one-vs-all KRR
        scores; resolves to int32 class indices, or to a host array of
        labels when ``coding`` is given."""
        return self.submit("rlsc_predict", kernel=kernel, X_new=X_new,
                           X_train=X_train, coef=coef, coding=coding, **kw)

    # -- per-endpoint packing -----------------------------------------

    def _operand(self, A):
        """A tensor moved to the executor's device; a numpy operand stays
        on the host until its flush stacks it."""
        return A.to(self.device) if isinstance(A, torch.Tensor) else A

    @staticmethod
    def _key_data(transform) -> np.ndarray:
        return np.asarray(transform.allocation.key, dtype=np.uint32)

    def _prep_sketch(self, statics, info, kw):
        transform = kw["transform"]
        A = self._operand(info["A"])
        ctx = {"endpoint": "sketch_apply", "dist": info["dist"],
               "family": info["family"], "s_dim": transform.sketch_dim,
               "rowwise": info["rowwise"], "padded": info["padded"],
               "dtype": statics[5], "primary": "A",
               "stack": {"A": (info["padded"], statics[5])}}
        req = _Request(
            arrays={"kd": self._key_data(transform),
                    "scale": float(getattr(transform, "scale", 1.0)),
                    "A": A},
            true_shapes={"A": tuple(A.shape)},
            meta={"rowwise": info["rowwise"]})
        return statics, ctx, req

    def _prep_fastfood(self, statics, info, kw):
        transform = kw["transform"]
        A = self._operand(info["A"])
        padded = (info["m_pad"], A.shape[1])
        ctx = {"endpoint": "fastfood_features", "fut": info["fut"],
               "family": type(transform).sketch_type,
               "sm_kind": info["sm_kind"], "sm_param": info["sm_param"],
               "n_dim": A.shape[1], "s_dim": transform.sketch_dim,
               "padded": padded, "dtype": statics[6], "primary": "A",
               "stack": {"A": (padded, statics[6])}}
        req = _Request(
            arrays={"kd": self._key_data(transform), "scale": 1.0, "A": A},
            true_shapes={"A": tuple(A.shape)},
            meta={"m": A.shape[0], "squeeze": info["squeeze"]})
        return statics, ctx, req

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

    @classmethod
    def _csr_arrays(cls, A, rows_pad: int, nnz_class: int, dtype: str):
        """(arrays, stack entries) of one request's CSR lanes."""
        d, idx, ptr = cls._pack_csr(A, rows_pad, nnz_class, np.dtype(dtype))
        return ({"data": d, "indices": idx, "indptr": ptr},
                {"data": ((nnz_class,), dtype),
                 "indices": ((nnz_class,), "int32"),
                 "indptr": ((rows_pad + 1,), "int32")})

    def _prep_sparse(self, statics, info, kw):
        transform = kw["transform"]
        A = info["A"]
        arrays, stack = self._csr_arrays(A, info["padded"][0],
                                         info["nnz_class"], info["dtype"])
        ctx = {"endpoint": "sparse_sketch_apply", "dist": info["dist"],
               "family": info["family"], "s_dim": transform.sketch_dim,
               "rowwise": info["rowwise"], "padded": info["padded"],
               "nnz_class": info["nnz_class"], "dtype": info["dtype"],
               "primary": "data", "stack": stack}
        req = _Request(
            arrays={"kd": self._key_data(transform),
                    "scale": float(getattr(transform, "scale", 1.0)),
                    **arrays},
            true_shapes={"data": (A.nnz,)},
            meta={"rowwise": info["rowwise"], "shape": A.shape})
        return statics, ctx, req

    def _prep_solve(self, statics, info, kw):
        transform = kw["transform"]
        A = self._operand(info["A"])
        dtype = statics[6]
        B = self._operand(_cast(info["B"], dtype))
        n_pad = info["n_pad"]
        ctx = {"endpoint": "solve_l2_sketched", "family": info["family"],
               "dist": info["dist"], "s_dim": transform.sketch_dim,
               "method": statics[3], "dtype": dtype, "primary": "A",
               "stack": {"A": ((n_pad, A.shape[1]), dtype),
                         "B": ((n_pad, B.shape[1]), dtype)}}
        req = _Request(
            arrays={"kd": self._key_data(transform),
                    "scale": float(getattr(transform, "scale", 1.0)),
                    "A": A, "B": B},
            true_shapes={"A": tuple(A.shape), "B": tuple(B.shape)},
            meta={"squeeze": info["squeeze"]})
        return statics, ctx, req

    def _prep_sparse_solve(self, statics, info, kw):
        transform = kw["transform"]
        A, dtype, n_pad = info["A"], info["dtype"], info["n_pad"]
        B = self._operand(_cast(info["B"], dtype))
        arrays, stack = self._csr_arrays(A, n_pad, info["nnz_class"], dtype)
        stack["B"] = ((n_pad, B.shape[1]), dtype)
        ctx = {"endpoint": "sparse_solve_l2_sketched",
               "family": info["family"], "dist": info["dist"],
               "s_dim": transform.sketch_dim, "method": statics[3],
               "padded_A": (n_pad, A.width), "nnz_class": info["nnz_class"],
               "dtype": dtype, "primary": "data", "stack": stack}
        req = _Request(
            arrays={"kd": self._key_data(transform),
                    "scale": float(getattr(transform, "scale", 1.0)),
                    "B": B, **arrays},
            true_shapes={"data": (A.nnz,), "B": tuple(B.shape)},
            meta={"squeeze": info["squeeze"]})
        return statics, ctx, req

    def _prep_cmm(self, statics, info, kw):
        _CM_SUBMITS.inc_always()
        with self._stats_lock:
            self._counts["cm_submits"] += 1
        transform, dtype = kw["transform"], info["dtype"]
        A = info["A"]
        B = self._operand(_cast(info["B"], dtype))
        ctx = {"endpoint": "compressed_matmul", "family": info["family"],
               "s_dim": info["s_dim"], "sparse": info["sparse"],
               "n": info["n"], "padded_A": info["padded_A"],
               "nnz_class": info["nnz_class"], "dtype": dtype}
        if info["sparse"]:
            arrays, stack = self._csr_arrays(A, info["padded_A"][0],
                                             info["nnz_class"], dtype)
            ctx["primary"], true_shapes = "data", {"data": (A.nnz,)}
        else:
            A = self._operand(_cast(A, dtype))
            arrays, stack = {"A": A}, {"A": (info["padded_A"], dtype)}
            ctx["primary"], true_shapes = "A", {"A": tuple(A.shape)}
        stack["B"] = (info["padded_B"], dtype)
        ctx["stack"] = stack
        req = _Request(
            arrays={"kd": self._key_data(transform), "scale": 1.0,
                    "B": B, **arrays},
            true_shapes={**true_shapes, "B": tuple(B.shape)},
            meta={"m": info["m"], "p": info["p"], "bound": info["bound"]})
        return statics, ctx, req

    def _prep_lowrank(self, statics, info, kw):
        ts, tt = kw["transform_s"], kw["transform_t"]
        A, dtype = self._operand(info["A"]), info["dtype"]
        kd_s, sc_s = _lowrank_key_data(ts, dtype)
        kd_t, sc_t = _lowrank_key_data(tt, dtype)
        ctx = {"endpoint": "lowrank", "family": info["family"],
               "dist": info["dist"], "k": info["k"], "s_dim": ts.sketch_dim,
               "t_dim": tt.sketch_dim, "dtype": dtype, "primary": "A",
               "stack": {"A": (info["padded"], dtype)},
               "host": {"kd_t": ((2,), "uint32"), "scale_t": ((), dtype)}}
        req = _Request(
            arrays={"kd": kd_s, "scale": float(sc_s), "kd_t": kd_t,
                    "scale_t": sc_t, "A": A},
            true_shapes={"A": tuple(A.shape)},
            meta={"m": A.shape[0]})
        return statics, ctx, req

    def _model(self, key: tuple, X_train, coef) -> tuple:
        """(X_train, coef) of a KRR/RLSC bucket on the executor's device:
        uploaded at the bucket's first request, then reused, pinned with
        the caller's objects so that their ids keep naming them."""
        with self._stats_lock:
            m = self._models.get(key)
        if m is None:
            Xt = torch.as_tensor(_as_operand(X_train)).to(self.device)
            C = torch.as_tensor(_as_operand(coef)).to(self.device)
            if C.ndim == 1:
                C = C[:, None]
            with self._stats_lock:
                m = self._models.setdefault(key, ((X_train, coef), Xt, C))
                if m[1] is Xt:
                    self._counts["model_uploads"] += 1
                    self._counts["model_upload_bytes"] += (
                        Xt.numel() * Xt.element_size()
                        + C.numel() * C.element_size())
        return m[1], m[2]

    def _prep_krr(self, statics, info, kw):
        endpoint = statics[0]
        X_train, coef = kw["X_train"], kw["coef"]
        # the model's identity is that of the caller's objects, before any
        # conversion: a server that submits the same model every time
        # keeps landing in one bucket
        key = statics + (id(X_train), id(coef))
        Xq = self._operand(info["X_new"])
        dtype, q_pad = statics[4], info["q_pad"]
        ctx = {"endpoint": endpoint, "kernel": kw["kernel"],
               "model": self._model(key, X_train, coef), "dtype": dtype,
               "primary": "Xq",
               "stack": {"Xq": ((q_pad, Xq.shape[1]), dtype)}}
        meta = {"q": Xq.shape[0], "squeeze_q": info["squeeze_q"]}
        if endpoint == "rlsc_predict":
            coding = kw.get("coding")
            meta["coding"] = list(coding) if coding is not None else None
        else:
            meta["squeeze_t"] = len(np.shape(coef)) == 1
        req = _Request(arrays={"kd": np.zeros(2, np.uint32), "scale": 1.0,
                               "Xq": Xq},
                       true_shapes={"Xq": tuple(Xq.shape)}, meta=meta)
        return key, ctx, req

    def _prep_condest(self, statics, info, kw):
        A, dtype = self._operand(info["A"]), statics[2]
        ctx = {"endpoint": "condest", "steps": info["steps"],
               "dtype": dtype, "primary": "A",
               "stack": {"A": (info["padded"], dtype)}}
        req = _Request(arrays={"kd": _seed_key_data(kw.get("seed", 0)),
                               "scale": 1.0, "A": A},
                       true_shapes={"A": tuple(A.shape)}, meta={})
        return statics, ctx, req

    def _prep_graph(self, statics, info, kw):
        from libskylark_tpu_torch.ml.graph import _in_degree

        endpoint = statics[0]
        S, dtype, padded = info["A"], info["dtype"], info["padded"]
        arrays, stack = self._csr_arrays(S, padded[0], info["nnz_class"],
                                         dtype)
        ctx = {"endpoint": endpoint, "iters": info["iters"],
               "padded": padded, "dtype": dtype, "primary": "data",
               "stack": stack, "host": {"nnz": ((), "int64")}}
        arrays["nnz"] = np.int64(S.nnz)
        if endpoint == "graph_ase":
            ctx["k"] = info["k"]
            kd = _seed_key_data(kw.get("seed", 0))
        else:
            ctx["alpha"] = info["alpha"]
            kd = np.zeros(2, np.uint32)
            s = np.zeros(padded[0], dtype=np.dtype(dtype))
            s[:S.height] = info["s"]
            arrays["s"] = s
            # the column sums, added in CSR order on the host
            arrays["deg"] = _in_degree(torch.from_numpy(arrays["data"]),
                                      torch.from_numpy(arrays["indices"]),
                                      padded[1], S.nnz).numpy()
            stack["s"] = stack["deg"] = ((padded[0],), dtype)
        req = _Request(arrays={"kd": kd, "scale": 1.0, **arrays},
                       true_shapes={"data": (S.nnz,)}, meta={"n": S.height})
        return statics, ctx, req

    # ------------------------------------------------------------------
    # stateful sketch sessions
    # ------------------------------------------------------------------

    @property
    def sessions(self):
        """This executor's
        :class:`~libskylark_tpu_torch.sessions.registry.SessionRegistry`
        (built on first use, under the shared ``SKYLARK_SESSION_DIR`` root,
        which is what makes drain handoff and crash replay possible)."""
        if self._session_registry is None:
            from libskylark_tpu_torch.sessions import SessionRegistry

            with self._lock:
                if self._session_registry is None:
                    self._session_registry = SessionRegistry(
                        name=self.name, device=self.device)
        return self._session_registry

    def open_sketch_session(self, kind: str, *, n: int, s_dim: int,
                            d: int, seed: int = 0,
                            dtype: str = "float32", targets: int = 0,
                            k: int = 0, lam: float = 1e-3,
                            sigma: float = 1.0,
                            ttl_s: Optional[float] = None,
                            session_id: Optional[str] = None) -> str:
        """Open a stateful sketch session and return its id. ``kind`` is
        one of :data:`libskylark_tpu_torch.sessions.KINDS` but ``train``
        (``cwt`` / ``jlt`` / ``srht`` appenders, ``isvd``, ``krr``); the
        other arguments are the
        :class:`~libskylark_tpu_torch.sessions.SessionSpec` fields.
        Refused, like any intake, on a draining or stopped executor."""
        from libskylark_tpu_torch.sessions import SessionSpec

        with self._lock:
            self._refuse_if_unavailable_locked()
        spec = SessionSpec(kind=kind, n=int(n), s_dim=int(s_dim),
                           d=int(d), seed=int(seed), dtype=str(dtype),
                           targets=int(targets), k=int(k),
                           lam=float(lam), sigma=float(sigma),
                           ttl_s=ttl_s)
        return self.sessions.open(spec, session_id=session_id)

    def session_append(self, session_id: str, X, Y=None,
                       seq: Optional[int] = None,
                       deadline=None) -> Future:
        """Fold one row batch into a session; the future resolves to
        ``(seq, rows)`` once the append is journaled (durable) and folded.
        A duplicate sequence number resolves to the current position, a
        no-op. Resolved on the future, never raised here: DRAINING
        refuses; DEGRADED sheds session appends before one-shot traffic;
        an expired ``deadline`` gives :class:`ServeOverloadedError`
        without a journal write; an evicted or unknown session gives
        :class:`~libskylark_tpu_torch.base.errors.SessionEvictedError`."""
        fut: Future = Future()
        try:
            with self._lock:
                self._refuse_if_unavailable_locked()
            if self._is_degraded():
                with self._stats_lock:
                    self._counts["session_shed"] += 1
                raise ServeOverloadedError(
                    "executor DEGRADED: session appends shed before "
                    "interactive traffic")
            dl = Deadline.coerce(deadline)
            if dl is not None and dl.expired:
                with self._stats_lock:
                    self._counts["expired"] += 1
                raise ServeOverloadedError(
                    "session append deadline expired before execution")
            with self._device_scope():
                out = self.sessions.append(session_id, X, Y=Y, seq=seq,
                                           tags=faults.current_tags())
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — resolve, don't leak
            fut.set_exception(e)
            return fut
        fut.set_result(out)
        return fut

    def session_finalize(self, session_id: str) -> Future:
        """The session's result (the maintained sketch, the iSVD factors
        or the KRR coefficients, tensors on the executor's device); its
        artifacts are removed and its id tombstoned. An evicted or
        unknown id resolves to
        :class:`~libskylark_tpu_torch.base.errors.SessionEvictedError`."""
        fut: Future = Future()
        try:
            with self._lock:
                if self._stop:
                    raise RuntimeError("MicrobatchExecutor is shut down")
            with self._device_scope():
                out = self.sessions.finalize(session_id)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
            return fut
        fut.set_result(out)
        return fut

    def _checkpoint_sessions(self) -> None:
        """The drain's hook: checkpoint every live session (journal fsync
        + accumulator snapshot), so a peer resumes from state instead of
        a whole journal replay. Nothing when no session was opened."""
        reg = self._session_registry
        if reg is not None:
            reg.checkpoint_all()

    # ------------------------------------------------------------------
    # training jobs
    # ------------------------------------------------------------------

    @property
    def train_jobs(self):
        """This executor's :class:`~libskylark_tpu_torch.train.jobs.
        TrainManager` (built on first use, like :attr:`sessions`)."""
        if self._train_mgr is None:
            from libskylark_tpu_torch.train.jobs import TrainManager

            with self._lock:
                if self._train_mgr is None:
                    self._train_mgr = TrainManager(self)
        return self._train_mgr

    def _wake_flusher(self) -> None:
        """Nudge the flusher: training work became runnable (a submit, a
        resume or a requeued slice)."""
        with self._lock:
            self._work_cv.notify_all()

    def submit_train_job(self, spec, operands: Optional[dict] = None,
                         *, session_id: Optional[str] = None):
        """Submit a training job: its operands and session open durably
        here, then its slices run as best-effort work in idle scheduler
        slots, on the executor's device. Returns a
        :class:`~libskylark_tpu_torch.train.jobs.TrainJobHandle` whose
        future resolves to the trained model (tensors on the executor's
        device), or raises
        :class:`~libskylark_tpu_torch.base.errors.TrainBudgetExhaustedError`
        with the exact progress when the iteration or deadline budget
        runs out first. Refused on a draining or stopped executor; shed,
        like session appends, on a DEGRADED one."""
        with self._lock:
            self._refuse_if_unavailable_locked()
        if self._is_degraded():
            with self._stats_lock:
                self._counts["train_shed"] += 1
            raise ServeOverloadedError(
                "executor DEGRADED: train submits shed before "
                "interactive traffic")
        return self.train_jobs.submit(spec, operands=operands,
                                      session_id=session_id)

    def resume_train_job(self, session_id: str):
        """Adopt a training job from its on-disk session (a drain's
        handoff or a crash's replay) and run its remaining slices here.
        The availability gates of a submit apply."""
        with self._lock:
            self._refuse_if_unavailable_locked()
        return self.train_jobs.resume(session_id)

    def train_job_status(self, session_id: str) -> dict:
        """Progress of a job live on this executor (raises
        :class:`~libskylark_tpu_torch.base.errors.SessionEvictedError`
        when it is not)."""
        mgr = self._train_mgr
        if mgr is None:
            raise errors.SessionEvictedError(
                f"train job {session_id!r} is not live on this "
                "replica (no jobs were ever submitted here)")
        return mgr.status(session_id)

    # ------------------------------------------------------------------
    # distributed sketches
    # ------------------------------------------------------------------

    def _submit_dist(self, endpoint: str, plan, source, *,
                     tenant=None, qos_class=None, min_coverage=None,
                     deadline=None, timeout=None, request_id=None,
                     pool=None, replicas=None, coordinator=None,
                     pipeline=None, _digest=None, solve=None,
                     digest_extra=()) -> Future:
        """The dist endpoints' common path: QoS admission, the result
        cache (a dist result is a function of the source's digest and the
        plan), then a :class:`~libskylark_tpu_torch.dist.serve.
        DistServeJob` on a thread of its own under a ``serve.submit``
        span, whose request id parents every ``dist.shard_task`` span."""
        from libskylark_tpu_torch.dist import serve as _dserve
        from libskylark_tpu_torch.dist.coordinator import (
            DistSketchCoordinator)

        plan.validate()
        if source.n < plan.n:
            raise errors.InvalidParametersError(
                f"source holds {source.n} rows < plan.n={plan.n}")
        tenant, qos_class = self._admit(endpoint, tenant, qos_class)
        with self._stats_lock:
            self._counts["dist_jobs"] += 1
        # the effective gate is part of the request's identity: a caller
        # gating at 0.9 and one gating at 1.0 must not share a cache or
        # single-flight key
        gate = (_dserve.class_min_coverage(qos_class)
                if min_coverage is None else float(min_coverage))
        flight = None
        cache_key = None
        if self._cache is not None and not self._is_degraded():
            cache_key = _digest or _dserve.dist_request_digest(
                endpoint, plan, source,
                extra=(*tuple(digest_extra), ("gate", gate)))
            pinned = self._residency.result(cache_key)
            if pinned is not None:
                self._cache.note_hit(qos_class, pinned)
                return self._bypass_future(qos_class, pinned)
            hit = self._cache.lookup(cache_key, qos_class)
            if hit is not _rcache.MISS:
                return self._bypass_future(qos_class, hit)
            follower = self._cache.join_flight(cache_key, qos_class)
            if follower is not None:
                with self._lock:
                    self._sched.note_bypass(qos_class)
                return follower
        rid = request_id
        if rid is None and _telemetry.enabled():
            rid = _trace.new_request_id()
        fut: Future = Future()
        with _trace.span("serve.submit", attrs={"endpoint": endpoint},
                         request_id=rid) as sp:
            co = coordinator
            if co is None and (pool is not None or replicas is not None):
                co = DistSketchCoordinator(pool=pool, replicas=replicas,
                                           device=self.device)
            if co is None:
                with self._lock:
                    if self._dist_local_co is None:
                        self._dist_local_co = DistSketchCoordinator(
                            device=self.device)
                    co = self._dist_local_co
            job = _dserve.DistServeJob(
                plan, source, coordinator=co, qos_class=qos_class,
                tenant=tenant, registry=self._tenants,
                min_coverage=min_coverage,
                deadline=deadline if deadline is not None else timeout,
                pipeline=pipeline, request_id=rid,
                parent_ctx=sp.context() if sp is not None else None)

            def _settle(j, exc):
                with self._stats_lock:
                    self._counts["dist_completed" if exc is None
                                 else "dist_failed"] += 1
                    if j.stats.get("early_resolved"):
                        self._counts["dist_early_resolves"] += 1
                    self._dist_by_replica.update(
                        j.stats.get("by_replica", {}))

            # with a flight, the job resolves an inner future, and the
            # caller's resolves only once the flight has settled: an
            # identical request made after the result is a cache hit
            inner = fut
            if cache_key is not None:
                flight = self._cache.lead_flight(cache_key, qos_class,
                                                 fut)
                inner = Future()
                inner.add_done_callback(
                    lambda f, _fl=flight: self._settle_dist(_fl, f, fut))
            try:
                _dserve.run_job_into(job, inner, solve=solve,
                                     on_done=_settle)
            except BaseException as e:
                if flight is not None:
                    self._cache.abort_flight(flight, e)
                raise
        return fut

    def _settle_dist(self, flight, inner: Future, fut: Future) -> None:
        """Settle a dist job's flight, then resolve the caller's future
        with the job's outcome. A degraded result reflects which shards
        failed this time, not the content: it goes to the flight's
        followers but is never cached."""
        exc = inner.exception()
        insert = exc is None and not self._is_degraded()
        if insert:
            v = inner.result()
            insert = not (v.get("degraded") if isinstance(v, dict)
                          else getattr(v, "degraded", False))
        self._cache.settle_flight(flight, inner, insert=insert)
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(inner.result())

    def submit_dist_sketch(self, plan, source, **kw) -> Future:
        """Pipelined distributed sketch: the shard tasks of ``plan`` go to
        the coordinator's replicas (``pool=`` / ``replicas=`` /
        ``coordinator=``; with none, a private thread pool computes them
        on the executor's device) and merge as they land. Resolves to the
        :class:`~libskylark_tpu_torch.dist.plan.DistSketchResult`, at full
        coverage the bits of :func:`~libskylark_tpu_torch.dist.plan.
        sketch_local`. Per-class ``min_coverage`` gates apply: an
        interactive request may resolve early with a quantified
        :class:`~libskylark_tpu_torch.dist.plan.DegradedSketchResult`."""
        return self._submit_dist("dist_sketch", plan, source, **kw)

    def submit_dist_lstsq(self, source, *, s_dim: int, seed: int = 0,
                          kind: str = "cwt", shard_rows: int = 0,
                          **kw) -> Future:
        """Distributed sketch-and-solve least squares
        (:func:`~libskylark_tpu_torch.dist.algorithms.sketched_lstsq` as
        an endpoint): the joint ``[X | Y]`` sketch is merged from the
        shards, and only the ``s_dim`` system is solved here. Resolves to
        ``{"coef", "coverage", "missing", "degraded"}``."""
        from libskylark_tpu_torch.dist import serve as _dserve
        from libskylark_tpu_torch.dist.algorithms import lstsq_plan

        plan = lstsq_plan(source, s_dim=s_dim, seed=seed, kind=kind,
                          shard_rows=shard_rows)
        return self._submit_dist("dist_lstsq", plan, source,
                                 solve=_dserve.solve_lstsq, **kw)

    def submit_dist_svd(self, source, rank: int, *, s_dim=None,
                        seed: int = 0, kind: str = "jlt",
                        shard_rows: int = 0, **kw) -> Future:
        """Distributed randomized SVD
        (:func:`~libskylark_tpu_torch.dist.algorithms.randomized_svd` as
        an endpoint): resolves to ``{"singular_values", "Vt",
        "coverage", "missing", "degraded"}``."""
        from libskylark_tpu_torch.dist import serve as _dserve
        from libskylark_tpu_torch.dist.algorithms import svd_plan

        plan = svd_plan(source, rank, s_dim=s_dim, seed=seed,
                        kind=kind, shard_rows=shard_rows)
        return self._submit_dist(
            "dist_svd", plan, source,
            solve=lambda r: _dserve.solve_svd(r, rank),
            digest_extra=(("rank", int(rank)),), **kw)

    # ------------------------------------------------------------------
    # queueing and the flusher
    # ------------------------------------------------------------------

    def _route_locked(self, statics, ctx, capacity: int = 0) -> tuple:
        """(route, decline reason or None, source) of a bucket's flush at
        ``capacity``, from its statics alone, before anything of it is
        launched: the library route for the endpoints with no sketch, the
        plain programs on a CPU executor; else the precedence of the
        module docstring, a ``cuda`` choice then held to :func:`qualify`
        (decided once per bucket)."""
        if ctx["endpoint"] in _LIBRARY_ENDPOINTS:
            r = ("library", None, "endpoint")
        elif self.device.type != "cuda":
            r = ("plain", None, "device")
        else:
            choice, source = self._choice_locked(statics, ctx, capacity)
            if choice == "cuda":
                q = self._qualified.get(statics)
                if q is None:
                    q = self._qualified[statics] = qualify(ctx)
                r = ("cuda", None, source) if q[0] else ("plain", q[1],
                                                          source)
            else:
                r = ("plain", None, source)
        self._routes[statics] = r
        return r

    def _choice_locked(self, statics, ctx, capacity: int) -> tuple:
        """(route, source) the precedence names: ``kernel=``, an env pin,
        a restored pack decision, the plan cache, else the kernel. The
        last two are memoized per plan-cache fingerprint, and a new
        fingerprint drops the memo and the restored decisions (the
        reference's ``_resolve_flush_kernel``)."""
        if self.kernel is not None:
            return self.kernel, "arg"
        pin = _env_route(statics)
        if pin is not None:
            return pin, "env"
        self._sync_plan_fp_locked()
        at = (tuple(statics), int(capacity))
        restored = self._restored.get(at)
        if restored is not None:
            return restored, "pack"
        from libskylark_tpu_torch.sketch import params as sketch_params

        if not sketch_params.get_use_plan_cache():
            return "cuda", "qualify"
        got = self._plan_memo.get(at)
        if got is None:
            got = self._plan_memo[at] = self._plan_choice(statics, ctx,
                                                          capacity)
        return got

    def _sync_plan_fp_locked(self) -> None:
        from libskylark_tpu_torch.tune import plan_fingerprint

        fp = plan_fingerprint()
        if fp != self._plan_fp:
            self._plan_memo.clear()
            self._restored.clear()
            self._plan_fp = fp

    @staticmethod
    def _kernel_workload(statics, ctx, capacity: int):
        """The tune serve-bucket workload of a flush — (endpoint /
        orientation, family, dtype, padded lane class, capacity class) —
        or None when the endpoint has no kernel decision."""
        from libskylark_tpu_torch import tune

        endpoint = statics[0]
        if endpoint == "sketch_apply":
            return tune.serve_workload(
                "sketch_apply", ctx["family"], ctx["dtype"], ctx["padded"],
                ctx["s_dim"], capacity, rowwise=ctx["rowwise"])
        if endpoint == "fastfood_features":
            return tune.serve_workload(
                "fastfood_features", ctx["family"], ctx["dtype"],
                ctx["padded"], ctx["s_dim"], capacity)
        if endpoint == "sparse_sketch_apply":
            return tune.serve_workload(
                "sparse_sketch_apply", ctx["family"], ctx["dtype"],
                ctx["padded"], ctx["s_dim"], capacity,
                rowwise=ctx["rowwise"], nnz=ctx["nnz_class"])
        return None

    def _plan_choice(self, statics, ctx, capacity: int) -> tuple:
        """(route, source) from the plan cache: a ``pallas`` plan is the
        kernel, an ``xla`` plan the plain programs (source ``plan``);
        without a plan the kernel, source ``qualify``."""
        from libskylark_tpu_torch import tune

        w = self._kernel_workload(statics, ctx, capacity)
        plan = tune.plan_for(w) if w is not None else None
        if plan is not None and plan.backend in _PLAN_ROUTES:
            return _PLAN_ROUTES[plan.backend], "plan"
        return "cuda", "qualify"

    def restore_kernel_choice(self, statics, capacity: int,
                              token: str) -> bool:
        """Seed one (bucket statics, capacity)'s route with a warmup
        pack's recorded decision (``cuda`` or ``plain``; the reference's
        ``pallas`` and ``xla`` name the same). Returns whether it was
        restored. An explicit pin outranks the pack, so under the
        executor's ``kernel=`` or an environment pin for the bucket
        (``SKYLARK_SERVE_KERNEL``, ``SKYLARK_FWHT_KERNEL``,
        ``SKYLARK_SPARSE_KERNEL``) it declines, as it does with
        ``SKYLARK_USE_PLAN_CACHE`` or ``set_use_plan_cache`` off (a
        pack's decisions stand for the plan cache's) and for a token it
        does not know."""
        statics = tuple(statics)
        if self.kernel is not None or _env_route(statics) is not None:
            return False
        from libskylark_tpu_torch.sketch import params as sketch_params

        if not (_env.USE_PLAN_CACHE.get()
                and sketch_params.get_use_plan_cache()):
            return False
        route = _BACKEND_ROUTES.get(token)
        if route is None:
            return False
        with self._lock:
            self._sync_plan_fp_locked()
            self._restored[(statics, int(capacity))] = route
        return True

    def load_warmup_pack(self, pack_dir: str, *,
                         strict: bool = False) -> dict:
        """Boot this executor from a warmup pack before traffic: capture
        every packed (bucket, capacity) and restore its route
        (:func:`libskylark_tpu_torch.engine.warmup.load_pack`). Returns
        the loader's report."""
        from libskylark_tpu_torch.engine import warmup as _warmup

        return _warmup.load_pack(pack_dir, executors=(self,), strict=strict)

    def _flush_fn_locked(self, statics, ctx, route) -> tuple:
        """(the bucket's ``CompiledFn`` for ``route``, None), or (None, why
        the flush runs eagerly)."""
        endpoint = ctx["endpoint"]
        if endpoint not in _CAPTURED_ENDPOINTS:
            return None, "not captured yet (ROADMAP B-ii 10)"
        if endpoint == "fastfood_features" and ctx["sm_kind"] == "matern":
            return None, "FastMaternRFT: the Gamma loop reads the host"
        if self.device.type == "cuda" and route != "cuda":
            return None, "plain route: its streams are made on the host"
        key = (tuple(statics), route)
        fn = self._compiled.get(key)
        if fn is None:
            fn = self._compiled[key] = _build_flush_fn(statics, ctx, route)
        return fn, None

    def _refuse_if_unavailable_locked(self) -> None:
        if self._draining and not self._stop:
            with self._stats_lock:
                self._counts["shed"] += 1
            raise ServeOverloadedError(
                f"executor {self.name!r} is draining: request refused")
        if self._stop:
            raise ServeOverloadedError(f"executor {self.name!r} is stopped")

    def _class_shed_bound(self, cls: str) -> int:
        """The DEGRADED shed bound (queued plus in-flight requests) of one
        class: ``max_queue`` times the class's shed fraction, scaled by
        ``shed_fraction`` over the standard class's declared default (the
        reference's rule: the constructor's knob moves all three bounds,
        each ``SKYLARK_QOS_SHED_*`` its own)."""
        scale = self.shed_fraction / float(_env.QOS_SHED_STANDARD.default)
        return max(1, int(self.max_queue * _qtenants.shed_fraction(cls)
                          * scale))

    def _note_shed(self, req: _Request) -> None:
        with self._stats_lock:
            self._counts["shed"] += 1
            self._qos_counts[("shed", req.qos_class, req.tenant)] += 1
        _QOS_SHED.inc(**{"class": req.qos_class, "tenant": req.tenant})

    def _enqueue(self, key, ctx, req, timeout) -> None:
        deadline = time.monotonic() + (timeout or 0)
        degraded = self._is_degraded()
        cls = req.qos_class
        shed_bound = self._class_shed_bound(cls)
        pressure = _qtenants.PRESSURE_FRACTIONS.get(cls, 1.0)
        with self._lock:
            self._refuse_if_unavailable_locked()
            exposure = self._pending + self._inflight
            if degraded and exposure >= shed_bound:
                # DEGRADED shed, class-ordered: best_effort's bound is the
                # smallest, interactive's the largest
                self._note_shed(req)
                raise ServeOverloadedError(
                    f"load shed: executor DEGRADED and exposure at "
                    f"{exposure} >= {cls} shed bound {shed_bound}")
            if pressure < 1.0 and exposure >= max(
                    1, int(self.max_queue * pressure)):
                # queue-pressure shed: best_effort stops at its fraction of
                # the bound even on a healthy executor
                self._note_shed(req)
                raise ServeOverloadedError(
                    f"load shed: {cls} exposure at {exposure} >= "
                    f"pressure bound {int(self.max_queue * pressure)}")
            while self._pending >= self.max_queue:
                wait = deadline - time.monotonic() if timeout else None
                if (timeout and wait <= 0) or not self._space_cv.wait(wait):
                    with self._stats_lock:
                        self._counts["rejected"] += 1
                    raise ServeOverloadedError(
                        f"serve queue at bound ({self.max_queue}) for "
                        f"{timeout}s")
                self._refuse_if_unavailable_locked()
            qkey = tuple(key) + (cls,)
            b = self._buckets.get(qkey)
            if b is None:
                self._route_locked(key, ctx, self.max_batch)
                b = self._buckets[qkey] = _Bucket(key=qkey, statics=key,
                                                  ctx=ctx, qos_class=cls)
            b.reqs.append(req)
            self._pending += 1
            self._class_pending[cls] += 1
            _QOS_QUEUE_DEPTH.set(float(self._class_pending[cls]),
                                 **{"class": cls, "replica": self.name})
            with self._stats_lock:
                self._counts["submitted"] += 1
                self._counts["queued_peak"] = max(
                    self._counts["queued_peak"], self._pending)
                self._qos_counts[("admitted", cls, req.tenant)] += 1
            _QOS_ADMITTED.inc(**{"class": cls, "tenant": req.tenant})
            # a full cohort goes straight to a free worker (under the
            # lock, so a racing shutdown's stop items queue behind it)
            # unless a higher class has pending work: then the flusher's
            # deficit scheduler decides
            higher = any(self._class_pending.get(c, 0) > 0 for c in
                         _qtenants.CLASSES[:_qtenants.CLASSES.index(cls)])
            if len(b.reqs) >= self._bucket_cap_locked(b.statics) \
                    and not higher and self._worker_free_locked():
                work = self._pop_cohort_locked(qkey)
                self._sched.charge(cls, len(work[1]))
                self._workq.put((self, work))
            else:
                self._work_cv.notify_all()

    def _bucket_targets_locked(self, statics: tuple) -> tuple:
        """(linger seconds, cohort cap) of one bucket: the static config
        unless the adaptive controller moved them."""
        t = self._qos_targets.get(statics)
        if t is None:
            return self.linger, self.max_batch
        return float(t[0]), int(t[1])

    def _bucket_cap_locked(self, statics: tuple) -> int:
        t = self._qos_targets.get(statics)
        return self.max_batch if t is None else int(t[1])

    def bucket_targets(self, statics) -> tuple:
        """(linger_s, batch_cap) of one bucket (the controller's read)."""
        with self._lock:
            return self._bucket_targets_locked(tuple(statics))

    def set_bucket_targets(self, statics, *, linger_s=None,
                           batch_cap=None) -> None:
        """Move one bucket's targets (the controller's write):
        ``batch_cap`` clamps to [1, max_batch]; the flusher re-evaluates
        at once."""
        statics = tuple(statics)
        with self._lock:
            cur = list(self._bucket_targets_locked(statics))
            if linger_s is not None:
                cur[0] = max(float(linger_s), 0.0)
            if batch_cap is not None:
                cur[1] = max(1, min(int(batch_cap), self.max_batch))
            self._qos_targets[statics] = cur
            self._work_cv.notify_all()

    def _worker_free_locked(self) -> bool:
        """Whether one of the executor's own workers is free. Cohorts stay
        in their class queues until one is, so that under load the deficit
        scheduler, not the order of a FIFO, decides which class runs next.
        An executor on a shared ``dispatch_queue`` cannot see its workers
        and hands every ready cohort over."""
        return not self._workers or self._inflight < len(self._workers)

    def _pop_cohort_locked(self, key) -> Optional[tuple]:
        b = self._buckets.get(key)
        if b is None or not b.reqs:
            return None
        cap = self._bucket_cap_locked(b.statics)
        cohort, b.reqs = b.reqs[:cap], b.reqs[cap:]
        if not b.reqs:
            del self._buckets[key]
        self._pending -= len(cohort)
        self._class_pending[b.qos_class] -= len(cohort)
        _QOS_QUEUE_DEPTH.set(float(max(self._class_pending[b.qos_class], 0)),
                             **{"class": b.qos_class, "replica": self.name})
        self._inflight += 1
        self._space_cv.notify_all()
        return b, cohort

    def _cohort_done_locked(self) -> None:
        self._inflight -= 1
        self._work_cv.notify_all()
        if self._pending == 0 and self._inflight == 0:
            self._idle_cv.notify_all()

    def _flusher_loop(self) -> None:
        """Dispatch ready cohorts (full, lingered out, or flushed by drain
        or stop) as workers free up: the oldest ready bucket of each class
        is a candidate, and the deficit scheduler picks the class."""
        while True:
            work = None
            with self._lock:
                if self._stop and not self._buckets:
                    break
                now = time.monotonic()
                wait = None
                ready: dict = {}          # class -> its oldest ready key
                for key, b in self._buckets.items():
                    linger, cap = self._bucket_targets_locked(b.statics)
                    if (len(b.reqs) >= cap or self._stop or self._draining
                            or now - b.oldest >= linger):
                        prev = ready.get(b.qos_class)
                        if prev is None or b.oldest < \
                                self._buckets[prev].oldest:
                            ready[b.qos_class] = key
                    else:
                        w = b.oldest + linger - now
                        wait = w if wait is None else min(wait, w)
                # a training slice is best-effort work, offered only when
                # no higher class has pending requests: idle slots feed
                # training, and one interactive request displaces it at
                # the next slice boundary
                train_mgr = self._train_mgr
                if (train_mgr is not None and not self._stop
                        and not self._draining
                        and train_mgr.has_runnable()):
                    if any(self._class_pending.get(c, 0) > 0
                           for c in _qtenants.CLASSES
                           if c != _qtenants.BEST_EFFORT):
                        train_mgr.note_deferred()
                    elif _qtenants.BEST_EFFORT not in ready:
                        ready[_qtenants.BEST_EFFORT] = _TRAIN_KEY
                    if _TRAIN_KEY not in ready.values():
                        # displaced: poll for the idle window
                        wait = 0.05 if wait is None else min(wait, 0.05)
                if ready and self._worker_free_locked():
                    backlog = {c: self._class_pending.get(c, 0)
                               + (ready[c] is _TRAIN_KEY) for c in ready}

                    def cost(c):
                        if ready[c] is _TRAIN_KEY:
                            return 1
                        b0 = self._buckets[ready[c]]
                        return min(len(b0.reqs),
                                   self._bucket_cap_locked(b0.statics))

                    cls = self._sched.next_class(backlog, cost)
                    if cls is not None and ready[cls] is _TRAIN_KEY:
                        job = train_mgr.claim_next()
                        if job is not None:
                            self._inflight += 1
                            self._sched.charge(cls, 1)
                            work = (_TRAIN_KEY, job)
                    elif cls is not None:
                        work = self._pop_cohort_locked(ready[cls])
                        if work is not None:
                            self._sched.charge(cls, len(work[1]))
                if work is None:
                    if not self._stop or ready:
                        self._work_cv.wait(timeout=wait)
                    continue
                self._workq.put((self, work))
        for _ in self._workers:
            self._workq.put(None)

    def _dispatch_cohort(self, b: _Bucket, cohort: list) -> None:
        """Run one cohort through the isolating executor, on the
        executor's device; an exception that escapes it reaches every
        unresolved future. Each request's queue wait, submit to the start
        of its flush, is recorded by class. A training slice (``b`` the
        train entry, ``cohort`` the claimed job) goes to the manager,
        which resolves or requeues the job whatever happens."""
        if b is _TRAIN_KEY:
            try:
                mgr = self._train_mgr
                if mgr is not None:
                    with self._device_scope():
                        mgr.run_slice(cohort)
            finally:
                with self._lock:
                    self._cohort_done_locked()
            return
        now = time.monotonic()
        with self._stats_lock:
            waits = self._wait_by_class[b.qos_class]
            for r in cohort:
                waits.append(now - r.t_submit)
        try:
            with self._device_scope():
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
    # deadlines, failure isolation and health
    # ------------------------------------------------------------------

    def _drop_expired(self, cohort: list) -> list:
        """Resolve deadline-expired requests to ServeOverloadedError and
        return the others; runs before every execution attempt, so an
        expired request is never stacked, launched or retried."""
        live, expired = [], 0
        for r in cohort:
            if r.deadline is not None and r.deadline.expired:
                expired += 1
                if not r.future.done():
                    r.future.set_exception(ServeOverloadedError(
                        f"request deadline expired after "
                        f"{time.monotonic() - r.t_submit:.3f}s in queue"))
            else:
                live.append(r)
        if expired:
            with self._stats_lock:
                self._counts["expired"] += expired
        return live

    def _run_cohort(self, b: _Bucket, cohort: list, depth: int = 0) -> None:
        """Execute a cohort; on failure split it in half and execute each
        half, until the failure pins to single requests, which alone get
        the exception (every lane runs the same program at any capacity,
        so the survivors' bits are those of the full flush). Only root
        attempts feed the health window: a bisection's correlated
        failures are one incident."""
        cohort = self._drop_expired(cohort)
        if not cohort:
            return
        span_cm = _trace.span(
            "serve.flush" if depth == 0 else "serve.isolation",
            parent=cohort[0].tctx if depth == 0 else None)
        with span_cm as sp:
            if sp is not None:
                sp.set_attr("endpoint", b.statics[0])
                sp.set_attr("cohort", len(cohort))
                sp.set_attr("depth", depth)
                sp.set_attr("request_ids", [r.request_id for r in cohort
                                            if r.request_id is not None])
            try:
                self._execute(b, cohort)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — isolated below
                if sp is not None:
                    sp.status = "error"
                    sp.error = repr(e)
                with self._stats_lock:
                    self._counts["flush_failures"] += 1
                    if depth == 0:
                        self._health.append(1.0)
                if depth == 0:
                    self._maybe_publish_state()
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
            else:
                if depth == 0:
                    with self._stats_lock:
                        self._health.append(0.0)
                    self._maybe_publish_state()

    def _is_degraded(self) -> bool:
        with self._stats_lock:
            n = len(self._health)
            if n < 4:
                return False
            return sum(self._health) / n >= self.degraded_threshold

    # ------------------------------------------------------------------
    # one flush: stack → program → unpad
    # ------------------------------------------------------------------

    def _stack_cohort(self, ctx: dict, cohort: list, capacity: int) -> tuple:
        """(kd, scale, arrays, h2d bytes by operand) of one flush: keys,
        scales and ``ctx["host"]``'s arrays stacked on the host,
        ``ctx["stack"]``'s operands stacked as tensors on the device. An
        operand whose lanes are all on the host ships as one buffer (its
        bytes counted); otherwise resident lanes are copied on the device
        and each host lane ships alone (its own bytes counted)."""
        kd = bucketing.stack_pad([r.arrays["kd"] for r in cohort], (2,),
                                 capacity, np.uint32)
        scale = bucketing.stack_pad([np.float64(r.arrays["scale"])
                                     for r in cohort], (), capacity,
                                    np.dtype(ctx["dtype"]))
        arrays, h2d = {}, {}
        for name, (shape, dtype) in ctx.get("host", {}).items():
            arrays[name] = bucketing.stack_pad(
                [r.arrays[name] for r in cohort], shape, capacity,
                np.dtype(dtype))
        for name, (shape, dtype) in ctx["stack"].items():
            ops = [r.arrays[name] for r in cohort]
            t = bucketing.stack_pad_tensor(ops, shape, capacity,
                                           getattr(torch, dtype), self.device)
            hosted = [a for a in ops if not isinstance(a, torch.Tensor)
                      or a.device.type == "cpu"]
            if self.device.type != "cuda" or not hosted:
                h2d[name] = 0
            elif len(hosted) == len(ops):
                h2d[name] = t.numel() * t.element_size()
            else:
                h2d[name] = sum(bucketing.result_nbytes(a) for a in hosted)
            arrays[name] = t
        return kd, scale, arrays, h2d

    def _execute(self, b: _Bucket, cohort: list) -> None:
        k = len(cohort)
        capacity = bucketing.capacity_class(k, self.max_batch)
        ctx = b.ctx
        endpoint = ctx["endpoint"]
        # the fault site fires per attempt, with the cohort's tags, before
        # anything is stacked or launched
        faults.check("serve.flush",
                     tags=frozenset().union(*(r.tags for r in cohort)),
                     detail=f"{endpoint} k={k} cap={capacity}")
        with self._lock:
            route, declined, source = self._route_locked(b.statics, ctx,
                                                         capacity)
            flush_fn, eager = self._flush_fn_locked(b.statics, ctx, route)
        kd, scale, arrays, h2d = self._stack_cohort(ctx, cohort, capacity)
        out = run_flush(ctx if flush_fn is None
                        else dict(ctx, flush_fn=flush_fn),
                        route, kd, scale, arrays)
        values = []
        for i, r in enumerate(cohort):
            try:
                values.append((_unpad(endpoint, out, i, r), None))
            except Exception as e:  # noqa: BLE001 — reaches its future
                values.append((None, e))
        # a single-flight leader's followers and the cache get a compact
        # copy, made before the synchronise below covers it
        for r, (v, e) in zip(cohort, values):
            if r.flight is not None and e is None:
                r.flight.frozen = _rcache.freeze_result(v)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        now = time.monotonic()
        done = 0
        for r, (v, e) in zip(cohort, values):
            if e is None:
                r.future.set_result(v)
                done += 1
            elif not r.future.done():
                r.future.set_exception(e)
        primary = ctx["primary"]
        with self._stats_lock:
            self._counts["flushes"] += 1
            self._counts["completed"] += done
            self._counts["failed"] += k - done
            if k > 1:
                self._counts["coalesced"] += k
            if route == "library":
                self._counts["library_flushes"] += 1
            else:
                self._kernel_sel[route] += 1
            if declined:
                self._kernel_dec[declined] += 1
            if route != "library":
                self._kernel_src[source] += 1
            self._capture["captured" if flush_fn is not None
                          else "eager: " + eager] += 1
            if endpoint == "sparse_sketch_apply":
                self._sparse_sel[route] += 1
                _SPARSE_KERNEL_FLUSHES.inc_always(backend=route)
            if endpoint == "sketch_apply" and ctx.get("family") == "SRHT":
                self._fwht_sel[route] += 1
                _FWHT_FLUSHES.inc_always(backend=route)
            self._batch_hist[capacity] += 1
            self._cohort_hist[k] += 1
            pad_total = bucketing.padded_elements(ctx["stack"][primary][0],
                                                  capacity)
            pad_real = bucketing.real_elements(
                [r.true_shapes[primary] for r in cohort])
            self._pad_total += pad_total
            self._pad_real += pad_real
            obs = self._by_bucket.setdefault(b.statics, collections.Counter())
            obs.update(flushes=1, requests=done, capacity=capacity,
                       pad_real=pad_real, pad_total=pad_total,
                       h2d=sum(h2d.values()),
                       **{f"h2d:{n}": v for n, v in h2d.items()})
            # the adaptive controller's observations: latencies, the
            # capacities flushed at, padding and the classes carried
            qo = self._bucket_obs.get(b.statics)
            if qo is None:
                qo = self._bucket_obs[b.statics] = {
                    "lat": collections.deque(maxlen=512), "caps": set(),
                    "classes": set(), "pad_real": 0, "pad_total": 0, "n": 0}
            qo["caps"].add(int(capacity))
            qo["classes"].add(b.qos_class)
            qo["pad_total"] += pad_total
            qo["pad_real"] += pad_real
            qo["n"] += k
            for r in cohort:
                lat = now - r.t_submit
                self._latency.append(lat)
                self._latency_by_class[r.qos_class].append(lat)
                qo["lat"].append(lat)
        for r in cohort:
            _QOS_LATENCY.observe(now - r.t_submit, **{"class": r.qos_class})

    # ------------------------------------------------------------------
    # state, stats, drain and shutdown
    # ------------------------------------------------------------------

    @property
    def state(self) -> str:
        """``SERVING`` | ``DEGRADED`` | ``DRAINING`` | ``STOPPED``.
        DEGRADED: the root-flush failure ratio over the last
        ``failure_window`` attempts is at ``degraded_threshold`` or past
        it; successful flushes bring it back to SERVING."""
        with self._lock:
            if self._stop:
                return STOPPED
            if self._draining:
                return DRAINING
        return DEGRADED if self._is_degraded() else SERVING

    def queue_depth(self) -> int:
        """Pending requests plus in-flight cohorts: the live load
        signal a router reads (the reference's sum)."""
        with self._lock:
            return self._pending + self._inflight

    def latency_quantile(self, q: float = 0.99) -> Optional[float]:
        """One quantile of the recent request latencies, in seconds (None
        before any completion); cheaper than :meth:`stats`."""
        with self._stats_lock:
            lat = sorted(self._latency)
        return _percentile(lat, q)

    def qos_bucket_obs(self) -> dict:
        """Per-bucket controller observations: ``statics -> {p99,
        padding_waste, caps, classes, n}``."""
        with self._stats_lock:
            snap = {statics: (sorted(o["lat"]), frozenset(o["caps"]),
                              frozenset(o["classes"]), o["pad_real"],
                              o["pad_total"], o["n"])
                    for statics, o in self._bucket_obs.items()}
        return {
            statics: {
                "p99": _percentile(lat, 0.99),
                "padding_waste": (round(1.0 - real / total, 4)
                                  if total else None),
                "caps": caps, "classes": classes, "n": n}
            for statics, (lat, caps, classes, real, total, n)
            in snap.items()}

    def qos_reset_bucket_obs(self, statics) -> None:
        """Drop one bucket's latency window and padding counts (its warm
        capacities and classes stay): the controller scores the evidence
        after its step, not the burst that caused it."""
        with self._stats_lock:
            o = self._bucket_obs.get(tuple(statics))
            if o is not None:
                o["lat"].clear()
                o["pad_real"] = 0
                o["pad_total"] = 0

    def _qos_stats_block(self) -> dict:
        """The ``stats()["qos"]`` block: per-class admission, shed and
        rate-limit counts, queue depths, latency and queue-wait
        percentiles, per-tenant counts, the scheduler's state, the live
        targets and the controller's counts."""
        with self._stats_lock:
            qc = dict(self._qos_counts)
            lat_cls = {c: sorted(d) for c, d in
                       self._latency_by_class.items()}
            wait_cls = {c: list(d) for c, d in self._wait_by_class.items()}
        with self._lock:
            depth = {c: int(self._class_pending.get(c, 0))
                     for c in _qtenants.CLASSES}
            targets = {str(statics[0]): {"linger_s": round(float(t[0]), 6),
                                         "batch": int(t[1])}
                       for statics, t in self._qos_targets.items()}
            sched = self._sched.stats()
        by_class = {c: {"admitted": 0, "shed": 0, "rate_limited": 0,
                        "queue_depth": depth[c]} for c in _qtenants.CLASSES}
        by_tenant: dict = {}
        for (kind, cls, tenant), n in qc.items():
            by_class[cls][kind] += n
            if tenant:
                t = by_tenant.setdefault(tenant, {"admitted": 0, "shed": 0,
                                                  "rate_limited": 0})
                t[kind] += n
        for c, lat in lat_cls.items():
            by_class[c]["latency_s"] = {"p50": _percentile(lat, 0.50),
                                        "p99": _percentile(lat, 0.99),
                                        "n": len(lat)}
            w = wait_cls[c]
            by_class[c]["queue_wait_s"] = {
                "mean": sum(w) / len(w) if w else None,
                "p99": _percentile(sorted(w), 0.99), "n": len(w)}
        return {
            "by_class": by_class,
            "by_tenant": dict(sorted(by_tenant.items())),
            "scheduler": sched,
            "targets": targets,
            "controller": (self._controller.stats()
                           if self._controller is not None else None),
        }

    def _maybe_publish_state(self) -> None:
        """Publish a state transition, if one happened, through
        :mod:`libskylark_tpu_torch.resilience.health`. The state is read
        under the publish lock, so racing workers publish transitions in
        order and never one twice."""
        with self._pub_lock:
            new = self.state
            old = self._published_state
            if new == old:
                return
            self._published_state = new
            _health.publish(self, old, new)

    def stats(self) -> dict:
        """Snapshot of the serving counters, under the reference's names
        where the reference has them."""
        with self._stats_lock:
            lat = sorted(self._latency)
            c = dict(self._counts)
            ksel, kdec = dict(self._kernel_sel), dict(self._kernel_dec)
            ksrc, capture = dict(self._kernel_src), dict(self._capture)
            sp_sel = dict(self._sparse_sel)
            sp_nnz = dict(sorted(self._sparse_nnz_hist.items()))
            fw_sel = dict(self._fwht_sel)
            batch_hist = dict(sorted(self._batch_hist.items()))
            cohort_hist = dict(sorted(self._cohort_hist.items()))
            pad_real, pad_total = self._pad_real, self._pad_total
            by_bucket = {repr(k): {
                "route": self._routes.get(k, ("plain", None))[0],
                "flushes": v["flushes"], "completed": v["requests"],
                "mean_capacity": v["capacity"] / v["flushes"],
                "padding_waste_ratio": round(
                    1.0 - v["pad_real"] / v["pad_total"], 4),
                "h2d_bytes_per_flush": v["h2d"] / v["flushes"],
                "h2d_bytes_by_operand": {
                    n[4:]: int(x) for n, x in sorted(v.items())
                    if n.startswith("h2d:")}}
                for k, v in self._by_bucket.items()}
            models = len(self._models)
            dist_by = dict(self._dist_by_replica)
        with self._lock:
            queued = self._pending
        return {
            "state": self.state,
            "device": str(self.device),
            "submitted": c.get("submitted", 0),
            "completed": c.get("completed", 0),
            "failed": c.get("failed", 0),
            "rejected": c.get("rejected", 0),
            "shed": c.get("shed", 0),
            "session_shed": c.get("session_shed", 0),
            "expired": c.get("expired", 0),
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
                "by_source": {k: {"flushes": int(v)}
                              for k, v in sorted(ksrc.items())},
            },
            "capture": {
                "captured_flushes": int(capture.get("captured", 0)),
                "eager_flushes": {k[len("eager: "):]: int(v)
                                  for k, v in sorted(capture.items())
                                  if k != "captured"},
            },
            "library": {"flushes": c.get("library_flushes", 0)},
            "models": {"resident": models,
                       "uploads": c.get("model_uploads", 0),
                       "upload_bytes": c.get("model_upload_bytes", 0)},
            "sparse": {
                "submits": c.get("sparse_submits", 0),
                "densified": c.get("sparse_densified", 0),
                "by_backend": {k: {"kernel_flushes": int(v)}
                               for k, v in sorted(sp_sel.items())},
                "nnz_class_hist": sp_nnz,
            },
            "fwht": {
                "by_backend": {k: {"flushes": int(v)}
                               for k, v in sorted(fw_sel.items())},
                "cm_submits": c.get("cm_submits", 0),
            },
            # the dist endpoints' jobs and their shard dispatches by
            # replica
            "dist": {
                "jobs": c.get("dist_jobs", 0),
                "completed": c.get("dist_completed", 0),
                "failed": c.get("dist_failed", 0),
                "early_resolves": c.get("dist_early_resolves", 0),
                "by_replica": {k: {"shard_tasks": int(v)}
                               for k, v in sorted(dist_by.items())},
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
            "qos": self._qos_stats_block(),
            # None until the first session verb; the cross-registry rollup
            # is the "sessions" telemetry collector
            "sessions": (self._session_registry.stats()
                         if self._session_registry is not None else None),
            # None until the first train verb (the cross-executor rollup
            # is the "train" telemetry collector); ``shed`` counts the
            # submits a DEGRADED executor refused before the manager
            "train": (dict(self._train_mgr.stats(),
                           shed=c.get("train_shed", 0))
                      if self._train_mgr is not None else None),
            "cache": self._cache_stats_block(),
        }

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop intake (new submits raise :class:`ServeOverloadedError`),
        publish DRAINING, flush every queued cohort, wait for every
        in-flight future (a running train slice included; no new slice
        starts), checkpoint every live session (train jobs included),
        then stop the threads, releasing the train jobs. Returns whether
        the flushes finished inside ``timeout``; the executor stops either
        way. What the preemption handler calls on SIGTERM."""
        dl = Deadline.after(timeout)
        with self._lock:
            if self._stop:
                return True
            self._draining = True
            self._work_cv.notify_all()
            self._space_cv.notify_all()
        self._maybe_publish_state()
        with self._lock:
            drained = True
            while self._pending or self._inflight or self._buckets:
                rem = dl.remaining()
                if rem <= 0:
                    drained = False
                    break
                self._idle_cv.wait(timeout=min(rem, 0.1))
        # live sessions are checkpointed here, before the executor stops,
        # even after a drain timeout: the journal holds every accepted
        # append, the checkpoint bounds the peer's replay
        try:
            self._checkpoint_sessions()
        except Exception as e:  # noqa: BLE001 — the drain must finish
            warnings.warn(f"session checkpoint during drain failed: {e}",
                          RuntimeWarning, stacklevel=2)
        self.shutdown(wait=drained)
        return drained

    def shutdown(self, wait: bool = True) -> None:
        """Stop intake, flush everything pending, join the threads, and
        publish STOPPED."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
            self._work_cv.notify_all()
            self._space_cv.notify_all()
        self._maybe_publish_state()
        if self._controller is not None:
            self._controller.close()
        if wait:
            self._flusher.join()
            for t in self._workers:
                t.join()
        # live training jobs are released, not failed: their sessions stay
        # on disk (a drain checkpointed them) and each unresolved job
        # future breaks with CommunicationError, for a peer to resume
        mgr = self._train_mgr
        if mgr is not None:
            try:
                mgr.release_jobs(
                    f"executor {self.name!r} stopped mid-job; the "
                    "session remains on disk for a peer to resume")
            except Exception:  # noqa: BLE001 — shutdown must finish
                pass
        # sync the session journals without deleting anything: a peer, or
        # a restart, resumes them from disk
        reg = self._session_registry
        if reg is not None:
            try:
                reg.close()
            except Exception:  # noqa: BLE001 — shutdown must finish
                pass

    def __enter__(self) -> "MicrobatchExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


_EXECUTORS: "weakref.WeakSet[MicrobatchExecutor]" = weakref.WeakSet()


def _merge_qos_blocks(blocks) -> dict:
    """Cross-executor merge of ``stats()["qos"]`` blocks: counts and
    queue depths sum, tenants union, served counts sum."""
    qos_class = {c: collections.Counter() for c in _qtenants.CLASSES}
    qos_tenant: dict = {}
    qos_served = collections.Counter()
    for q in blocks:
        for cc, blk in q["by_class"].items():
            for kk in ("admitted", "shed", "rate_limited", "queue_depth"):
                qos_class[cc][kk] += blk.get(kk, 0)
        for tname, blk in q["by_tenant"].items():
            qos_tenant.setdefault(tname, collections.Counter()).update(blk)
        qos_served.update(q["scheduler"]["served"])
    return {
        "by_class": {c: dict(qos_class[c]) for c in _qtenants.CLASSES},
        "by_tenant": {t: dict(v) for t, v in sorted(qos_tenant.items())},
        "served": dict(qos_served),
    }


def serve_stats() -> dict:
    """Counters summed across every live executor in the process, each
    executor's own :meth:`~MicrobatchExecutor.stats` under
    ``by_replica``: monotone counters sum, peaks take the maximum,
    histograms merge bin by bin, padding waste and latency percentiles
    come from the pooled raw counts and samples, ``states`` counts
    executors per state."""
    # dist/ imports the engine package, not the other way round
    from libskylark_tpu_torch.dist.coordinator import dist_stats
    from libskylark_tpu_torch.dist.serve import dist_serve_stats

    sum_keys = ("submitted", "completed", "failed", "rejected", "shed",
                "session_shed", "expired", "poisoned", "flush_failures",
                "isolation_retries", "queued", "coalesced", "flushes")
    max_keys = ("queued_peak", "isolation_depth_peak")
    dist_keys = ("jobs", "completed", "failed", "early_resolves")
    train_keys = ("jobs_submitted", "slices_run", "preemptions", "resumes",
                  "budget_exhausted", "completed", "failed", "retries",
                  "active", "queued", "shed")
    dist_sums, dist_by = collections.Counter(), collections.Counter()
    train_sums, train_seen = collections.Counter(), False
    sums = collections.Counter({k: 0 for k in sum_keys})
    maxes = {k: 0 for k in max_keys}
    batch_hist, cohort_hist = collections.Counter(), collections.Counter()
    states, ksel, kdec = (collections.Counter(), collections.Counter(),
                          collections.Counter())
    qos_blocks, cache_blocks, by_replica, lat_all = [], [], {}, []
    waste_real = waste_total = 0
    for ex in list(_EXECUTORS):
        s = ex.stats()
        for k in sum_keys:
            sums[k] += s[k]
        for k in max_keys:
            maxes[k] = max(maxes[k], s[k])
        batch_hist.update(s["batch_capacity_hist"])
        cohort_hist.update(s["cohort_size_hist"])
        for kk, vv in s["kernel"]["by_backend"].items():
            ksel[kk] += vv["flushes"]
        for kk, vv in s["kernel"]["by_reason"].items():
            kdec[kk] += vv["declined_flushes"]
        for kk in dist_keys:
            dist_sums[kk] += s["dist"][kk]
        for kk, vv in s["dist"]["by_replica"].items():
            dist_by[kk] += vv["shard_tasks"]
        if s["train"] is not None:
            train_seen = True
            for kk in train_keys:
                train_sums[kk] += int(s["train"].get(kk, 0))
        qos_blocks.append(s["qos"])
        cache_blocks.append(s["cache"])
        states[s["state"]] += 1
        with ex._stats_lock:
            waste_real += ex._pad_real
            waste_total += ex._pad_total
            lat_all.extend(ex._latency)
        name = ex.name
        while name in by_replica:
            name += "+"
        by_replica[name] = s
    lat_all.sort()
    return {
        "executors": len(by_replica), **sums, **maxes,
        "batch_capacity_hist": dict(sorted(batch_hist.items())),
        "cohort_size_hist": dict(sorted(cohort_hist.items())),
        "kernel": {"by_backend": {k: {"flushes": int(v)}
                                  for k, v in sorted(ksel.items())},
                   "by_reason": {k: {"declined_flushes": int(v)}
                                 for k, v in sorted(kdec.items())}},
        # the dist jobs and their shard placement across executors, and
        # the process-lifetime rollups of the coordinators and dist jobs
        "dist": {**{k: int(dist_sums[k]) for k in dist_keys},
                 "by_replica": {k: {"shard_tasks": int(v)}
                                for k, v in sorted(dist_by.items())},
                 "lifetime": {"coordinator": dist_stats(),
                              "serve": dist_serve_stats()}},
        # monotone counters and live occupancy summed across executors;
        # None when no executor ever ran a job
        "train": ({k: int(train_sums[k]) for k in train_keys}
                  if train_seen else None),
        "qos": _merge_qos_blocks(qos_blocks),
        "cache": _rcache.merge_cache_blocks(cache_blocks),
        "states": dict(sorted(states.items())),
        "padding_waste_ratio": (round(1.0 - waste_real / waste_total, 4)
                                if waste_total else None),
        "latency_s": {"p50": _percentile(lat_all, 0.50),
                      "p99": _percentile(lat_all, 0.99),
                      "n": len(lat_all)},
        "by_replica": dict(sorted(by_replica.items())),
        # the network front door's rollup, only where the net tier is
        # loaded: a process that serves in-process never imports it
        **({"net": sys.modules["libskylark_tpu_torch.net.server"]
            .net_stats()}
           if "libskylark_tpu_torch.net.server" in sys.modules else {}),
    }


def qos_stats() -> dict:
    """Multi-tenant QoS across every live executor, with the process-wide
    tenant registry's tenants and token balances."""
    agg = _merge_qos_blocks([ex._qos_stats_block()
                             for ex in list(_EXECUTORS)])
    agg["registry"] = _qtenants.get_registry().stats()
    return agg


def cache_stats() -> dict:
    """The result caches and residency tables across every live
    executor (cache-off executors with nothing pinned add nothing)."""
    return _rcache.merge_cache_blocks(
        [ex._cache_stats_block() for ex in list(_EXECUTORS)])


_telemetry.register_collector("serve", serve_stats)
_telemetry.register_collector("qos", qos_stats)
_telemetry.register_collector("cache", cache_stats)
