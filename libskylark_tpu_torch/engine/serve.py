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

Not ported yet (later slices): deadlines and DEGRADED shedding, the
result cache and residency, ``serve_stats``/``cache_stats``/
``request_digest``, QoS tenants and scheduling, the adaptive controller,
sessions and training jobs, the dist endpoints and mesh sharding,
telemetry spans, warmup packs and AOT.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Allocation, seed_key
from libskylark_tpu_torch.base.device import resolve_device
from libskylark_tpu_torch.base.sparse import SparseMatrix, as_sparse
from libskylark_tpu_torch.engine import bucket as bucketing

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

# the reference's SKYLARK_SPARSE_NNZ_FLOOR, SKYLARK_SPARSE_MIN_DENSITY and
# SKYLARK_FWHT_CM_SDIM defaults
SPARSE_NNZ_FLOOR = 64
SPARSE_MIN_DENSITY = 0.25
FWHT_CM_SDIM = 256

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
    nnz_cls = bucketing.nnz_class(A.nnz, SPARSE_NNZ_FLOOR)
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
    nnz_cls = bucketing.nnz_class(A.nnz, SPARSE_NNZ_FLOOR)
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
    nnz_cls = bucketing.nnz_class(S.nnz, SPARSE_NNZ_FLOOR)
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
    nnz_cls = bucketing.nnz_class(S.nnz, SPARSE_NNZ_FLOOR)
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
    """What keys a KRR/RLSC bucket's kernel: its JSON serialization (the
    reference keys on ``engine.digest`` of it)."""
    to_json = getattr(kernel, "to_json", None)
    return to_json() if callable(to_json) else repr(kernel)


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
    of two, CWT otherwise, at ``s_dim`` (default ``FWHT_CM_SDIM``), from
    the allocation (seed, 0)."""
    n = int(A.shape[1] if hasattr(A, "shape") else np.asarray(A).shape[1])
    s = int(s_dim or FWHT_CM_SDIM)
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
    nnz_cls = (bucketing.nnz_class(A.nnz, SPARSE_NNZ_FLOOR) if sparse
               else 0)
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
    executor's packing reuses."""
    kwargs.pop("timeout", None)
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
    program lane by lane. A compressed matmul's is the kernels' plain
    versions, then its lanes' products, as the sketch endpoints'."""
    from libskylark_tpu_torch.algorithms.regression import \
        sketched_solve_serve
    from libskylark_tpu_torch.nla.lowrank import lowrank_serve_apply
    from libskylark_tpu_torch.sketch.sparse_serve import sparse_solve_serve

    endpoint = ctx["endpoint"]
    out = []
    for i in range(len(kd)):
        if endpoint == "solve_l2_sketched":
            out.append(sketched_solve_serve(
                kd[i], scale[i], arrays["A"][i], arrays["B"][i],
                sketch_type=ctx["family"], s_dim=ctx["s_dim"],
                method=ctx["method"]))
        elif endpoint == "sparse_solve_l2_sketched":
            out.append(sparse_solve_serve(
                kd[i], scale[i], arrays["data"][i], arrays["indices"][i],
                arrays["indptr"][i], arrays["B"][i],
                sketch_type=ctx["family"], s_dim=ctx["s_dim"],
                method=ctx["method"], shape=ctx["padded_A"]))
        else:
            out.append(lowrank_serve_apply(
                kd[i], scale[i], arrays["kd_t"][i], arrays["scale_t"][i],
                arrays["A"][i], dist=ctx["dist"], s=ctx["s_dim"],
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
    stacked operands, tensors and host arrays. Returns the (B, ...)
    result."""
    from libskylark_tpu_torch.base.precision import solver_precision

    endpoint = ctx["endpoint"]
    if endpoint in _SKETCH_ENDPOINTS:
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
        # KRR/RLSC models on the device, one per bucket key, each pinned
        # with the caller's objects whose ids key it
        self._models: dict[tuple, tuple] = {}

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
        sequential program returns, as a tensor on the executor's device.
        ``timeout`` (seconds, default 30) bounds the backpressure wait."""
        timeout = kwargs.pop("timeout", 30.0)
        key, ctx, req = self._prepare(endpoint, **kwargs)
        self._enqueue(key, ctx, req, timeout)
        return req.future

    def _prepare(self, endpoint: str, **kwargs) -> tuple:
        """(bucket key, ctx, request) of one request, packed on the host."""
        statics, info = derive_request(endpoint, pad_floor=self.pad_floor,
                                       **kwargs)
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
        or above ``SPARSE_MIN_DENSITY``: the padded CSR lanes would carry
        more bytes than the dense operand)."""
        densify = A.density >= SPARSE_MIN_DENSITY
        with self._stats_lock:
            self._counts["sparse_submits"] += 1
            self._sparse_nnz_hist[bucketing.nnz_class(
                A.nnz, SPARSE_NNZ_FLOOR)] += 1
            if densify:
                self._counts["sparse_densified"] += 1
        return densify

    @staticmethod
    def _densified(A) -> np.ndarray:
        return np.asarray(A.to_scipy().toarray(), dtype=A.device_dtype)

    def submit_sparse(self, transform, A, dimension=None, **kw) -> Future:
        """Sparse sketch endpoint: ``A`` a SparseMatrix or scipy sparse
        operand; resolves to ``transform.apply(A.todense(), dimension)``.
        An operand at or above the density ``SPARSE_MIN_DENSITY`` goes
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
    # queueing and the flusher
    # ------------------------------------------------------------------

    def _route_locked(self, statics, ctx) -> tuple:
        """(route, decline reason or None) of a bucket, decided once, from
        its statics, before anything of it is launched."""
        r = self._routes.get(statics)
        if r is None:
            if ctx["endpoint"] in _LIBRARY_ENDPOINTS:
                r = ("library", None)
            elif self.device.type != "cuda" or self.kernel == "plain":
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

    def _stack_cohort(self, ctx: dict, cohort: list, capacity: int) -> tuple:
        """(kd, scale, arrays, h2d bytes) of one flush: the keys and scales
        and ``ctx["host"]``'s arrays stacked on the host, ``ctx["stack"]``'s
        operands stacked as tensors on the device (host operands in one
        buffer and one copy, whose bytes are counted)."""
        kd = bucketing.stack_pad([r.arrays["kd"] for r in cohort], (2,),
                                 capacity, np.uint32)
        scale = bucketing.stack_pad([np.float64(r.arrays["scale"])
                                     for r in cohort], (), capacity,
                                    np.dtype(ctx["dtype"]))
        arrays, h2d = {}, 0
        for name, (shape, dtype) in ctx.get("host", {}).items():
            arrays[name] = bucketing.stack_pad(
                [r.arrays[name] for r in cohort], shape, capacity,
                np.dtype(dtype))
        for name, (shape, dtype) in ctx["stack"].items():
            ops = [r.arrays[name] for r in cohort]
            t = bucketing.stack_pad_tensor(ops, shape, capacity,
                                           getattr(torch, dtype), self.device)
            if self.device.type == "cuda" and all(
                    not isinstance(a, torch.Tensor) or a.device.type == "cpu"
                    for a in ops):
                h2d += t.numel() * t.element_size()
            arrays[name] = t
        return kd, scale, arrays, h2d

    def _execute(self, b: _Bucket, cohort: list) -> None:
        k = len(cohort)
        capacity = bucketing.capacity_class(k, self.max_batch)
        ctx = b.ctx
        endpoint = ctx["endpoint"]
        with self._lock:
            route, declined = self._route_locked(b.key, ctx)
        kd, scale, arrays, h2d = self._stack_cohort(ctx, cohort, capacity)
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
            if endpoint == "sparse_sketch_apply":
                self._sparse_sel[route] += 1
            self._batch_hist[capacity] += 1
            self._cohort_hist[k] += 1
            pad_total = bucketing.padded_elements(ctx["stack"][primary][0],
                                                  capacity)
            pad_real = bucketing.real_elements(
                [r.true_shapes[primary] for r in cohort])
            self._pad_total += pad_total
            self._pad_real += pad_real
            obs = self._by_bucket.setdefault(b.key, collections.Counter())
            obs.update(flushes=1, requests=done, capacity=capacity,
                       pad_real=pad_real, pad_total=pad_total, h2d=h2d)
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
                    1.0 - v["pad_real"] / v["pad_total"], 4),
                "h2d_bytes_per_flush": v["h2d"] / v["flushes"]}
                for k, v in self._by_bucket.items()}
            models = len(self._models)
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
