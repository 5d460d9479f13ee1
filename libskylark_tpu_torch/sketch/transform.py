"""Sketch transform protocol, dimension tags, and serialization registry.

The port of libskylark_tpu/sketch/transform.py. Dimension convention:

- ``COLUMNWISE``: sketch_of_A = S · A   (A is N×m → S_dim×m)
- ``ROWWISE``:    sketch_of_A = A · Sᵀ  (A is m×N → m×S_dim)

``to_dict()`` writes the reference's fields, version and stream format,
so a sketch serialized by either package loads in the other and names the
same operator.

Per-seed inputs: every method that makes a tensor (or the key data a
kernel takes) from the transform's seed is marked :func:`seeded`. A
compiled body on the card (engine/compiled.py) runs under a
:class:`SeedBinding`: the first run makes each such value outside the
graph and keeps it in a buffer on the card, the capture reads the
buffers, and every later call refills them from its own transforms, so
one graph serves every seed of one signature (:func:`signature`).
"""

from __future__ import annotations

import contextlib
import enum
import functools
import json
import threading
from typing import Any, Union

import numpy as np
import torch

from libskylark_tpu_torch import __version__
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import (Allocation, Context,
                                                fold_in, keys_sealed)
from libskylark_tpu_torch.base.device import as_tensor, resolve_device
from libskylark_tpu_torch.base.sparse import as_sparse, is_sparse_operand


class Dimension(enum.Enum):
    COLUMNWISE = "columnwise"
    ROWWISE = "rowwise"


COLUMNWISE = Dimension.COLUMNWISE
ROWWISE = Dimension.ROWWISE

_REGISTRY: dict[str, type["SketchTransform"]] = {}

_bound = threading.local()


def seeded(method):
    """Mark a transform method whose result is a pure function of the
    transform's seed and the method's arguments: a tensor, or key data
    (a (2,) uint32 array) that a kernel takes. Outside a compiled body
    the method runs as written; inside one the active
    :class:`SeedBinding` serves it."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        binding = getattr(_bound, "binding", None)
        if binding is None:
            return method(self, *args, **kwargs)
        return binding.take(self, method, args, kwargs)

    return wrapped


def signature(T: "SketchTransform") -> str:
    """The transform without its seed: class, dimensions and
    hyper-parameters (its ``to_dict()`` but for the creation context and
    the package version), and the dtype and device of a pinned operator
    (``materialize()``), which changes the route. Two transforms of one
    signature take the same routes and the same per-seed shapes."""
    d = {k: v for k, v in T.to_dict().items()
         if k not in ("creation_context", "skylark_version")}
    pinned = getattr(T, "_op_cache", None)
    if pinned is not None:
        d["pinned"] = [str(pinned.dtype), str(pinned.device)]
    return json.dumps(d, sort_keys=True)


def _members(T: "SketchTransform", path: tuple = ()):
    """(path, transform) of ``T`` and of its sub-transforms, depth first:
    a path is the child indices from ``T`` down."""
    yield path, T
    for i, child in enumerate(T._children()):
        yield from _members(child, path + (i,))


def _resolve(T: "SketchTransform", path: tuple) -> "SketchTransform":
    for i in path:
        T = T._children()[i]
    return T


class SeedBinding:
    """The per-seed inputs of one compiled body on ``device``. Slot i is
    the body's i-th :func:`seeded` call: (the argument index of its
    transform and the path to it among that argument's sub-transforms,
    the method, its arguments) and a buffer on the card.

    - ``with binding.active():`` the first run records: each call runs
      its method (the binding off and the keys unsealed, so the method's
      own reads are plain) and keeps the value in a new buffer, which it
      returns;
    - ``with binding.active(replay=True):`` (the capture) returns the
      buffers in the same order, checking each call against its slot;
    - :meth:`refill` makes every slot's value again from another call's
      transforms, outside any capture, and copies it into the buffer.

    While a binding is active the allocation keys are sealed
    (``base.context.keys_sealed``): a per-seed value made anywhere but in
    a seeded method raises, as does a seeded call on a transform that is
    neither one of the body's arguments nor a sub-transform of one. A
    seeded method may return None (no pinned operator): its slot then
    holds None, and a refill that gets a tensor there raises."""

    def __init__(self, args, device):
        self.device = torch.device(device)
        self._index = {id(t): (i, path)
                       for i, a in enumerate(args)
                       if isinstance(a, SketchTransform)
                       for path, t in _members(a)}
        self.slots: list = []
        self._cursor = None

    @contextlib.contextmanager
    def active(self, replay: bool = False):
        prev = getattr(_bound, "binding", None)
        _bound.binding = self
        self._cursor = 0 if replay else None
        try:
            with keys_sealed():
                yield self
        finally:
            _bound.binding = prev

    @staticmethod
    def _value(T, method, args, kwargs):
        """The method's value, made with the binding off and the keys
        unsealed; key data as its words in an int32 host tensor."""
        prev = getattr(_bound, "binding", None)
        _bound.binding = None
        try:
            with keys_sealed(False):
                value = method(T, *args, **kwargs)
        finally:
            _bound.binding = prev
        if value is None or isinstance(value, torch.Tensor):
            return value
        words = np.ascontiguousarray(np.asarray(value, dtype=np.uint32))
        return torch.from_numpy(words.view(np.int32))

    def take(self, T, method, args, kwargs):
        where = self._index.get(id(T))
        if where is None:
            raise errors.UnsupportedError(
                f"a compiled body made {method.__qualname__} of a "
                f"{T.sketch_type} that is not one of its arguments: pass "
                "the transform positionally")
        if self._cursor is None:
            buf = self._value(T, method, args, kwargs)
            buf = None if buf is None else buf.to(
                self.device, non_blocking=True, copy=True)
            self.slots.append((where, method, args, kwargs, buf))
            return buf
        w, m, a, k, buf = self.slots[self._cursor]
        if (w, m, a, k) != (where, method, args, kwargs):
            raise errors.UnsupportedError(
                f"a compiled body's seeded call {self._cursor} differs "
                f"between its runs ({method.__qualname__})")
        self._cursor += 1
        return buf

    def refill(self, args) -> None:
        """Every slot made again from ``args`` (this call's arguments,
        the transforms at the recorded indices and paths) into its
        buffer."""
        for (idx, path), method, a, k, buf in self.slots:
            value = self._value(_resolve(args[idx], path), method, a, k)
            if (value is None) != (buf is None):
                raise errors.UnsupportedError(
                    f"{method.__qualname__} gave a value on one call of a "
                    "compiled body and None on another")
            if buf is not None:
                buf.copy_(value, non_blocking=True)


def binding_active() -> bool:
    """Whether a compiled body runs in this thread under a binding."""
    return getattr(_bound, "binding", None) is not None


def register(cls: type["SketchTransform"]) -> type["SketchTransform"]:
    """Register a transform class for deserialization."""
    _REGISTRY[cls.sketch_type] = cls
    return cls


class OperatorCache:
    """Opt-in materialize-and-reuse for transforms whose operator is a
    lazily generated dense matrix: ``materialize()`` pins the operator on
    a device, and later applies on that device contract against it
    instead of generating it again — all but those that the fused
    kernel's route serves (sketch/dense.py), which never read it.
    Runtime state only, never serialized."""

    _op_cache = None
    _eager_applies = 0

    def _full_operator(self, dtype, device) -> torch.Tensor:
        raise NotImplementedError

    def materialize(self, dtype=torch.float32, device=None):
        """Pin the full operator on ``device``; returns ``self``."""
        self._op_cache = self._full_operator(dtype, resolve_device(device))
        return self

    def dematerialize(self):
        """Drop the pinned operator and the auto-materialize count."""
        self._op_cache = None
        self._eager_applies = 0
        return self

    def _op_bytes(self, dtype) -> int:
        return int(self._S) * int(self._N) * dtype.itemsize

    def _note_eager_apply(self, A: torch.Tensor,
                          seq_axis: int | None = None) -> None:
        """Auto-materialize dispatch (sketch/params.py): the Nth apply of
        this instance pins its operator when it fits the budget — unless
        pinning would change the numerics of later applies. A compiled
        body's applies are not counted: a pin would change what its
        graph computes."""
        if binding_active():
            return
        c = self._op_cache
        if (c is not None and c.device == A.device
                and A.dtype.itemsize <= c.dtype.itemsize):
            return
        from libskylark_tpu_torch.sketch import params as sketch_params

        if not sketch_params.get_auto_materialize():
            return
        if self._materialize_changes_numerics(A, seq_axis):
            return
        self._eager_applies += 1
        if self._eager_applies < sketch_params.get_auto_materialize_after():
            return
        if self._op_bytes(A.dtype) > sketch_params.get_auto_materialize_bytes():
            return
        self.materialize(A.dtype, A.device)

    def _materialize_changes_numerics(self, A, seq_axis=None) -> bool:
        """True when pinning would change the numerics of later applies
        (the fused kernel's route contracts in another order than a
        cached-operator matmul). Default False."""
        return False

    @seeded
    def _cached_op(self, dtype, device):
        """The pinned operator on ``device``, cast to ``dtype``; None when
        there is none there, or when ``dtype`` is wider than the cache.
        Seeded: inside a compiled body the pinned operator is an input
        (its presence is part of :func:`signature`)."""
        c = self._op_cache
        if c is None or c.device != device or dtype.itemsize > c.dtype.itemsize:
            return None
        return c if c.dtype == dtype else c.to(dtype)


class SketchTransform:
    """A sketching transform S: R^N -> R^S_dim, defined by its (seed,
    counter) allocation plus hyper-parameters. Construction advances the
    context's counter."""

    sketch_type = "SketchTransform"

    # Bumped whenever the bit-level stream definition changes; a
    # serialization of another format is refused.
    STREAM_FORMAT = 2

    def __init__(self, N: int, S: int, context: Union[Context, Allocation]):
        if N <= 0 or S <= 0:
            raise errors.InvalidParametersError(
                f"sketch dims must be positive, got N={N}, S={S}"
            )
        self._N = int(N)
        self._S = int(S)
        if isinstance(context, Context):
            self._alloc = context.allocate()
        else:
            self._alloc = context
        self._build()

    def _build(self) -> None:
        """Derive what the transform needs from its dimensions and
        allocation (block geometry, sub-transforms, host sample arrays).
        Default: nothing."""

    def _children(self) -> tuple:
        """The sub-transforms this one applies (PPT's CountSketches): a
        compiled body's binding reaches their seeded values through
        their parent's argument. Default: none."""
        return ()

    @property
    def input_dim(self) -> int:
        return self._N

    @property
    def sketch_dim(self) -> int:
        return self._S

    @property
    def allocation(self) -> Allocation:
        return self._alloc

    def subkey(self, tag: int):
        """Key data of sub-stream ``tag``: fold_in(allocation key, tag)."""
        return fold_in(self._alloc.key, tag)

    @seeded
    def kernel_key(self, *path):
        """The key data a kernel takes: the allocation key folded with
        each tag of ``path`` (``kernel_key(0)`` is ``subkey(0)``). Inside
        a compiled body on the card, the same words as an int32 tensor
        there (:class:`SeedBinding`)."""
        k = self._alloc.key
        for tag in path:
            k = fold_in(k, tag)
        return k

    def apply(self, A, dimension: Dimension = COLUMNWISE,
              device=None) -> torch.Tensor:
        """COLUMNWISE: A is (N, m) -> (S, m). ROWWISE: A is (m, N) ->
        (m, S). ``A`` is a numpy array or tensor; the apply runs on
        ``device`` (default: the package default device). A
        :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix` (or scipy
        sparse) operand takes the transform's sparse apply and gives a
        dense result on ``device``; the transforms without one (FJLT,
        Fastfood, QRFT, PPT, as in the reference) raise
        NotImplementedYetError. A
        :class:`~libskylark_tpu_torch.base.dist_sparse.DistSparseMatrix`
        takes the transform's distributed apply and gives the whole dense
        result on every rank, on the rank's device (``device`` is not
        read); the transforms without one raise NotImplementedYetError. A
        DTensor (parallel/mesh.py) takes sketch/dtensor_apply.py and gives
        a DTensor: each rank's block through the one-process route, or its
        partial and an all_reduce where the sketched axis is split
        (``device`` is not read)."""
        from libskylark_tpu_torch.base.dist_sparse import DistSparseMatrix
        from libskylark_tpu_torch.parallel.mesh import _is_sharded

        if isinstance(A, DistSparseMatrix):
            # dimension validation lives in dist_sparse_apply._check_dim
            if dimension == COLUMNWISE:
                return self._apply_columnwise_dist_sparse(A)
            return self._apply_rowwise_dist_sparse(A)
        if _is_sharded(A):
            if dimension == COLUMNWISE:
                return self._apply_columnwise_dtensor(A)
            return self._apply_rowwise_dtensor(A)
        if is_sparse_operand(A) or _is_scipy_sparse(A):
            A = as_sparse(A)
            n = A.height if dimension == COLUMNWISE else A.width
            if n != self._N:
                raise errors.SketchError(
                    f"{dimension.value} apply expects {self._N} "
                    f"{'rows' if dimension == COLUMNWISE else 'cols'}, got "
                    f"{A.shape}")
            d = resolve_device(device)
            if dimension == COLUMNWISE:
                return self._apply_columnwise_sparse(A, d)
            return self._apply_rowwise_sparse(A, d)
        A = as_tensor(A, device)
        if A.ndim == 1:
            A = A[:, None] if dimension == COLUMNWISE else A[None, :]
        if dimension == COLUMNWISE:
            if A.shape[0] != self._N:
                raise errors.SketchError(
                    f"columnwise apply expects A with {self._N} rows, "
                    f"got {tuple(A.shape)}")
            return self._apply_columnwise(A)
        if A.shape[1] != self._N:
            raise errors.SketchError(
                f"rowwise apply expects A with {self._N} cols, "
                f"got {tuple(A.shape)}")
        return self._apply_rowwise(A)

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        raise errors.NotImplementedYetError(
            f"{self.sketch_type}: columnwise apply not implemented")

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        raise errors.NotImplementedYetError(
            f"{self.sketch_type}: rowwise apply not implemented")

    def _apply_columnwise_sparse(self, A, device) -> torch.Tensor:
        raise errors.NotImplementedYetError(
            f"{self.sketch_type}: columnwise sparse apply not implemented")

    def _apply_rowwise_sparse(self, A, device) -> torch.Tensor:
        raise errors.NotImplementedYetError(
            f"{self.sketch_type}: rowwise sparse apply not implemented")

    def _apply_columnwise_dist_sparse(self, A) -> torch.Tensor:
        raise errors.NotImplementedYetError(
            f"{self.sketch_type}: columnwise distributed-sparse apply "
            "not implemented")

    def _apply_rowwise_dist_sparse(self, A) -> torch.Tensor:
        raise errors.NotImplementedYetError(
            f"{self.sketch_type}: rowwise distributed-sparse apply "
            "not implemented")

    def _apply_columnwise_dtensor(self, A):
        from libskylark_tpu_torch.sketch import dtensor_apply

        return dtensor_apply.apply(self, A, rowwise=False)

    def _apply_rowwise_dtensor(self, A):
        from libskylark_tpu_torch.sketch import dtensor_apply

        return dtensor_apply.apply(self, A, rowwise=True)

    def _split_axis_apply(self, A_loc: torch.Tensor, lo: int, rowwise: bool,
                          reduce) -> torch.Tensor:
        """The apply of a DTensor whose sketched axis is split: this
        rank's partial over its block (global start ``lo`` on the
        sketched axis), ``reduce`` (the sum over the ranks), then the
        epilogue (sketch/dtensor_apply.py)."""
        raise errors.NotImplementedYetError(
            f"{self.sketch_type}: apply of a DTensor whose sketched axis is "
            "split (ROADMAP A5b)")

    def _extra_params(self) -> dict[str, Any]:
        """Transform-specific hyper-params to serialize."""
        return {}

    def to_dict(self) -> dict[str, Any]:
        d = {
            "skylark_object_type": "sketch",
            "sketch_type": self.sketch_type,
            "skylark_version": __version__,
            "stream_format": self.STREAM_FORMAT,
            "N": self._N,
            "S": self._S,
            "creation_context": self._alloc.to_dict(),
        }
        d.update(self._extra_params())
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def _from_parts(cls, N: int, S: int, alloc: Allocation,
                    d: dict[str, Any]) -> "SketchTransform":
        return cls(N, S, alloc)

    def __repr__(self) -> str:
        return f"{self.sketch_type}(N={self._N}, S={self._S})"


def _is_scipy_sparse(A) -> bool:
    if type(A).__module__.split(".")[0] != "scipy":
        return False
    import scipy.sparse as sp

    return sp.issparse(A)


def deserialize_sketch(obj: Union[str, dict[str, Any]]) -> SketchTransform:
    """Reconstruct a transform from its JSON form (or its dict)."""
    d = json.loads(obj) if isinstance(obj, str) else obj
    stype = d.get("sketch_type")
    cls = _REGISTRY.get(stype)
    if cls is None:
        raise errors.SketchError(f"unknown sketch type {stype!r}")
    # a missing field is a pre-versioning (format-1) serialization
    fmt = int(d.get("stream_format", 1))
    if fmt != SketchTransform.STREAM_FORMAT:
        raise errors.SketchError(
            f"sketch was serialized with stream format {fmt}; this build "
            f"implements format {SketchTransform.STREAM_FORMAT} — the "
            "operator would not reproduce")
    alloc = Allocation.from_dict(d["creation_context"])
    return cls._from_parts(int(d["N"]), int(d["S"]), alloc, d)
