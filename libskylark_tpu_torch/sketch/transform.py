"""Sketch transform protocol, dimension tags, and serialization registry.

The port of libskylark_tpu/sketch/transform.py. Dimension convention:

- ``COLUMNWISE``: sketch_of_A = S · A   (A is N×m → S_dim×m)
- ``ROWWISE``:    sketch_of_A = A · Sᵀ  (A is m×N → m×S_dim)

``to_dict()`` writes the reference's fields, version and stream format,
so a sketch serialized by either package loads in the other and names the
same operator.
"""

from __future__ import annotations

import enum
import json
from typing import Any, Union

import torch

from libskylark_tpu_torch import __version__
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Allocation, Context, fold_in
from libskylark_tpu_torch.base.device import as_tensor, resolve_device
from libskylark_tpu_torch.base.sparse import as_sparse, is_sparse_operand


class Dimension(enum.Enum):
    COLUMNWISE = "columnwise"
    ROWWISE = "rowwise"


COLUMNWISE = Dimension.COLUMNWISE
ROWWISE = Dimension.ROWWISE

_REGISTRY: dict[str, type["SketchTransform"]] = {}


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
        pinning would change the numerics of later applies."""
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

    def _cached_op(self, dtype, device):
        """The pinned operator on ``device``, cast to ``dtype``; None when
        there is none there, or when ``dtype`` is wider than the cache."""
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

    def apply(self, A, dimension: Dimension = COLUMNWISE,
              device=None) -> torch.Tensor:
        """COLUMNWISE: A is (N, m) -> (S, m). ROWWISE: A is (m, N) ->
        (m, S). ``A`` is a numpy array or tensor; the apply runs on
        ``device`` (default: the package default device). A
        :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix` (or scipy
        sparse) operand takes the transform's sparse apply and gives a
        dense result."""
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
