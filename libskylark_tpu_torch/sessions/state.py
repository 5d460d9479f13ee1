"""Per-kind session state: the maintained sketch a session folds row
batches into (the port of libskylark_tpu/sessions/state.py).

Sketching transforms are linear, so the sketch of a row stream is the
sum of its batches' sketches: the state is the small maintained sketch,
never the data, cheap to checkpoint on a drain, to journal per append
and to replay after a crash (:mod:`libskylark_tpu_torch.sessions.
registry`). The accumulators live on the state's device (the package
default unless the registry names one).

===========  =============================================================
``cwt``      CountSketch appender: B2's accumulate mode adds each batch
             into the carried (s, d) accumulator at the batch's row
             offset, each cell's rows in increasing order: ``torch.equal``
             to the one-shot ``CWT.apply`` of the rows folded so far.
``jlt``      Dense JLT appender: the operator's column panel of the
             batch's rows (``DenseTransform.s_panel``, made in torch)
             times the batch, added to the accumulator: a float32
             ``torch.matmul`` at the solver precision (full float32 by
             default), as the reference's XLA matmul outside any kernel.
``srht``     SRHT appender (FJLT with the WHT mixer): ``FJLT.fold_rows``
             with the Rademacher diagonal made once. ``n`` a power of two.
``isvd``     Incremental randomized SVD: the ``jlt`` sketch; ``finalize``
             gives the top-k singular values and right singular vectors.
``krr``      Online KRR by random features: per batch the GaussianRFT
             features Z of the rows (B1-cos on the card), then ``G +=
             ZᵀZ`` and ``b += ZᵀY``; ``finalize`` solves ``(G + λI) w =
             b``.
===========  =============================================================

``fold`` is a deterministic function of the state's bytes and the
batch's bytes, and a checkpoint stores the accumulators' bytes, so a
session resumed from a checkpoint and its journal's tail finalizes
``torch.equal`` to the uninterrupted session.

dtype: a spec's ``dtype`` is that of its journaled batches. The
accumulators and the fold compute in float32 for ``"float64"``, as the
reference's do with jax's 64-bit mode off (its ``jnp.zeros(..., float64)``
is float32); another dtype computes in itself, and a ``cwt`` session in
a dtype other than float32 has no fixed-order fold on the card and is
refused there (ROADMAP C23).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import errors

KINDS = ("cwt", "jlt", "srht", "isvd", "krr", "train")


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """The (pickleable, JSON-able) identity of one session: everything a
    peer needs to rebuild the transform streams and resume. ``n`` is the
    declared row extent (appends past it refuse); ``s_dim`` the sketch or
    feature dimension; ``d`` the row width; ``seed`` the transform's
    Context seed."""

    kind: str
    n: int
    s_dim: int
    d: int
    seed: int = 0
    dtype: str = "float32"
    targets: int = 0          # Y columns carried (0: X only)
    k: int = 0                # isvd: ranks returned at finalize
    lam: float = 1e-3         # krr: ridge
    sigma: float = 1.0        # krr: RFT bandwidth
    ttl_s: Optional[float] = None
    extra: Optional[dict] = None  # train: the training job's spec

    def validate(self) -> "SessionSpec":
        if self.kind not in KINDS:
            raise errors.InvalidParametersError(
                f"unknown session kind {self.kind!r}; expected one of "
                f"{KINDS}")
        if self.n < 1 or self.s_dim < 1 or self.d < 1:
            raise errors.InvalidParametersError(
                f"session dims must be positive, got n={self.n} "
                f"s_dim={self.s_dim} d={self.d}")
        if self.kind == "srht" and self.n & (self.n - 1):
            raise errors.InvalidParametersError(
                f"srht sessions need n a power of two (WHT length), "
                f"got {self.n}")
        if self.kind == "krr" and self.targets < 1:
            raise errors.InvalidParametersError(
                "krr sessions carry targets: open with targets >= 1")
        if self.kind == "isvd" and not 0 <= self.k <= min(self.s_dim,
                                                         self.d):
            raise errors.InvalidParametersError(
                f"isvd k must be in [0, min(s_dim, d)], got {self.k}")
        if self.kind == "train":
            if not isinstance(self.extra, dict) or "solver" not in \
                    self.extra:
                raise errors.InvalidParametersError(
                    "train sessions carry their TrainJobSpec in "
                    "spec.extra (a dict with at least 'solver')")
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SessionSpec":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)
                      if f.name in d}).validate()


class SessionState:
    """One live session's maintained sketch and positional cursor.

    ``rows`` is the stream position (rows folded in), ``seq`` the last
    applied append's sequence number (the cursor the journal replays
    against). :meth:`arrays` / :meth:`load` move the accumulators to and
    from host bytes without rounding."""

    def __init__(self, spec: SessionSpec, device=None):
        from libskylark_tpu_torch.base.context import Context
        from libskylark_tpu_torch.base.device import resolve_device
        from libskylark_tpu_torch.io.streaming import compute_dtype

        self.spec = spec.validate()
        if spec.kind == "train":
            raise errors.InvalidParametersError(
                "train sessions are built by sessions.state.make_state"
                " (they need the registry directory for operands)")
        self.device = resolve_device(device)
        self.rows = 0
        self.seq = 0
        dt = self.dtype = compute_dtype(spec.dtype)
        ctx = Context(seed=int(spec.seed))
        self._t = self._diag = self._rft = None
        if spec.kind == "cwt":
            from libskylark_tpu_torch.sketch.hash import CWT

            self._t = CWT(spec.n, spec.s_dim, ctx)
        elif spec.kind in ("jlt", "isvd"):
            from libskylark_tpu_torch.sketch.dense import JLT

            self._t = JLT(spec.n, spec.s_dim, ctx)
        elif spec.kind == "srht":
            from libskylark_tpu_torch.sketch.fjlt import FJLT

            # the whole diagonal once, on the host: a session folds many
            # small appends, each reading its slice
            self._t = FJLT(spec.n, spec.s_dim, ctx, fut="wht")
            self._diag = self._t.diagonal(dt).numpy()
        else:  # krr
            from libskylark_tpu_torch.sketch.rft import GaussianRFT

            self._rft = GaussianRFT(spec.d, spec.s_dim, ctx,
                                    sigma=float(spec.sigma))

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        # built at once: a zero-append session checkpoints and resumes like
        # any other
        if spec.kind == "krr":
            self.acc = {"G": zeros(spec.s_dim, spec.s_dim),
                        "b": zeros(spec.s_dim, spec.targets)}
        else:
            self.acc = {"SX": zeros(spec.s_dim, spec.d)}
            if spec.targets:
                self.acc["SY"] = zeros(spec.s_dim, spec.targets)

    # -- batch intake ---------------------------------------------------

    def coerce_batch(self, X, Y=None):
        """Validate and canonicalize one append batch against the spec
        (host arrays of the spec's dtype, the row bound). Runs before the
        journal write, so a record that cannot fold is never made
        durable."""
        from libskylark_tpu_torch.ml.coding import host_array

        s = self.spec
        X = np.asarray(host_array(X), dtype=np.dtype(s.dtype))
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != s.d:
            raise errors.InvalidParametersError(
                f"append batch must be (m, {s.d}), got {X.shape}")
        if self.rows + X.shape[0] > s.n:
            raise errors.InvalidParametersError(
                f"append past the declared stream extent: "
                f"{self.rows} + {X.shape[0]} > n={s.n}")
        if s.targets:
            if Y is None:
                raise errors.InvalidParametersError(
                    f"session carries {s.targets} target column(s); "
                    "append needs Y")
            Y = np.asarray(host_array(Y), dtype=np.dtype(s.dtype))
            if Y.ndim == 1:
                Y = Y[:, None]
            if Y.shape != (X.shape[0], s.targets):
                raise errors.InvalidParametersError(
                    f"Y batch must be ({X.shape[0]}, {s.targets}), "
                    f"got {Y.shape}")
        else:
            Y = None
        return X, Y

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, self.dtype)

    def fold(self, X: np.ndarray, Y: Optional[np.ndarray]) -> None:
        """Fold one coerced batch into the maintained sketch at the
        current row position."""
        from libskylark_tpu_torch.base.precision import solver_precision

        s = self.spec
        lo, hi = self.rows, self.rows + X.shape[0]
        Xj = self._on_device(X)
        Yj = self._on_device(Y) if Y is not None else None
        if s.kind != "krr":
            pairs = [(self.acc["SX"], Xj)]
            if Yj is not None:
                pairs.append((self.acc["SY"], Yj))
            fold_sketch(s.kind, self._t, pairs, lo, diagonal=self._diag)
        else:
            from libskylark_tpu_torch.sketch import ROWWISE

            Z = self._rft.apply(Xj, ROWWISE, device=self.device)
            with solver_precision():
                self.acc["G"] += Z.T @ Z
                self.acc["b"] += Z.T @ Yj
        self.rows = hi

    # -- checkpoint round trip ------------------------------------------

    def arrays(self) -> dict:
        """Host snapshot of the accumulators (exact bytes)."""
        return {k: v.detach().cpu().numpy() for k, v in self.acc.items()}

    def load(self, arrays: dict, rows: int, seq: int) -> None:
        for k in self.acc:
            if k not in arrays:
                raise errors.InvalidParametersError(
                    f"checkpoint missing accumulator {k!r}")
            if tuple(arrays[k].shape) != tuple(self.acc[k].shape):
                raise errors.InvalidParametersError(
                    f"checkpoint accumulator {k!r} has shape "
                    f"{arrays[k].shape}, expected "
                    f"{tuple(self.acc[k].shape)}")
            self.acc[k] = torch.from_numpy(np.array(arrays[k])).to(
                self.device, self.dtype)
        self.rows = int(rows)
        self.seq = int(seq)

    # -- finalize -------------------------------------------------------

    def finalize(self) -> dict:
        """The session's result, tensors on the state's device: the
        maintained sketch(es) of the appenders, the singular values and
        vectors of ``isvd``, the coefficients of ``krr``."""
        from libskylark_tpu_torch.base.precision import solver_precision

        s = self.spec
        if s.kind == "krr":
            G = self.acc["G"]
            eye = torch.eye(s.s_dim, dtype=G.dtype, device=G.device)
            with solver_precision():
                w = torch.linalg.solve(
                    G + torch.tensor(s.lam, dtype=G.dtype) * eye,
                    self.acc["b"])
            return {"coef": w, "rows": self.rows}
        if s.kind == "isvd":
            _, sv, Vt = torch.linalg.svd(self.acc["SX"], full_matrices=False)
            k = s.k or min(s.s_dim, s.d)
            return {"singular_values": sv[:k], "Vt": Vt[:k],
                    "rows": self.rows}
        out = {"SX": self.acc["SX"].clone(), "rows": self.rows}
        if "SY" in self.acc:
            out["SY"] = self.acc["SY"].clone()
        return out


def fold_sketch(kind: str, transform, pairs, lo: int, diagonal=None) -> None:
    """Add the sketch of rows at the coordinates [lo, lo + m) into each
    accumulator of ``pairs`` ((accumulator, rows) on one device), in
    place: the fold of a session's append and of a distributed sketch's
    shard (:mod:`libskylark_tpu_torch.dist.plan`), one bit pattern for
    both. ``cwt`` by B2's accumulate mode, ``jlt``/``isvd`` by the
    operator's column panel (made once) times the rows at the solver
    precision, ``srht`` by ``FJLT.fold_rows`` (``diagonal``: its whole
    host diagonal, or None to make the rows' slice)."""
    from libskylark_tpu_torch.base.precision import solver_precision
    from libskylark_tpu_torch.io.streaming import fold_cwt

    acc0, X0 = pairs[0]
    hi = lo + X0.shape[0]
    if kind == "cwt":
        key = transform.kernel_key()
        for acc, X in pairs:
            fold_cwt(key, X, acc, acc.shape[0], lo)
    elif kind == "srht":
        for acc, X in pairs:
            acc += transform.fold_rows(X, lo, hi, acc.dtype,
                                       diagonal=diagonal)
    else:
        panel = transform.s_panel(lo, hi, acc0.dtype, acc0.device)
        with solver_precision():
            for acc, X in pairs:
                acc += panel @ X


def make_state(spec: SessionSpec, directory: Optional[str] = None,
               sid: Optional[str] = None, device=None):
    """The state factory the registry goes through at open and at
    resume: a :class:`SessionState` for the sketch kinds, a
    :class:`~libskylark_tpu_torch.train.state.TrainSessionState` for
    ``train``, which needs the registry ``directory`` and ``sid`` to find
    the job's operand sidecar (``<sid>.operands.npz``)."""
    spec = spec.validate()
    if spec.kind == "train":
        from libskylark_tpu_torch.train.state import TrainSessionState

        return TrainSessionState(spec, directory=directory, sid=sid,
                                 device=device)
    return SessionState(spec, device=device)


__all__ = ["KINDS", "SessionSpec", "SessionState", "fold_sketch",
           "make_state"]
