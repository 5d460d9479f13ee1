"""Training jobs as sessions: a solver slice engine behind the
session-state protocol (the port of libskylark_tpu/train/state.py).

A train job is a serve session of kind ``"train"``, so it has the
sessions' journal, checkpoints and lease fencing:

=================  ====================================================
session concept    train meaning
=================  ====================================================
``spec``           :class:`SessionSpec` with ``kind="train"``;
                   ``spec.extra`` carries the ``TrainJobSpec`` dict,
                   ``spec.n`` the iteration budget
``append batch``   one slice directive: a (1, 1) int64 array holding
                   k, "advance the solver ≤ k iterations"
``fold``           ``engine.step(state, k)``, deterministic, so a
                   journal replay re-runs the slices bit-equal
``rows``           the iterations requested so far (the budget cursor;
                   the engine's own ``it`` counts those run)
``checkpoint``     the engine's state dict (host arrays, exact bytes)
                   through ``utility.checkpoint.save_sync``
``finalize``       ``engine.result(state)``, the trained model
=================  ====================================================

The operands are persisted once at submit, before the session opens, as
a sidecar ``<sid>.operands.npz`` beside the journal (``save_sync``, the
reference's format byte for byte), so any executor that owns the
session's files rebuilds the engine from the directory alone and
continues bit-equal from the last acknowledged slice.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.ml.coding import host_array
from libskylark_tpu_torch.sessions.state import SessionSpec
from libskylark_tpu_torch.train import slices as _slices

#: sidecar basename suffix (``save_sync`` adds .npz/.json)
OPERANDS_SUFFIX = ".operands"


def operands_path(directory: str, sid: str) -> str:
    return os.path.join(directory, sid + OPERANDS_SUFFIX)


def save_operands(directory: str, sid: str, operands: dict,
                  digests: Optional[dict] = None) -> None:
    """Persist the job's operands durably (atomic npz + metadata
    sidecar) before the session opens: a session whose journal exists
    without its operands could not be resumed."""
    from libskylark_tpu_torch.utility import checkpoint as _ckpt

    _ckpt.save_sync(operands_path(directory, sid),
                    {k: host_array(v) for k, v in operands.items()},
                    {"digests": digests or {}})


def load_operands(directory: str, sid: str) -> dict:
    from libskylark_tpu_torch.utility import checkpoint as _ckpt

    loaded = _ckpt.load_sync(operands_path(directory, sid))
    if loaded is None:
        raise errors.SessionEvictedError(
            f"train session {sid}: no operand sidecar at "
            f"{operands_path(directory, sid)}.npz — the job cannot be "
            "rebuilt (submit persists operands before opening the "
            "session, so the artifacts were removed)")
    arrays, _meta = loaded
    return arrays


def remove_operands(directory: str, sid: str) -> None:
    base = operands_path(directory, sid)
    for suffix in (".npz", ".json"):
        try:
            os.unlink(base + suffix)
        except FileNotFoundError:
            pass


class TrainSessionState:
    """Session-state protocol over a solver slice engine (built by
    :func:`sessions.state.make_state` for ``kind="train"``), the engine
    on ``device`` (default: the package default)."""

    def __init__(self, spec: SessionSpec, directory: Optional[str] = None,
                 sid: Optional[str] = None, device=None):
        self.spec = spec.validate()
        if directory is None or sid is None:
            raise errors.InvalidParametersError(
                "train sessions need a registry directory and session "
                "id (the operand sidecar lives there); open them "
                "through a SessionRegistry")
        job = dict(spec.extra)
        self._job = job
        operands = load_operands(directory, sid)
        self._engine = _slices.make_engine(
            str(job["solver"]), dict(job.get("hyper") or {}), operands,
            device=device)
        self._state = self._engine.init()
        self.rows = 0
        self.seq = 0

    # -- batch intake (slice directives) --------------------------------

    def coerce_batch(self, X, Y=None):
        """A train append is a slice directive: a positive iteration
        count k as a (1, 1) int64 array (the journal record). The budget
        is enforced here, before the journal write: a slice that would
        pass ``spec.n`` iterations is refused, not journaled."""
        if Y is not None:
            raise errors.InvalidParametersError(
                "train sessions take no Y batch")
        k = np.asarray(host_array(X))
        if k.size != 1:
            raise errors.InvalidParametersError(
                f"train append payload must be a single iteration "
                f"count, got shape {k.shape}")
        kval = int(k.reshape(()))
        if kval < 1:
            raise errors.InvalidParametersError(
                f"train slice must advance >= 1 iteration, got {kval}")
        if self.rows + kval > self.spec.n:
            raise errors.InvalidParametersError(
                f"slice past the job's iteration budget: "
                f"{self.rows} + {kval} > budget={self.spec.n}")
        return np.asarray([[kval]], dtype=np.int64), None

    def fold(self, X: np.ndarray, Y) -> None:
        """Advance the solver ≤ k iterations, the replay unit. ``rows``
        counts requested iterations; once the engine has converged,
        further iterations are no-ops inside ``step``."""
        del Y
        k = int(np.asarray(X).reshape(()))
        self._state = self._engine.step(self._state, k)
        self.rows += k

    # -- checkpoint round trip ------------------------------------------

    def arrays(self) -> dict:
        return {k: np.asarray(v) for k, v in self._state.items()}

    def load(self, arrays: dict, rows: int, seq: int) -> None:
        expected = set(self._state)
        got = set(arrays)
        if expected != got:
            raise errors.InvalidParametersError(
                f"train checkpoint state keys {sorted(got)} do not "
                f"match the engine's {sorted(expected)} — checkpoint "
                "from a different solver or build")
        self._state = {k: np.asarray(v) for k, v in arrays.items()}
        self.rows = int(rows)
        self.seq = int(seq)

    # -- progress / terminal --------------------------------------------

    def info(self) -> dict:
        """{"iterations", "residual", "converged"}: the source of the
        progress and residual gauges."""
        return self._engine.info(self._state)

    @property
    def converged(self) -> bool:
        return bool(self.info().get("converged"))

    def finalize(self) -> dict:
        out = dict(self._engine.result(self._state))
        out.setdefault("rows", self.rows)
        return out


__all__ = [
    "OPERANDS_SUFFIX", "TrainSessionState", "operands_path",
    "save_operands", "load_operands", "remove_operands",
]
