"""Sliceable solvers: the iterative trainers as bounded-iteration steps
(the port of libskylark_tpu/train/slices.py).

A **slice engine** advances a solver at most ``k`` iterations per
``step(state, k)``, as a deterministic function of its inputs. A job is
so a sequence of slices: the serve tier runs them in idle scheduler
slots and preempts the job at slice boundaries, never mid-iteration; a
slice journaled as "advance k from seq s" replays bit-equal, so a job
killed mid-run resumes from its last checkpoint and journal tail and
continues ``torch.equal`` to the uninterrupted run.

Engines are built from the parts the foreground solvers run:
:func:`~libskylark_tpu_torch.algorithms.krylov.lsqr_parts` and
``cg_parts``, :meth:`~libskylark_tpu_torch.ml.admm.BlockADMMSolver.
make_step` with its caches, and :meth:`~libskylark_tpu_torch.algorithms.
asynch._BlockSystem.sweep`. The reference jits a ``lax.while_loop`` per
slice; here the same loop runs eagerly, with the foreground solvers'
stopping test (ROADMAP C24).

Engine contract
===============

``init() -> state``           initial solver state (dict name -> host
                              ndarray, the iteration counter included)
``step(state, k) -> state``   advance ≤ k iterations (fewer only when
                              the convergence test fires); deterministic
``info(state) -> dict``       {"iterations", "residual", "converged"}
``result(state) -> dict``     the trained model: tensors on the engine's
                              device, scalars as Python numbers

State dicts hold **host numpy arrays**: they are what the registry
checkpoints and what :func:`encode_state` frames. An engine keeps its
operands, caches and factors on its device (the package default unless
``device=`` names one); a slice copies the state in, iterates, and
copies it out, exactly. :func:`encode_state` frames raw ``.npy`` records
(not ``np.savez``, whose zip members carry timestamps), byte-identical
to the reference's: either package decodes the other's bytes.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.precision import solver_precision

SOLVERS = ("admm_krr", "lsqr", "cg", "rand_gs")


# -- byte framing -------------------------------------------------------


def encode_state(state: Dict[str, np.ndarray]) -> bytes:
    """Deterministic bytes for a state dict: a key manifest + one raw
    ``.npy`` record per array, in sorted key order. Equal states encode
    to equal bytes."""
    out = io.BytesIO()
    keys = sorted(state)
    manifest = json.dumps(keys).encode("utf-8")
    out.write(struct.pack("<I", len(manifest)))
    out.write(manifest)
    for k in keys:
        arr = np.asarray(state[k])
        if arr.ndim and not arr.flags.c_contiguous:
            # not np.ascontiguousarray, which makes a 0-d array 1-d: the
            # shape must round-trip exactly
            arr = arr.copy(order="C")
        np.lib.format.write_array(out, arr, allow_pickle=False)
    return out.getvalue()


def decode_state(data: bytes) -> Dict[str, np.ndarray]:
    buf = io.BytesIO(data)
    (mlen,) = struct.unpack("<I", buf.read(4))
    keys = json.loads(buf.read(mlen).decode("utf-8"))
    return {k: np.lib.format.read_array(buf, allow_pickle=False)
            for k in keys}


def step_bytes(engine, state_bytes: bytes, k: int) -> bytes:
    """``step(state_bytes, k) -> state_bytes``, deterministic, so a
    replay is bit-equal."""
    return encode_state(engine.step(decode_state(state_bytes), int(k)))


# -- shared helpers -----------------------------------------------------


def _host(state) -> Dict[str, np.ndarray]:
    """A state of tensors (or numbers) as host arrays, bytes unchanged."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in state.items()}


def _operand(a, device) -> torch.Tensor:
    """A host operand on the engine's device, float64 as float32 (the
    reference's arrays with jax's 64-bit mode off)."""
    from libskylark_tpu_torch.io.streaming import compute_dtype
    from libskylark_tpu_torch.ml.coding import host_array

    a = np.ascontiguousarray(host_array(a))
    t = torch.from_numpy(a)
    if t.is_floating_point():
        t = t.to(compute_dtype(t.dtype))
    return t.to(device)


def _build_precond(kind, A, hyper, device):
    """Optional sketched right preconditioner of the Krylov engines: the
    Blendenpik or LSRN build of algorithms/regression.py, seeded from the
    job spec so a resume rebuilds the same operator."""
    if not kind:
        return None
    from libskylark_tpu_torch.algorithms import regression as _reg
    from libskylark_tpu_torch.base.context import Context

    params = _reg.AcceleratedParams(
        sketch_size_factor=float(hyper.get("sketch_size_factor", 4.0)),
        sketch=str(hyper.get("sketch", "jlt")),
    )
    ctx = Context(seed=int(hyper.get("seed", 0)))
    if kind == "blendenpik":
        precond, _ = _reg.build_blendenpik_precond(A, ctx, params,
                                                   device=device)
        return precond
    if kind == "lsrn":
        precond, _ = _reg.build_lsrn_precond(A, ctx, params, device=device)
        return precond
    raise errors.InvalidParametersError(
        f"unknown train preconditioner {kind!r} "
        "(expected 'blendenpik', 'lsrn', or none)")


class _KrylovEngine:
    """The LSQR/CG engines: the solver's ``*_parts`` body run while
    ``it < it0 + k`` and some column is not done, under the solver
    precision, as the foreground entry points run it."""

    solver = ""

    def _parts(self, A, B, params, precond):
        raise NotImplementedError

    def __init__(self, hyper: dict, operands: dict, device=None):
        from libskylark_tpu_torch.algorithms.krylov import KrylovParams
        from libskylark_tpu_torch.base.device import resolve_device

        if "A" not in operands or "B" not in operands:
            raise errors.InvalidParametersError(
                f"{self.solver} jobs need operands A and B")
        self.hyper = dict(hyper or {})
        self.device = resolve_device(device)
        A = _operand(operands["A"], self.device)
        B = _operand(operands["B"], self.device)
        params = KrylovParams(
            tolerance=float(self.hyper.get("tolerance", 1e-6)))
        # built under the solver precision, as the foreground entry point
        # computes its initial vectors: iterations 0..i are its bytes
        with solver_precision():
            precond = _build_precond(self.hyper.get("precond"), A,
                                     self.hyper, self.device)
            state0, self._body, self._meta = self._parts(A, B, params,
                                                         precond)
        self._state0 = dict(state0, it=np.int32(0))

    def init(self) -> Dict[str, np.ndarray]:
        return _host(self._state0)

    def _on_device(self, state) -> dict:
        dev = {k: torch.from_numpy(np.array(v)).to(self.device)
               for k, v in state.items() if k != "it"}
        dev["it"] = int(np.asarray(state["it"]))
        return dev

    def step(self, state: Dict[str, np.ndarray], k: int
             ) -> Dict[str, np.ndarray]:
        s = self._on_device(state)
        limit = s["it"] + int(k)
        with solver_precision():
            while s["it"] < limit and not bool(s["done"].all()):
                s = self._body(s)
        s["it"] = np.int32(s["it"])
        return _host(s)

    def _residual(self, state) -> float:
        if "nrm_r" in state:  # lsqr carries the residual norms
            return float(np.max(np.asarray(state["nrm_r"])))
        return float(np.max(np.sqrt(np.sum(
            np.asarray(state["R"]) ** 2, axis=0))))

    def info(self, state) -> dict:
        return {
            "iterations": int(np.asarray(state["it"])),
            "residual": self._residual(state),
            "converged": bool(np.all(np.asarray(state["done"]))),
        }

    def result(self, state) -> dict:
        X = torch.from_numpy(np.array(state["X"])).to(self.device)
        out = {"X": self._meta["extract"]({"X": X})}
        out.update(self.info(state))
        return out


class LsqrEngine(_KrylovEngine):
    solver = "lsqr"

    def _parts(self, A, B, params, precond):
        from libskylark_tpu_torch.algorithms import krylov

        return krylov.lsqr_parts(A, B, params=params, precond=precond,
                                 shape=tuple(A.shape))


class CgEngine(_KrylovEngine):
    solver = "cg"

    def _parts(self, A, B, params, precond):
        from libskylark_tpu_torch.algorithms import krylov

        return krylov.cg_parts(A, B, params=params, precond=precond)


class AdmmKrrEngine:
    """BlockADMM kernel-ridge training in slices: the ``build_caches``,
    ``init_carry`` and ``make_step`` parts that
    :meth:`BlockADMMSolver.train` composes, one iteration at a time, with
    its convergence test at the same point, so the sliced carry equals
    the uninterrupted run's at every iteration count."""

    solver = "admm_krr"
    _CARRY = ("Wbar", "O", "Obar", "nu", "mu", "mu_ij", "ZtObar_ij",
              "del_o")

    def __init__(self, hyper: dict, operands: dict, device=None):
        from libskylark_tpu_torch.algorithms import prox
        from libskylark_tpu_torch.base.context import Context
        from libskylark_tpu_torch.base.device import resolve_device
        from libskylark_tpu_torch.ml import kernels
        from libskylark_tpu_torch.ml.admm import BlockADMMSolver

        if "X" not in operands or "Y" not in operands:
            raise errors.InvalidParametersError(
                "admm_krr jobs need operands X and Y")
        h = dict(hyper or {})
        self.hyper = h
        self.device = resolve_device(device)
        X = _operand(operands["X"], self.device)
        Y = _operand(operands["Y"], self.device).reshape(-1)
        n, d = X.shape
        self._regression = bool(h.get("regression", True))
        if self._regression:
            k = 1
        else:
            k = int(h.get("num_targets") or int(Y.max()) + 1)
        kernel = kernels.Gaussian(d, float(h.get("sigma", 1.0)))
        solver = BlockADMMSolver.from_kernel(
            Context(seed=int(h.get("seed", 0))),
            prox.SquaredLoss(), prox.L2Regularizer(),
            float(h.get("lam", 1e-3)),
            int(h.get("num_features", 64)),
            kernel,
            num_partitions=int(h.get("num_partitions", 1)),
        )
        solver.rho = float(h.get("rho", 1.0))
        solver.tol = float(h.get("tol", 1e-6))
        self._solver = solver
        self._X, self._Y = X, Y
        self._n, self._k, self._dt = n, k, X.dtype
        # the factors are a deterministic function of (operands, hyper):
        # a resume rebuilds the same bytes. Built under the solver
        # precision, as train() builds them
        with solver_precision():
            self._cache_mats, lowers, self._Zs = solver.build_caches(
                X, X.dtype)
        self._step = solver.make_step(n, k, X.dtype, lowers)

    def init(self) -> Dict[str, np.ndarray]:
        carry = self._solver.init_carry(self._n, self._k, self._dt,
                                        self.device)
        state = _host(dict(zip(self._CARRY, carry)))
        state["it"] = np.int64(0)
        state["reldel"] = np.asarray(np.inf, np.float64)
        state["objective"] = np.asarray(np.inf, np.float64)
        state["done"] = np.asarray(False)
        return state

    def step(self, state: Dict[str, np.ndarray], k: int
             ) -> Dict[str, np.ndarray]:
        carry = tuple(torch.from_numpy(np.array(state[name])).to(
            self.device) for name in self._CARRY)
        it = int(np.asarray(state["it"]))
        reldel = float(np.asarray(state["reldel"]))
        objective = float(np.asarray(state["objective"]))
        done = bool(np.asarray(state["done"]))
        tol = self._solver.tol
        with solver_precision():
            for _ in range(int(k)):
                if done:
                    break
                carry, (obj, rd) = self._step(
                    carry, self._X, self._Y, self._cache_mats, self._Zs)
                it += 1
                reldel = float(rd)
                objective = float(obj)
                # the foreground loop's convergence test
                if tol > 0 and it > 1 and reldel <= tol:
                    done = True
        out = _host(dict(zip(self._CARRY, carry)))
        out["it"] = np.int64(it)
        out["reldel"] = np.asarray(reldel, np.float64)
        out["objective"] = np.asarray(objective, np.float64)
        out["done"] = np.asarray(done)
        return out

    def info(self, state) -> dict:
        return {
            "iterations": int(np.asarray(state["it"])),
            "residual": float(np.asarray(state["reldel"])),
            "converged": bool(np.asarray(state["done"])),
        }

    def result(self, state) -> dict:
        out = {"coef": torch.from_numpy(np.array(state["Wbar"])).to(
                   self.device),
               "objective": float(np.asarray(state["objective"]))}
        out.update(self.info(state))
        return out

    def model(self, state):
        """The trained :class:`HilbertModel`, ready to predict."""
        from libskylark_tpu_torch.ml.model import HilbertModel

        m = HilbertModel(self._solver.feature_maps,
                         self._solver.scale_maps,
                         self._solver.num_features, self._k,
                         self._regression,
                         input_size=self._X.shape[1], device=self.device)
        m.coef = torch.from_numpy(np.array(state["Wbar"])).to(self.device)
        return m


class RandGsEngine:
    """Randomized block Gauss-Seidel in slices: one iteration is one
    sweep, keyed by ``fold_in(key, sweeps_done)`` as
    :func:`~libskylark_tpu_torch.algorithms.asynch.rand_block_gauss_seidel`
    keys its sweeps, so a resumed job draws the same block orders."""

    solver = "rand_gs"

    def __init__(self, hyper: dict, operands: dict, device=None):
        from libskylark_tpu_torch.algorithms.asynch import _BlockSystem
        from libskylark_tpu_torch.base.context import Context
        from libskylark_tpu_torch.base.device import resolve_device

        if "A" not in operands or "B" not in operands:
            raise errors.InvalidParametersError(
                "rand_gs jobs need operands A and B")
        h = dict(hyper or {})
        self.hyper = h
        self.device = resolve_device(device)
        A = _operand(operands["A"], self.device)
        B = _operand(operands["B"], self.device)
        self._squeeze = B.ndim == 1
        if self._squeeze:
            B = B[:, None]
        self._tol = float(h.get("tolerance", 1e-6))
        self._sys = _BlockSystem(A, int(h.get("block_size", 64)),
                                 self.device)
        self._key = Context(seed=int(h.get("seed", 0))).allocate().key
        self._B_p = self._sys.pad_cols(B)
        self._nrm_b = torch.clamp_min(torch.linalg.norm(self._B_p),
                                      torch.finfo(B.dtype).eps)
        self._B_shape = tuple(B.shape)

    # not under the solver precision: the foreground
    # rand_block_gauss_seidel runs its sweeps at the ambient precision

    def init(self) -> Dict[str, np.ndarray]:
        n, k = self._B_shape
        X = self._sys.pad_cols(torch.zeros((n, k), dtype=self._B_p.dtype,
                                           device=self.device))
        return {"X": X.cpu().numpy(), "it": np.int64(0),
                "res": np.asarray(np.inf, np.float64),
                "done": np.asarray(False)}

    def step(self, state: Dict[str, np.ndarray], k: int
             ) -> Dict[str, np.ndarray]:
        from libskylark_tpu_torch.base.context import fold_in

        X = torch.from_numpy(np.array(state["X"])).to(self.device)
        it = int(np.asarray(state["it"]))
        done = bool(np.asarray(state["done"]))
        res = float(np.asarray(state["res"]))
        for _ in range(int(k)):
            if done:
                break
            X = self._sys.sweep(X, self._B_p, fold_in(self._key, it))
            it += 1
            res = float(torch.linalg.norm(self._B_p - self._sys.A_p @ X)
                        / self._nrm_b)
            done = res <= self._tol
        return {"X": X.cpu().numpy(), "it": np.int64(it),
                "res": np.asarray(res, np.float64),
                "done": np.asarray(done)}

    def info(self, state) -> dict:
        return {
            "iterations": int(np.asarray(state["it"])),
            "residual": float(np.asarray(state["res"])),
            "converged": bool(np.asarray(state["done"])),
        }

    def result(self, state) -> dict:
        X = torch.from_numpy(np.array(state["X"])[:self._sys.n, :]).to(
            self.device)
        out = {"X": X[:, 0] if self._squeeze else X}
        out.update(self.info(state))
        return out


_ENGINES = {
    "admm_krr": AdmmKrrEngine,
    "lsqr": LsqrEngine,
    "cg": CgEngine,
    "rand_gs": RandGsEngine,
}


def make_engine(solver: str, hyper: dict, operands: dict, device=None):
    """Engine factory keyed by :data:`SOLVERS` name, its operands and
    work on ``device`` (default: the package default)."""
    cls = _ENGINES.get(solver)
    if cls is None:
        raise errors.InvalidParametersError(
            f"unknown train solver {solver!r}; expected one of "
            f"{SOLVERS}")
    return cls(hyper, operands, device=device)


__all__ = [
    "SOLVERS", "make_engine", "encode_state", "decode_state",
    "step_bytes", "AdmmKrrEngine", "LsqrEngine", "CgEngine",
    "RandGsEngine",
]
