"""The port's LSQR, preconditioners, accelerated solvers and least squares
against the JAX package, on the CPU.

Both packages get the same float32 inputs (numpy, seeded) and the same
Context seed, so they sketch with the same operator and iterate the same
recurrence; what is left is float32 rounding. The operand is well
conditioned (κ = 10), where that rounding moves a solution far less than
the bound. Bounds: solutions relative (2-norm) ≤ 1e-4, and LSQR
iteration counts within 1 of the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import nla as jnla
from libskylark_tpu.algorithms import krylov as jkrylov
from libskylark_tpu.algorithms import precond as jprecond
from libskylark_tpu.algorithms import regression as jregression
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import algorithms, nla
from libskylark_tpu_torch.algorithms import krylov, precond
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context

SOLVE_REL = 1e-4
M, N = 2048, 32


def _problem(k=None, kappa=10.0, seed=0):
    """A (M, N) with singular values spread over [1/κ, 1], and B = A·x +
    noise with k columns (a vector when k is None)."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((M, N)))[0]
    V = np.linalg.qr(rng.standard_normal((N, N)))[0]
    A = (U * np.logspace(0, -np.log10(kappa), N)) @ V.T
    shape = (N,) if k is None else (N, k)
    B = A @ rng.standard_normal(shape) + 1e-3 * rng.standard_normal(
        (M,) + shape[1:])
    return A.astype(np.float32), B.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _preconds(A):
    R = np.linalg.qr(A, mode="r").astype(np.float32)
    M2 = (2.0 * np.eye(N)).astype(np.float32)
    return {
        "id": (None, None),
        "mat": (jprecond.MatPrecond(jnp.asarray(M2)),
                precond.MatPrecond(torch.from_numpy(M2))),
        "tri": (jprecond.TriInversePrecond(jnp.asarray(R)),
                precond.TriInversePrecond(torch.from_numpy(R))),
        "function": (jprecond.FunctionPrecond(lambda X: 0.5 * X),
                     precond.FunctionPrecond(lambda X: 0.5 * X)),
    }


@pytest.mark.parametrize("name", ["id", "mat", "tri", "function"])
@pytest.mark.parametrize("k", [None, 3])
def test_lsqr_matches_reference(name, k):
    A, B = _problem(k)
    jp, p = _preconds(A)[name]
    kw = {"tolerance": 1e-6, "iter_lim": 300}
    want, jit = jkrylov.lsqr(jnp.asarray(A), jnp.asarray(B),
                             jkrylov.KrylovParams(**kw), jp)
    got, it = krylov.lsqr(A, B, krylov.KrylovParams(**kw), p, device="cpu")
    assert got.shape == tuple(np.shape(want))
    assert _rel(got, want) <= SOLVE_REL
    assert abs(it - int(jit)) <= 1


def test_lsqr_operator_pair_needs_a_shape():
    A, B = _problem()
    At = torch.from_numpy(A)
    pair = (lambda x: At @ x, lambda x: At.T @ x)
    with pytest.raises(ValueError):
        krylov.lsqr(pair, B, device="cpu")
    got, _ = krylov.lsqr(pair, B, shape=(M, N), device="cpu")
    want, _ = krylov.lsqr(A, B, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_lsqr_stops_at_the_iteration_limit():
    A, B = _problem()
    _, it = krylov.lsqr(A, B, krylov.KrylovParams(tolerance=1e-12,
                                                  iter_lim=5), device="cpu")
    assert it == 5


@pytest.mark.parametrize("method", ["blendenpik", "simplified_blendenpik",
                                    "lsrn"])
@pytest.mark.parametrize("fallback", [False, True])
def test_solve_l2_accelerated_matches_reference(method, fallback):
    A, B = _problem(seed=1)
    kw = {"cond_threshold": 1.0} if fallback else {}
    want, jit = jregression.solve_l2_accelerated(
        jnp.asarray(A), jnp.asarray(B), JContext(3), method=method,
        params=jregression.AcceleratedParams(**kw))
    got, it = algorithms.solve_l2_accelerated(
        A, B, Context(3), method=method,
        params=algorithms.AcceleratedParams(**kw), device="cpu")
    assert _rel(got, want) <= SOLVE_REL
    assert abs(it - int(jit)) <= 1
    assert (it == 0) == fallback


@pytest.mark.parametrize("sketch", ["fjlt", "cwt", "jlt"])
@pytest.mark.parametrize("k", [None, 2])
def test_approximate_least_squares_matches_reference(sketch, k):
    A, B = _problem(k, seed=2)
    want = jnla.approximate_least_squares(jnp.asarray(A), jnp.asarray(B),
                                          JContext(4), sketch=sketch)
    got = nla.approximate_least_squares(A, B, Context(4), sketch=sketch,
                                        device="cpu")
    assert got.shape == tuple(np.shape(want))
    assert _rel(got, want) <= SOLVE_REL


def test_fast_least_squares_matches_reference():
    A, B = _problem(seed=3)
    want, jit = jnla.fast_least_squares(jnp.asarray(A), jnp.asarray(B),
                                        JContext(5))
    got, it = nla.fast_least_squares(A, B, Context(5), device="cpu")
    assert _rel(got, want) <= SOLVE_REL
    assert abs(it - int(jit)) <= 1 and it > 0


@pytest.mark.parametrize("sketch", ["fjlt", "cwt"])
def test_sketch_and_solve_residual_is_near_optimal(sketch):
    """The chip smoke's check at a scaled size: the sketch-and-solve
    residual within 1.5× of the exact one (s = 4n)."""
    rng = np.random.default_rng(6)
    A = rng.standard_normal((4096, 64)).astype(np.float32)
    b = (A @ rng.standard_normal(64) + 0.1 * rng.standard_normal(4096)
         ).astype(np.float32)
    x = nla.approximate_least_squares(A, b, Context(7), sketch=sketch,
                                      device="cpu").numpy()
    x_ls = np.linalg.lstsq(A.astype(np.float64), b, rcond=None)[0]
    ratio = np.linalg.norm(A @ x - b) / np.linalg.norm(A @ x_ls - b)
    assert ratio <= 1.5


def test_accelerated_solve_reaches_the_exact_residual():
    """The chip smoke's check at a scaled size: singular values over
    [1e-3, 1], residual within (1 + 1e-3)× lstsq's."""
    A, b = _problem(kappa=1e3, seed=8)
    x_ls = np.linalg.lstsq(A.astype(np.float64), b, rcond=None)[0]
    best = np.linalg.norm(A @ x_ls - b)
    for method in ("blendenpik", "simplified_blendenpik", "lsrn"):
        x, it = algorithms.solve_l2_accelerated(A, b, Context(9),
                                                method=method, device="cpu")
        assert 0 < it < 2 * N
        assert np.linalg.norm(A @ x.numpy() - b) <= (1 + 1e-3) * best


def test_unknown_accelerated_method_raises():
    with pytest.raises(errors.InvalidParametersError):
        algorithms.solve_l2_accelerated(np.ones((8, 2), np.float32),
                                        np.ones(8, np.float32), Context(0),
                                        method="qr", device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        algorithms.solve_l2_accelerated(
            np.ones((8, 2), np.float32), np.ones(8, np.float32), Context(0),
            params=algorithms.AcceleratedParams(sketch="gauss"),
            device="cpu")


def test_accelerated_allocates_one_transform():
    A, B = _problem()
    ctx = Context(1)
    algorithms.solve_l2_accelerated(A, B, ctx, device="cpu")
    assert ctx.counter == 1


def test_params_json_round_trip_with_reference():
    p = algorithms.AcceleratedParams(tolerance=1e-8, sketch="cwt")
    jp = jregression.AcceleratedParams.from_json(p.to_json())
    assert jp.to_dict() == p.to_dict()
    k = krylov.KrylovParams(tolerance=1e-3, iter_lim=9)
    assert jkrylov.KrylovParams.from_json(k.to_json()).to_dict() == k.to_dict()
