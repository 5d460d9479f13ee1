"""The port's randomized SVD, CholeskyQR2 and least squares against the
JAX package, on the CPU.

Both packages get the same float32 inputs (numpy, seeded) and the same
Context seed, so they sketch with the same operator; what is left is
float32 rounding. Bounds: singular values relative ≤ 1e-4, top-k singular
vectors |cos θ| ≥ 1 − 1e-4 (sign-invariant), solutions relative ≤ 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import nla as jnla
from libskylark_tpu.algorithms import regression as jregression
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import algorithms, nla
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.nla import tsqr

SIGMA_REL = 1e-4
COS_TOL = 1e-4
SOLVE_REL = 1e-4
RANK = 8


def _decaying(m, n, seed=0):
    """A with singular values 0.7^i and random singular vectors."""
    rng = np.random.default_rng(seed)
    r = min(m, n)
    U = np.linalg.qr(rng.standard_normal((m, r)))[0]
    V = np.linalg.qr(rng.standard_normal((n, r)))[0]
    sigma = 0.7 ** np.arange(r)
    return ((U * sigma) @ V.T).astype(np.float32)


def _cos_ok(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = np.abs(np.sum(got * want, axis=0)) / (
        np.linalg.norm(got, axis=0) * np.linalg.norm(want, axis=0))
    assert cos.min() >= 1 - COS_TOL, cos


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("shape", [(256, 192), (192, 256)])
@pytest.mark.parametrize("ortho,rr", [("cqr2", "cqr2"), ("qr", "svd")])
def test_approximate_svd_matches_reference(shape, ortho, rr):
    A = _decaying(*shape)
    jp = jnla.ApproximateSVDParams(num_iterations=2, ortho=ortho, rr=rr)
    p = nla.ApproximateSVDParams(num_iterations=2, ortho=ortho, rr=rr)
    jU, jS, jV = jnla.approximate_svd(jnp.asarray(A, jnp.float32), RANK,
                                      JContext(21), jp)
    U, S, V = nla.approximate_svd(A, RANK, Context(21), p, device="cpu")
    assert U.shape == (shape[0], RANK) and V.shape == (shape[1], RANK)
    assert S.shape == (RANK,) and S.dtype == torch.float32
    jS = np.asarray(jS)
    assert np.max(np.abs(S.numpy() - jS) / jS) <= SIGMA_REL
    _cos_ok(U, jU)
    _cos_ok(V, jV)


def test_approximate_svd_finds_the_spectrum():
    A = _decaying(256, 192, seed=1)
    U, S, V = nla.approximate_svd(A, RANK, Context(2),
                                  nla.ApproximateSVDParams(num_iterations=2),
                                  device="cpu")
    want = 0.7 ** np.arange(RANK)
    assert np.max(np.abs(S.numpy() - want) / want) <= 1e-3
    assert _rel(U.T @ U, np.eye(RANK)) <= 1e-5
    assert _rel(V.T @ V, np.eye(RANK)) <= 1e-5


def test_approximate_symmetric_svd_matches_reference():
    rng = np.random.default_rng(4)
    Q = np.linalg.qr(rng.standard_normal((192, 192)))[0]
    w = 0.7 ** np.arange(192) * np.where(np.arange(192) % 3 == 1, -1, 1)
    A = ((Q * w) @ Q.T).astype(np.float32)
    A = (A + A.T) / 2
    params = dict(num_iterations=2)
    jV, jS = jnla.approximate_symmetric_svd(
        jnp.asarray(A, jnp.float32), RANK, JContext(5),
        jnla.ApproximateSVDParams(**params))
    V, S = nla.approximate_symmetric_svd(
        A, RANK, Context(5), nla.ApproximateSVDParams(**params),
        device="cpu")
    jS = np.asarray(jS)
    assert np.max(np.abs(S.numpy() - jS) / np.abs(jS)) <= SIGMA_REL
    _cos_ok(V, jV)


def test_cholesky_qr2_is_orthonormal_and_factors():
    rng = np.random.default_rng(6)
    A = torch.from_numpy(
        (rng.standard_normal((256, 16)) * np.logspace(0, 3, 16)).astype(
            np.float32))
    Q, R = tsqr.cholesky_qr2(A)
    eye = torch.eye(16)
    assert float(torch.linalg.norm(Q.T @ Q - eye)) <= 1e-5
    assert float(torch.linalg.norm(Q @ R - A) / torch.linalg.norm(A)) <= 1e-6
    assert torch.equal(R, torch.triu(R))


@pytest.mark.parametrize("method", ["qr", "sne", "ne", "svd"])
@pytest.mark.parametrize("vector", [True, False])
def test_solve_l2_exact_matches_reference(method, vector):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((256, 12)).astype(np.float32)
    B = rng.standard_normal((256,) if vector else (256, 3)).astype(
        np.float32)
    want = jregression.solve_l2_exact(jnp.asarray(A, jnp.float32),
                                      jnp.asarray(B, jnp.float32),
                                      method=method)
    got = algorithms.solve_l2_exact(A, B, method=method, device="cpu")
    assert got.shape == tuple(np.shape(want))
    assert _rel(got, want) <= SOLVE_REL


@pytest.mark.parametrize("vector", [True, False])
def test_approximate_least_squares_jlt_matches_reference(vector):
    rng = np.random.default_rng(8)
    A = rng.standard_normal((512, 10)).astype(np.float32)
    x = rng.standard_normal((10,) if vector else (10, 2))
    B = (A @ x + 0.1 * rng.standard_normal(
        (512,) if vector else (512, 2))).astype(np.float32)
    want = jnla.approximate_least_squares(
        jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32),
        JContext(9), sketch="jlt")
    got = nla.approximate_least_squares(A, B, Context(9), sketch="jlt",
                                        device="cpu")
    assert got.shape == tuple(np.shape(want))
    assert _rel(got, want) <= SOLVE_REL


def test_solve_l2_sketched_consumes_one_allocation():
    ctx = Context(3)
    nla.approximate_least_squares(
        np.eye(64, 4, dtype=np.float32), np.ones(64, np.float32), ctx,
        sketch="jlt", device="cpu")
    assert ctx.counter == 1


@pytest.mark.parametrize("sketch,error", [
    ("fjlt", errors.NotImplementedYetError),
    ("cwt", errors.NotImplementedYetError),
    ("gauss", errors.InvalidParametersError),
])
def test_unported_sketches_raise(sketch, error):
    A = np.ones((64, 4), np.float32)
    with pytest.raises(error):
        nla.approximate_least_squares(A, A[:, 0], Context(0), sketch=sketch,
                                      device="cpu")


def test_bad_svd_params_raise():
    with pytest.raises(errors.InvalidParametersError):
        nla.approximate_svd(np.ones((8, 8), np.float32), 2, Context(0),
                            nla.ApproximateSVDParams(ortho="lu"),
                            device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        nla.approximate_svd(np.ones((8, 8), np.float32), 0, Context(0),
                            device="cpu")


def test_svd_params_json_round_trip_with_reference():
    p = nla.ApproximateSVDParams(num_iterations=3, ortho="qr")
    jp = jnla.ApproximateSVDParams.from_json(p.to_json())
    assert jp.to_dict() == p.to_dict()
    assert nla.ApproximateSVDParams.from_json(jp.to_json()) == p
