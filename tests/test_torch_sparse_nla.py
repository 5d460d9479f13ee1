"""Sparse operands through the port's NLA, solvers, serve program and Gram
matrices, against the JAX package on the same seeds, on the CPU.

- ``approximate_svd`` (tall and wide), ``power_iteration`` and
  ``approximate_symmetric_svd`` of a ``SparseMatrix``, never densified:
  the reconstruction U·diag(S)·Vᵀ (sign-free) and S within 1e-4 ·
  max|reference| of the reference's sparse run. Its ``dtype`` override
  raises for a sparse operand, as there.
- LSQR, Blendenpik (and its simplified form) and LSRN on a
  ``SparseMatrix``: the reference's own sparse solver limits
  (tests/test_sparse_solvers.py), atol = rtol = 1e-3 against the
  reference and the relative error to the planted solution < 1e-3. The
  reference's sparse LSQR does not run on the installed JAX (ROADMAP C7),
  so the reference runs on the densified operand, with the CWT sketch its
  sparse path would take.
- Sketch-and-solve (``approximate_least_squares``, default CWT for a
  sparse operand, and JLT) against the reference's sparse run within
  atol = rtol = 1e-4, the reference's own limit; ``sparse_solve_serve``
  (CWT and JLT) within 1e-4 · max|reference|, and against the port's
  ``solve_l2_sketched`` on the same key.
- The linear and polynomial Gram matrices of sparse operands (O(nnz)
  through spmm) and a distance-based one (densified) within 1e-4 ·
  max|reference|.
- The SVD's accuracy limit of the chip run (σ within 1e-3) needs a
  spectral gap: on an unweighted random sparse operand the q = 2 sketch
  misses it by far, with weighted documents it meets it — why
  chip_smoke.py weights its SVD operand (SVD_WEIGHT).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu import nla as jnla
from libskylark_tpu import sketch as jsk
from libskylark_tpu.algorithms import krylov as jkrylov
from libskylark_tpu.algorithms import regression as jregression
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.base.sparse import SparseMatrix as JSparse
from libskylark_tpu.sketch import sparse_serve as jsparse_serve
from libskylark_tpu_torch import algorithms, ml, nla
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors, sprand
from libskylark_tpu_torch.base import sparse as bs
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import SparseMatrix
from libskylark_tpu_torch.sketch import sparse_serve

ORACLE = 1e-4
SOLVER = 1e-3  # tests/test_sparse_solvers.py


def _operand(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, format="csc", dtype=np.float32,
                     random_state=seed,
                     data_rvs=lambda k: rng.standard_normal(k))


def _close(got, want, tol=ORACLE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture()
def problem():
    """tests/test_sparse_solvers.py's problem: a well-conditioned sparse A
    with a planted dense solution."""
    rng = np.random.default_rng(0)
    m, n = 300, 24
    dense = (rng.standard_normal((m, n))
             * (rng.uniform(size=(m, n)) < 0.4)).astype(np.float32)
    dense += 0.1 * rng.standard_normal((m, n)).astype(np.float32)
    x_true = rng.standard_normal(n).astype(np.float32)
    return sp.csc_matrix(dense), dense, dense @ x_true, x_true


@pytest.mark.parametrize("shape", [(400, 150), (150, 400)])
def test_approximate_svd_matches_the_reference(shape):
    M = _operand(*shape, 0.05, 3)
    params = nla.ApproximateSVDParams(num_iterations=2)
    jparams = jnla.ApproximateSVDParams(num_iterations=2)
    bs.conversions["todense"] = 0
    U, S, V = nla.approximate_svd(SparseMatrix.from_scipy(M), 10, Context(3),
                                  params, device="cpu")
    assert bs.conversions["todense"] == 0
    jU, jS, jV = jnla.approximate_svd(JSparse.from_scipy(M), 10,
                                      JContext(3), jparams)
    assert U.shape == (shape[0], 10) and V.shape == (shape[1], 10)
    _close(S.numpy(), jS)
    _close((U * S) @ V.T, (np.asarray(jU) * np.asarray(jS)) @ np.asarray(jV).T)


def test_dtype_override_raises_for_a_sparse_operand():
    A = SparseMatrix.from_scipy(_operand(40, 30, 0.2, 1))
    with pytest.raises(errors.InvalidParametersError):
        nla.approximate_svd(A, 4, Context(0), dtype=torch.float64,
                            device="cpu")


@pytest.mark.parametrize("adjoint", [False, True])
def test_power_iteration_matches_the_reference(adjoint):
    M = _operand(200, 90, 0.05, 4)
    rng = np.random.default_rng(4)
    Q = rng.standard_normal(((90 if adjoint else 200), 8)).astype(np.float32)
    got = nla.power_iteration(SparseMatrix.from_scipy(M), torch.from_numpy(Q),
                              3, adjoint=adjoint)
    want = jnla.power_iteration(JSparse.from_scipy(M), jnp.asarray(Q), 3,
                                adjoint=adjoint)
    _close(got.numpy() @ got.numpy().T,
           np.asarray(want) @ np.asarray(want).T)


def test_symmetric_svd_matches_the_reference():
    M = _operand(300, 300, 0.02, 5)
    M = (M + M.T).tocsc()
    V, S = nla.approximate_symmetric_svd(SparseMatrix.from_scipy(M), 8,
                                         Context(5), device="cpu")
    jV, jS = jnla.approximate_symmetric_svd(JSparse.from_scipy(M), 8,
                                            JContext(5))
    _close(S.numpy(), jS)
    _close((V * S) @ V.T, (np.asarray(jV) * np.asarray(jS)) @ np.asarray(jV).T)


def test_lsqr_matches_the_reference(problem):
    M, dense, b, x_true = problem
    kp = algorithms.KrylovParams(tolerance=1e-8, iter_lim=500)
    x, it = algorithms.lsqr(SparseMatrix.from_scipy(M), b, kp, device="cpu")
    jx, jit = jkrylov.lsqr(jnp.asarray(dense), jnp.asarray(b),
                           jkrylov.KrylovParams(tolerance=1e-8, iter_lim=500))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=SOLVER,
                               rtol=SOLVER)
    assert abs(it - int(jit)) <= 1


@pytest.mark.parametrize("method", ["blendenpik", "simplified_blendenpik",
                                    "lsrn"])
def test_accelerated_solvers_match_the_reference(problem, method):
    M, dense, b, x_true = problem
    A = SparseMatrix.from_scipy(M)
    bs.conversions["todense"] = 0
    x, it = algorithms.solve_l2_accelerated(A, b, Context(3), method=method,
                                            device="cpu")
    assert bs.conversions["todense"] == 0 and it > 0
    jx, jit = jregression.solve_l2_accelerated(
        jnp.asarray(dense), jnp.asarray(b), JContext(3), method=method,
        params=jregression.AcceleratedParams(sketch="cwt"))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=SOLVER,
                               rtol=SOLVER)
    rel = np.linalg.norm(x.numpy() - x_true) / np.linalg.norm(x_true)
    assert rel < SOLVER
    assert abs(it - int(jit)) <= 1


def test_fast_least_squares_on_a_sparse_operand(problem):
    M, dense, b, x_true = problem
    x, it = nla.fast_least_squares(SparseMatrix.from_scipy(M), b,
                                   Context(3), device="cpu")
    rel = np.linalg.norm(x.numpy() - x_true) / np.linalg.norm(x_true)
    assert rel < SOLVER and it > 0


def test_exact_fallback_densifies(problem):
    M, dense, b, x_true = problem
    params = algorithms.AcceleratedParams(cond_threshold=0.5)
    bs.conversions["todense"] = 0
    x, it = algorithms.solve_l2_accelerated(SparseMatrix.from_scipy(M), b,
                                            Context(3), params=params,
                                            device="cpu")
    assert it == 0 and bs.conversions["todense"] == 1
    jx = jregression.solve_l2_exact(jnp.asarray(dense), jnp.asarray(b),
                                    method="svd")
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=SOLVER,
                               rtol=SOLVER)


@pytest.mark.parametrize("sketch", [None, "jlt"])
def test_sketch_and_solve_matches_the_reference(problem, sketch):
    M, dense, b, x_true = problem
    kw = {"sketch": sketch} if sketch else {}
    x = nla.approximate_least_squares(SparseMatrix.from_scipy(M), b,
                                      Context(4), device="cpu", **kw)
    jx = jnla.approximate_least_squares(JSparse.from_scipy(M),
                                        jnp.asarray(b), JContext(4), **kw)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=ORACLE,
                               rtol=ORACLE)


@pytest.mark.parametrize("sketch_type,s_dim", [("CWT", 600), ("JLT", 400)])
def test_sparse_solve_serve_matches_the_reference(sketch_type, s_dim):
    rng = np.random.default_rng(5)
    A = SparseMatrix.from_scipy(_operand(800, 150, 0.05, 3))
    B = rng.standard_normal((800, 2)).astype(np.float32)
    d, i, p = A.csr_parts()
    T = getattr(sk, sketch_type)(800, s_dim, Context(9))
    jT = getattr(jsk, sketch_type)(800, s_dim, JContext(9))
    scale = getattr(T, "scale", 1.0)
    got = sparse_serve.sparse_solve_serve(
        T.allocation.key, scale, torch.tensor(d), torch.tensor(i),
        torch.tensor(p), torch.from_numpy(B), sketch_type=sketch_type,
        s_dim=s_dim, method="qr", shape=(800, 150))
    want = jsparse_serve.sparse_solve_serve(
        jax.random.key_data(jT.allocation.key), scale, jnp.asarray(d),
        jnp.asarray(i), jnp.asarray(p), jnp.asarray(B),
        sketch_type=sketch_type, s_dim=s_dim, method="qr", shape=(800, 150))
    _close(got.numpy(), want)
    own = algorithms.solve_l2_sketched(A, torch.from_numpy(B), T,
                                       device="cpu")
    _close(got.numpy(), own.numpy())
    with pytest.raises(errors.InvalidParametersError):
        sparse_serve.sparse_solve_serve(
            T.allocation.key, scale, torch.tensor(d), torch.tensor(i),
            torch.tensor(p), torch.from_numpy(B), sketch_type="CT",
            s_dim=s_dim, method="qr", shape=(800, 150))


@pytest.mark.parametrize("kernel,kw", [("Linear", {}),
                                       ("Polynomial", {"q": 3, "c": 0.5}),
                                       ("Gaussian", {"sigma": 2.0}),
                                       ("Laplacian", {"sigma": 3.0})])
def test_sparse_gram_matches_the_reference(kernel, kw):
    X = sp.random(30, 150, density=0.1, random_state=4, format="csc",
                  dtype=np.float32)
    Y = sp.random(20, 150, density=0.1, random_state=5, format="csc",
                  dtype=np.float32)
    k, jk = getattr(ml, kernel)(150, **kw), getattr(jml, kernel)(150, **kw)
    Xs, Ys = SparseMatrix.from_scipy(X), SparseMatrix.from_scipy(Y)
    jXs, jYs = JSparse.from_scipy(X), JSparse.from_scipy(Y)
    bs.conversions["todense"] = 0
    pairs = [(k.gram(Xs, Ys, device="cpu"), jk.gram(jXs, jYs)),
             (k.gram(Xs, None, device="cpu"), jk.gram(jXs)),
             (k.gram(Y.toarray(), Xs, device="cpu"),
              jk.gram(Y.toarray(), jXs)),
             (k.gram(Xs, Y.toarray(), device="cpu"),
              jk.gram(jXs, Y.toarray()))]
    for got, want in pairs:
        _close(got.numpy(), want)
    if kernel in ("Linear", "Polynomial"):
        # O(nnz): only a sparse Y beside a sparse X is densified
        assert bs.conversions["todense"] == 2


def _svd_sigma_err(weight: float) -> float:
    m, n, k = 1000, 2400, 64
    A = sprand.sample(m, n, 0.01, (0.25, 0.5, 1.0), (1, 1, 1), Context(3),
                      device="cpu")
    d = 1.0 + weight * 0.97 ** np.arange(m)
    W = SparseMatrix.from_scipy(sp.diags(d) @ A.to_scipy())
    sigma = np.linalg.svd(W.to_scipy().toarray().astype(np.float64),
                          compute_uv=False)[:k]
    _, S, _ = nla.approximate_svd(W, k, Context(4),
                                  nla.ApproximateSVDParams(num_iterations=2),
                                  device="cpu")
    return float(np.max(np.abs(S.double().numpy() - sigma) / sigma))


def test_the_svd_limit_needs_a_spectral_gap():
    assert _svd_sigma_err(0.0) > 1e-2       # flat past σ1: about 0.05
    assert _svd_sigma_err(30.0) < 1e-3      # chip_smoke.py's weights
