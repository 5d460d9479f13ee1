"""The port's CG, flexible CG and Chebyshev semi-iteration against the JAX
package, on the CPU.

Both packages get the same float32 SPD operand (numpy, seeded, spectrum
spread evenly over [1, κ = 20]) and right-hand sides, and iterate the same
recurrence; what is left is float32 rounding. Bounds: the same iteration
count as the reference, and solutions within 1e-4 relative (2-norm).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.algorithms import krylov as jkrylov
from libskylark_tpu.algorithms import precond as jprecond
from libskylark_tpu_torch import algorithms
from libskylark_tpu_torch.algorithms import krylov, precond

SOLVE_REL = 1e-4
N = 96
KAPPA = 20.0


def _spd(k=None, seed=0):
    """A (N, N) SPD with eigenvalues over [1, κ], and B with k columns (a
    vector when k is None)."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((N, N)))[0]
    A = (Q * np.linspace(1.0, KAPPA, N)) @ Q.T
    B = rng.standard_normal((N,) if k is None else (N, k))
    return A.astype(np.float32), B.astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _preconds():
    D = np.linspace(1.0, 2.0, N).astype(np.float32)
    M = np.diag(1.0 / D).astype(np.float32)
    return {
        "none": (None, None),
        "mat": (jprecond.MatPrecond(jnp.asarray(M)),
                precond.MatPrecond(torch.from_numpy(M))),
        "function": (jprecond.FunctionPrecond(lambda X: 0.5 * X),
                     precond.FunctionPrecond(lambda X: 0.5 * X)),
    }


def _params(mod, tol=1e-6, iter_lim=400):
    return mod.KrylovParams(tolerance=tol, iter_lim=iter_lim)


@pytest.mark.parametrize("name", ["none", "mat", "function"])
@pytest.mark.parametrize("k", [None, 3])
def test_cg_matches_reference(name, k):
    A, B = _spd(k)
    jp, p = _preconds()[name]
    want, jit = jkrylov.cg(jnp.asarray(A), jnp.asarray(B),
                           _params(jkrylov), jp)
    got, it = krylov.cg(A, B, _params(krylov), p, device="cpu")
    assert got.shape == tuple(np.shape(want))
    assert it == int(jit) > 0
    assert _rel(got, want) <= SOLVE_REL


def test_cg_from_a_start_and_on_an_operator_pair():
    A, B = _spd(2, seed=1)
    X0 = (0.1 * np.ones((N, 2))).astype(np.float32)
    want, jit = jkrylov.cg(jnp.asarray(A), jnp.asarray(B), _params(jkrylov),
                           X0=jnp.asarray(X0))
    At = torch.from_numpy(A)
    pair = (lambda x: At @ x, lambda x: At.T @ x)
    got, it = krylov.cg(pair, torch.from_numpy(B), _params(krylov),
                        X0=X0, device="cpu")
    assert it == int(jit)
    assert _rel(got, want) <= SOLVE_REL


def test_cg_parts_iterate_as_cg():
    A, B = _spd(2, seed=2)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    state, body, meta = krylov.cg_parts(At, Bt, _params(krylov))
    for _ in range(5):
        state = body(state)
    got, _ = krylov.cg(At, Bt, _params(krylov, iter_lim=5), device="cpu")
    assert state["it"] == 5
    assert torch.equal(meta["extract"](state), got)


def test_cg_stops_at_the_iteration_limit():
    A, B = _spd(seed=3)
    want, jit = jkrylov.cg(jnp.asarray(A), jnp.asarray(B),
                           _params(jkrylov, tol=1e-12, iter_lim=7))
    got, it = krylov.cg(A, B, _params(krylov, tol=1e-12, iter_lim=7),
                        device="cpu")
    assert it == int(jit) == 7
    assert _rel(got, want) <= SOLVE_REL


@pytest.mark.parametrize("name", ["none", "mat", "function"])
def test_flexible_cg_matches_reference(name):
    A, B = _spd(3, seed=4)
    jp, p = _preconds()[name]
    want, jit = jkrylov.flexible_cg(jnp.asarray(A), jnp.asarray(B),
                                    _params(jkrylov), jp)
    got, it = krylov.flexible_cg(A, B, _params(krylov), p, device="cpu")
    assert it == int(jit) > 0
    assert _rel(got, want) <= SOLVE_REL


def test_flexible_cg_with_a_varying_preconditioner():
    """A callable (R, it) -> Z: a scale that changes with the iteration."""
    A, B = _spd(seed=5)
    want, jit = jkrylov.flexible_cg(
        jnp.asarray(A), jnp.asarray(B), _params(jkrylov),
        lambda R, it: R / (1.0 + 0.1 * (it % 3)))
    got, it = krylov.flexible_cg(
        A, B, _params(krylov), lambda R, it: R / (1.0 + 0.1 * (it % 3)),
        device="cpu")
    assert got.shape == (N,)
    assert it == int(jit) > 0
    assert _rel(got, want) <= SOLVE_REL


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("name", ["none", "function"])
def test_chebyshev_matches_reference(k, name):
    A, B = _spd(k, seed=6)
    jp, p = _preconds()[name]
    scale = 0.5 if name == "function" else 1.0
    bounds = (scale * 1.0, scale * KAPPA)
    want, jit = jkrylov.chebyshev(jnp.asarray(A), jnp.asarray(B), *bounds,
                                  _params(jkrylov, iter_lim=30), jp)
    got, it = krylov.chebyshev(A, B, *bounds, _params(krylov, iter_lim=30),
                               p, device="cpu")
    assert it == int(jit) == 30
    assert _rel(got, want) <= SOLVE_REL
    # it converges: 30 steps at κ = 20 leave little of the residual
    x = got.double().numpy()
    r = np.linalg.norm(A.astype(np.float64) @ x - B) / np.linalg.norm(B)
    assert r < 1e-3


def test_chebyshev_default_count_and_start():
    A, B = _spd(seed=7)
    X0 = np.full(N, 0.2, np.float32)
    want, jit = jkrylov.chebyshev(jnp.asarray(A), jnp.asarray(B), 1.0,
                                  KAPPA, X0=jnp.asarray(X0))
    got, it = krylov.chebyshev(A, B, 1.0, KAPPA, X0=X0, device="cpu")
    assert it == int(jit) == 50
    assert _rel(got, want) <= SOLVE_REL


def test_exports():
    assert algorithms.cg is krylov.cg
    assert algorithms.flexible_cg is krylov.flexible_cg
    assert algorithms.chebyshev is krylov.chebyshev
