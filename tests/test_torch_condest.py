"""The port's condition estimate (nla/condest.py) against the JAX
package's, on the CPU.

- ``condest`` (exported as ``nla.estimate_condition``), dense and
  ``SparseMatrix`` operands: (cond, σmax, σmin) within rtol 5e-2 of the
  reference's on the same context — the reference's own sparse-vs-dense
  tolerance (tests/test_nla.py) — and the start vector is jax.random's
  (its Normal draw, ROADMAP C2). With ``max_iter`` at min(m, n) − 1 the
  Krylov space is exhausted and σmax, σmin are the operand's own within
  1e-6 relative of numpy's float64 SVD.
- ``condest_serve`` (the fixed-step device twin, zero padding to the
  serve class) against the reference's within 1e-4 relative (both in
  float32), and within the reference's qos bounds of ``condest``: σmax
  within 20%, 1 ≤ cond ≤ 3·cond(condest).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu import nla as jnla
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.base.sparse import SparseMatrix as JSparse
from libskylark_tpu.nla import condest as jcondest
from libskylark_tpu_torch import nla
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import SparseMatrix
from libskylark_tpu_torch.nla import condest


def _sparse(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n))
            * (rng.uniform(size=(m, n)) < density)).astype(np.float32)


def _conditioned(m, n, cond, seed):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), n)
    return ((U * s) @ V.T).astype(np.float32)


OPERANDS = [("sparse", (120, 20, 0.3, 13)), ("sparse", (400, 60, 0.05, 3)),
            ("conditioned", (300, 40, 50.0, 11)),
            ("conditioned", (500, 30, 1e3, 5))]


def _make(kind, args):
    return _sparse(*args) if kind == "sparse" else _conditioned(*args)


@pytest.mark.parametrize("as_sparse", [False, True])
@pytest.mark.parametrize("kind,args", OPERANDS)
def test_condest_matches_the_reference(kind, args, as_sparse):
    D = _make(kind, args)
    if as_sparse:
        A, jA = (SparseMatrix.from_scipy(sp.csc_matrix(D)),
                 JSparse.from_scipy(sp.csc_matrix(D)))
    else:
        A, jA = torch.from_numpy(D), D
    got = nla.estimate_condition(A, Context(43))
    want = jnla.estimate_condition(jA, JContext(43))
    np.testing.assert_allclose(got, want, rtol=5e-2)


@pytest.mark.parametrize("kind,args", OPERANDS)
def test_exhausted_krylov_space_gives_the_extremes(kind, args):
    D = _make(kind, args)
    sv = np.linalg.svd(D.astype(np.float64), compute_uv=False)
    _, smax, smin = condest.condest(SparseMatrix.from_scipy(sp.csc_matrix(D)),
                                    Context(7), max_iter=min(D.shape) - 1,
                                    tol=0.0)
    assert abs(smax - sv[0]) <= 1e-6 * sv[0]
    assert abs(smin - sv[-1]) <= 1e-6 * sv[-1]


def test_start_vector_is_jax_randoms_normal():
    import jax
    import jax.numpy as jnp

    from libskylark_tpu_torch.base.context import seed_key

    got = condest._normal(seed_key(5), 1000).numpy()
    want = np.asarray(jax.random.normal(jax.random.key(5), (1000,),
                                        jnp.float32))
    assert np.abs(got - want).max() <= 1e-5  # C2's Normal bound


def test_condest_is_deterministic():
    D = _sparse(50, 10, 0.5, 12)
    assert (nla.estimate_condition(D, Context(41))
            == nla.estimate_condition(D, Context(41)))


@pytest.mark.parametrize("shape,steps,seed", [((24, 10), 6, 1),
                                              ((100, 33), 8, 0),
                                              ((64, 64), 4, 3)])
def test_condest_serve_matches_the_reference(shape, steps, seed):
    D = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    got = nla.condest_serve(D, steps=steps, seed=seed, device="cpu")
    want = jcondest.condest_serve(D, steps=steps, seed=seed)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    ref_cond, ref_max, _ = nla.estimate_condition(D, Context(9))
    assert got[1] == pytest.approx(ref_max, rel=0.2)
    assert 1.0 <= got[0] <= 3.0 * ref_cond


def test_condest_serve_apply_pads_benignly():
    """With zero rows and columns padded on, the bidiagonal's largest
    singular value still lies at or below the operand's (interlacing,
    within float32 rounding)."""
    D = np.random.default_rng(2).standard_normal((20, 7)).astype(np.float32)
    P = np.zeros((32, 8), np.float32)
    P[:20, :7] = D
    smax = np.linalg.svd(D.astype(np.float64), compute_uv=False)[0]
    key = np.array([0, 4], np.uint32)
    for A in (D, P):
        got = condest.condest_serve_apply(key, torch.from_numpy(A), steps=5)
        assert torch.isfinite(got).all() and float(got[0]) >= 1.0
        assert float(got[1]) <= smax * (1 + 1e-5)
