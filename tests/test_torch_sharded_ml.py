"""The port's ML solvers on mesh-sharded examples (DTensors) against the
JAX package's local route (ROADMAP A5b): exact and random-features KRR,
the sketched regimes, and Block-ADMM (linear and on kernel features).

One gloo group of seven CPU processes is spawned for the file
(``torch_dist_worker.run_group("sharded_ml", 7)``, about 15 s): meshes of
1, 2, 4, 5 and 7 ranks and the 2 × 2 grid, the reference's rank counts
(tests/test_ml_sharded.py: np ∈ {1, 4, 5, 7}). X is row-sharded; Y comes
split the same way or whole. Every rank of a mesh must hold the same
bytes, and each result is held to the reference's local route at its
sharded tests' 1e-3 (atol and rtol).

The collectives are asserted as in test_torch_sharded.py. The
random-features regimes and ADMM never gather: each rank featurizes its
rows and every sum over examples is one all_reduce. Exact
``kernel_ridge`` is the one case that gathers: the whole n × n system is
solved on every rank (XLA replicates its Cholesky too), formed from the
examples, gathered once (X, n × d, and Y).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from libskylark_tpu.algorithms.prox import (HingeLoss, L2Regularizer,
                                            SquaredLoss)
from libskylark_tpu.base.context import Context as RContext
from libskylark_tpu.ml import admm as radmm, kernels as rkernels, krr as rkrr

RANKS = {"m1": 1, "m2": 2, "m4": 4, "m5": 5, "g22": 4, "m7": 7}
ROW_SPLIT = {"m1": 0, "m2": 1, "m4": 1, "m5": 1, "g22": 2, "m7": 1}
TOL = 1e-3


@pytest.fixture(scope="module")
def ranks():
    return W.run_group("sharded_ml", 7)


def _value(ranks, key, mname):
    got = ranks[0][key]
    for r in range(1, RANKS[mname]):
        np.testing.assert_array_equal(ranks[r][key], got, err_msg=key)
    return got


def _collectives(ranks, key, mname, all_reduce=0, all_gather=0,
                 all_to_all=0):
    got = _value(ranks, key + "/counts", mname)
    want = [all_reduce, all_gather, all_to_all]
    assert list(got[:3]) == want, (key, got)
    assert got[3] == sum(want), (key, got)


def _kernel():
    return rkernels.Gaussian(8, sigma=W.KRR["sigma"])


@functools.lru_cache(maxsize=None)
def _reference(case):
    X, Y = W.ml_data()
    X, Y = jnp.asarray(X), jnp.asarray(Y)
    lam, s, t = W.KRR["lam"], W.KRR["s"], W.KRR["t"]
    k = _kernel()
    if case == "krr":
        return np.asarray(rkrr.kernel_ridge(k, X, Y, lam))
    if case == "akrr":
        return np.asarray(rkrr.approximate_kernel_ridge(
            k, X, Y, lam, s=s, context=RContext(seed=3))[1])
    if case == "akrr_cwt":
        params = rkrr.KrrParams(sketched_rr=True, fast_sketch=True,
                                sketch_size=t)
        return np.asarray(rkrr.approximate_kernel_ridge(
            k, X, Y, lam, s=s, context=RContext(seed=4), params=params)[1])
    if case == "sakrr":
        return np.asarray(rkrr.sketched_approximate_kernel_ridge(
            k, X, Y, lam, s=s, context=RContext(seed=5), t=t)[1])
    y = np.asarray(Y > 0).astype(np.int64)
    if case == "admm":
        S = radmm.BlockADMMSolver(SquaredLoss(), L2Regularizer(),
                                  W.ADMM["lam"], 8,
                                  num_partitions=W.ADMM["partitions"])
    else:
        S = radmm.BlockADMMSolver.from_kernel(
            RContext(seed=6), HingeLoss(), L2Regularizer(), W.ADMM["lam"],
            W.ADMM["features"], k, "regular", W.ADMM["partitions"])
    S.maxiter, S.tol = W.ADMM["maxiter"], 0.0
    return np.asarray(S.train(X, y).coef)


# regime -> (all_reduce, all_gather, all_to_all) per row-splitting mesh
# dimension: ZᵀZ and ZᵀY; CWT's two sketches of the split rows; FJLT's
# all-to-all per sketch (one call whatever the mesh) and the gather of
# each sketched panel's split columns; exact KRR's gathers of X and Y
KRR_COLLECTIVES = {"krr": (0, 2, 0), "akrr": (2, 0, 0),
                   "akrr_cwt": (2, 0, 0), "sakrr": (0, 8, 8)}


@pytest.mark.parametrize("mname", W.ML_MESHES)
@pytest.mark.parametrize("case", sorted(KRR_COLLECTIVES))
def test_krr_matches_the_local_route(ranks, case, mname):
    """kernel_ridge's A (split like X's rows), and W (Replicate()) of
    approximate_kernel_ridge, with a CWT regression sketch, and of
    sketched_approximate_kernel_ridge (FJLT), within 1e-3 of the
    reference's local route (tests/test_ml_sharded.py)."""
    got = _value(ranks, f"{case}/{mname}", mname)
    want = _reference(case)
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=TOL,
                               rtol=TOL)
    ar, ag, a2a = KRR_COLLECTIVES[case]
    split = ROW_SPLIT[mname]
    _collectives(ranks, f"{case}/{mname}", mname, all_reduce=ar * split,
                 all_gather=ag * split, all_to_all=a2a * (split > 0))


@pytest.mark.parametrize("mname", W.ML_MESHES)
@pytest.mark.parametrize("case", ["admm", "admm_kernel"])
def test_admm_matches_the_local_route(ranks, case, mname):
    """BlockADMMSolver.train on row-sharded X (2 partitions, 6
    iterations, tol 0; linear and Gaussian-feature maps): coef within
    1e-3 (tests/test_ml_sharded.py:96). All-reduces only: the labels'
    range, ZⱼᵀZⱼ per partition, and per iteration Zⱼᵀ·dsum and Zⱼᵀ·o per
    partition and the loss."""
    got = _value(ranks, f"{case}/{mname}", mname)
    np.testing.assert_allclose(got, _reference(case), atol=TOL, rtol=TOL)
    P, it = W.ADMM["partitions"], W.ADMM["maxiter"]
    _collectives(ranks, f"{case}/{mname}", mname,
                 all_reduce=(1 + P + it * (2 * P + 1)) * ROW_SPLIT[mname])
