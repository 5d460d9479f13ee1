"""The port's KRR family and FeatureMapPrecond against the JAX package, on
the CPU (RLSC, coding and metrics: ``test_torch_ml_rlsc.py``, which shares
this file's data and bounds).

Both packages get the same float32 data (numpy, seeded: 256 rows of 16
features in 4 planted classes, and a 2-column regression target) and the
same Context seed, so they draw the same feature maps and sketches; what
is left is float32 rounding. Bounds:
- direct solves (Cholesky: exact, random features, sketched, split) and
  the block coordinate descent, run to the same sweep count (20) in both:
  max |Δ| ≤ 1e-4·max|ref|;
- CG solves (``faster_*``): the reference's own ``rtol = 1e-2, atol =
  1e-3`` against its solution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import ml
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.ml import krr

TOL = 1e-4
N, D, CLASSES = 256, 16, 4
LAM = 0.1
SIGMA = 4.0


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((CLASSES, D))
    labels = rng.integers(0, CLASSES, N)
    X = (centers[labels] + rng.standard_normal((N, D))).astype(np.float32)
    Y = np.stack([np.sin(X[:, 0]), X[:, 1] * X[:, 2] / 4.0], 1)
    Y = (Y + 0.01 * rng.standard_normal(Y.shape)).astype(np.float32)
    return X, Y, labels


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _held(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _held_cg(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-3)


def _kernels():
    return jml.Gaussian(D, SIGMA), ml.Gaussian(D, SIGMA)


# name: (reference call, port call); each returns the solution last
SOLVES = {
    "kernel_ridge": (
        lambda jk, X, Y: jml.kernel_ridge(jk, X, Y, LAM),
        lambda k, X, Y: krr.kernel_ridge(k, X, Y, LAM, device="cpu")),
    "approximate": (
        lambda jk, X, Y: jml.approximate_kernel_ridge(
            jk, X, Y, LAM, 128, JContext(5)),
        lambda k, X, Y: krr.approximate_kernel_ridge(
            k, X, Y, LAM, 128, Context(5), device="cpu")),
    "approximate_fast": (
        lambda jk, X, Y: jml.approximate_kernel_ridge(
            jk, X, Y, LAM, 100, JContext(6), jml.KrrParams(use_fast=True)),
        lambda k, X, Y: krr.approximate_kernel_ridge(
            k, X, Y, LAM, 100, Context(6), krr.KrrParams(use_fast=True),
            device="cpu")),
    "approximate_sketched_fjlt": (
        lambda jk, X, Y: jml.approximate_kernel_ridge(
            jk, X, Y, LAM, 48, JContext(7), jml.KrrParams(sketched_rr=True)),
        lambda k, X, Y: krr.approximate_kernel_ridge(
            k, X, Y, LAM, 48, Context(7), krr.KrrParams(sketched_rr=True),
            device="cpu")),
    "approximate_sketched_cwt": (
        lambda jk, X, Y: jml.approximate_kernel_ridge(
            jk, X, Y, LAM, 48, JContext(8),
            jml.KrrParams(sketched_rr=True, fast_sketch=True,
                          sketch_size=160)),
        lambda k, X, Y: krr.approximate_kernel_ridge(
            k, X, Y, LAM, 48, Context(8),
            krr.KrrParams(sketched_rr=True, fast_sketch=True,
                          sketch_size=160), device="cpu")),
    "sketched_split": (
        lambda jk, X, Y: jml.sketched_approximate_kernel_ridge(
            jk, X, Y, LAM, 64, JContext(9), params=jml.KrrParams(max_split=40)),
        lambda k, X, Y: krr.sketched_approximate_kernel_ridge(
            k, X, Y, LAM, 64, Context(9), params=krr.KrrParams(max_split=40),
            device="cpu")),
    "sketched_cwt": (
        lambda jk, X, Y: jml.sketched_approximate_kernel_ridge(
            jk, X, Y, LAM, 40, JContext(10), t=200,
            params=jml.KrrParams(fast_sketch=True)),
        lambda k, X, Y: krr.sketched_approximate_kernel_ridge(
            k, X, Y, LAM, 40, Context(10), t=200,
            params=krr.KrrParams(fast_sketch=True), device="cpu")),
    "large_scale": (
        lambda jk, X, Y: jml.large_scale_kernel_ridge(
            jk, X, Y, LAM, 96, JContext(11),
            jml.KrrParams(max_split=64, tolerance=0.0, iter_lim=20)),
        lambda k, X, Y: krr.large_scale_kernel_ridge(
            k, X, Y, LAM, 96, Context(11),
            krr.KrrParams(max_split=64, tolerance=0.0, iter_lim=20),
            device="cpu")),
}
CG_SOLVES = {
    "faster": (
        lambda jk, X, Y: jml.faster_kernel_ridge(
            jk, X, Y, LAM, 64, JContext(12),
            jml.KrrParams(tolerance=1e-6, iter_lim=400)),
        lambda k, X, Y: krr.faster_kernel_ridge(
            k, X, Y, LAM, 64, Context(12),
            krr.KrrParams(tolerance=1e-6, iter_lim=400), device="cpu")),
    "faster_unpreconditioned": (
        lambda jk, X, Y: jml.faster_kernel_ridge(
            jk, X, Y, LAM, 0, JContext(13),
            jml.KrrParams(tolerance=1e-6, iter_lim=400)),
        lambda k, X, Y: krr.faster_kernel_ridge(
            k, X, Y, LAM, 0, Context(13),
            krr.KrrParams(tolerance=1e-6, iter_lim=400), device="cpu")),
}


def _last(out):
    return out[-1] if isinstance(out, tuple) else out


@pytest.fixture(scope="module")
def reference():
    """Each solve of the reference, run once."""
    X, Y, _ = _data()
    jk, _ = _kernels()
    return {name: calls[0](jk, jnp.asarray(X), jnp.asarray(Y))
            for name, calls in {**SOLVES, **CG_SOLVES}.items()}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_krr_direct_solves_match_reference(reference, name):
    X, Y, _ = _data()
    _, k = _kernels()
    want = reference[name]
    got = SOLVES[name][1](k, X, Y)
    _held(_last(got), _last(want))
    # the same feature maps, allocation for allocation
    if isinstance(want, tuple):
        maps = got[0] if isinstance(got[0], list) else [got[0]]
        jmaps = want[0] if isinstance(want[0], list) else [want[0]]
        assert [m.to_dict()["creation_context"] for m in maps] == [
            m.to_dict()["creation_context"] for m in jmaps]
        assert [m.sketch_type for m in maps] == [
            m.sketch_type for m in jmaps]


@pytest.mark.parametrize("name", sorted(CG_SOLVES))
def test_krr_cg_solves_match_reference(reference, name):
    X, Y, _ = _data()
    _, k = _kernels()
    got = CG_SOLVES[name][1](k, X, Y)
    _held_cg(got, reference[name])
    # and the exact system's solution
    _held_cg(got, reference["kernel_ridge"])


def test_krr_predict_matches_reference(reference):
    X, Y, _ = _data()
    Xq = _data(seed=1)[0][:50]
    jk, k = _kernels()
    A = reference["kernel_ridge"]
    want = jml.krr.krr_predict(jk, jnp.asarray(Xq), jnp.asarray(X), A)
    got = ml.krr_predict(k, Xq, X, np.array(A), device="cpu")
    _held(got, want)
    got1 = ml.krr_predict(k, Xq, X, np.array(A)[:, 0], device="cpu")
    assert got1.shape == (50,)
    _held(got1, np.asarray(want)[:, 0])


def test_feature_map_precond_matches_reference():
    X, Y, _ = _data()
    jk, k = _kernels()
    jP = jml.FeatureMapPrecond(jk, LAM, jnp.asarray(X), 64, JContext(14))
    P = ml.FeatureMapPrecond(k, LAM, X, 64, Context(14), device="cpu")
    _held(P.U, jP.U)
    _held(P.apply(torch.from_numpy(Y)), jP.apply(jnp.asarray(Y)))
    # from made features: the same operator
    P2 = krr.FeatureMapPrecond.from_features(P.U, LAM)
    assert torch.equal(P2.apply(torch.from_numpy(Y)),
                       P.apply(torch.from_numpy(Y)))
    # (λI + UᵀU)·P(B) = B
    U = P.U.double()
    B = torch.from_numpy(Y).double()
    back = LAM * P.apply(torch.from_numpy(Y)).double() + U.T @ (
        U @ P.apply(torch.from_numpy(Y)).double())
    assert float((back - B).abs().max()) <= 1e-4 * float(B.abs().max())


@pytest.mark.parametrize("s,d,max_split", [(16, 5, 0), (48, 16, 20),
                                           (8192, 784, 4095), (100, 7, 1),
                                           (10, 30, 0)])
def test_split_sizes_match_reference(s, d, max_split):
    assert krr._split_sizes(s, d, max_split) == \
        jml.krr._split_sizes(s, d, max_split)


def test_params_defaults_match_reference():
    assert krr.KrrParams().to_dict() == {
        k: v for k, v in jml.KrrParams().to_dict().items()
        if k != "log_stream"}
    assert ml.RlscParams().to_dict() == {
        k: v for k, v in jml.RlscParams().to_dict().items()
        if k != "log_stream"}
