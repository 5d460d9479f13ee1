"""The port's range finders and range-assisted factorizations
(nla/krank.py) against the JAX package's, on the CPU.

Both packages draw from the same Context seed (Gaussian test matrices and
the SRFT are counter streams). Bounds: Q up to column signs within 1e-4,
σ and λ within 1e-4 relative. The operands keep every column of Q well
determined in float32: a 120 × 60 matrix with σ from 2 down to 1 (power
iteration multiplies its condition by (σ₁/σ_s)⁴, so a wide spectrum
would leave its last columns to rounding in both packages), and the
reference test's exact rank-5 matrix for the adaptive finder, whose
later probes are rounding once the range is found. The cases mirror
tests/test_nla_krank.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.nla import krank as jkrank
from libskylark_tpu_torch import nla
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.nla import krank

TOL = 1e-4


def _spread(m=120, n=60, seed=0):
    """σ from 2 down to 1: every column of Q determined in float32."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return ((U * np.linspace(2.0, 1.0, n)) @ V.T).astype(np.float32)


def _lowrank(m=120, n=60, k=5, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, k)))[0]
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    A = (U * np.linspace(10, 1, k)) @ V.T + noise * rng.standard_normal(
        (m, n))
    return A.astype(np.float32)


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _same_up_to_signs(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    s = np.sign(np.sum(got * want, axis=0))
    s[s == 0] = 1
    return np.abs(got * s - want).max()


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


FINDERS = [
    ("generic", {"s": 12}, _spread),
    ("power_iteration", {"s": 12, "q": 2}, _spread),
    ("subspace_iteration", {"s": 12, "q": 2}, _spread),
    # the SRFT samples s of the n DCT columns with replacement: a repeat
    # makes A·S rank-deficient and QR fills Q's column with rounding, so
    # this case takes n = 256 and s = 12, whose draws are distinct
    # (asserted)
    ("fast_generic", {"s": 12}, lambda: _spread(300, 256)),
    ("adaptive", {"epsilon": 1e-3, "r": 8}, _lowrank),
]


def _distinct_prefix(n, s, seed):
    """How many of the SRFT's s column draws (with replacement, the
    finder's second allocation) come before the first repeat."""
    from libskylark_tpu_torch.base import randgen

    ctx = Context(seed)
    ctx.allocate()
    idx = randgen.stream_slice(ctx.allocate().key,
                               randgen.UniformInt(0, n - 1), 0, s,
                               device="cpu").tolist()
    return next((j for j in range(s) if idx[j] in idx[:j]), s)


@pytest.mark.parametrize("method,params,make", FINDERS)
def test_range_finder_matches_reference(method, params, make):
    A = make()
    want = jkrank.RandomizedRangeFinder(jnp.asarray(A), method, params,
                                        JContext(3)).compute()
    got = krank.RandomizedRangeFinder(A, method, params, Context(3),
                                      device="cpu").compute()
    if method == "fast_generic":
        assert _distinct_prefix(A.shape[1], params["s"], 3) == params["s"]
    assert _same_up_to_signs(got, want) <= TOL
    # and the singular values of the range-assisted SVD on that Q
    _, sw, _ = jkrank.RangeAssistedSVD(jnp.asarray(A), want).compute()
    _, sg, _ = krank.RangeAssistedSVD(A, got, device="cpu").compute()
    assert _rel(sg, sw) <= TOL


@pytest.mark.parametrize("method", ["direct", "row_extraction"])
def test_range_assisted_svd_matches_reference(method):
    A = _lowrank(noise=1e-3)
    Q = np.asarray(jkrank.RandomizedRangeFinder(
        jnp.asarray(A), "subspace_iteration", {"s": 8, "q": 1},
        JContext(1)).compute())
    Uw, sw, Vw = jkrank.RangeAssistedSVD(jnp.asarray(A), jnp.asarray(Q),
                                         method).compute()
    Ug, sg, Vg = krank.RangeAssistedSVD(A, Q, method, device="cpu").compute()
    assert _rel(sg, sw) <= TOL
    assert _same_up_to_signs(Ug[:, :5], np.asarray(Uw)[:, :5]) <= TOL
    assert _same_up_to_signs(Vg[:5].T, np.asarray(Vw)[:5].T) <= TOL


@pytest.mark.parametrize("method,params", [
    ("direct", None), ("row_extraction", None), ("nystrom", None),
    ("one_pass", {"s": 16})])
def test_range_assisted_evd_matches_reference(method, params):
    B = _lowrank(80, 80, 4)
    A = (B @ B.T).astype(np.float32)
    Q = np.asarray(jkrank.RandomizedRangeFinder(
        jnp.asarray(A), "subspace_iteration", {"s": 8, "q": 1},
        JContext(2)).compute())
    ww, _ = jkrank.RangeAssistedEVD(jnp.asarray(A), jnp.asarray(Q), method,
                                    params, context=JContext(4)).compute()
    wg, Vg = krank.RangeAssistedEVD(A, Q, method, params,
                                    context=Context(4),
                                    device="cpu").compute()
    ww = np.sort(np.asarray(ww, np.float64))[::-1][:4]
    wg = np.sort(_np(wg))[::-1][:4]
    assert np.abs(wg - ww).max() <= TOL * ww.max()
    assert tuple(Vg.shape) == (80, 8)


def test_randomized_svd_matches_reference():
    A = _spread()
    Uw, sw, Vw = jkrank.randomized_svd(jnp.asarray(A), 5, JContext(4), q=2)
    Ug, sg, Vg = nla.randomized_svd(A, 5, Context(4), q=2, device="cpu")
    assert tuple(Ug.shape) == (120, 5) and tuple(Vg.shape) == (5, 60)
    assert _rel(sg, sw) <= TOL
    R = (_np(Ug) * _np(sg)) @ _np(Vg)
    Rw = (np.asarray(Uw) * np.asarray(sw)) @ np.asarray(Vw)
    assert _rel(R, Rw) <= TOL


@pytest.mark.parametrize("n,s", [(64, 8), (100, 20)])
def test_srft_matrix_matches_reference(n, s):
    want = jkrank.srft_matrix(n, s, JContext(5))
    got = krank.srft_matrix(n, s, Context(5), device="cpu")
    assert tuple(got.shape) == (n, s)
    assert _rel(got, want) <= 1e-5


def test_missing_and_unknown_parameters_raise():
    with pytest.raises(errors.InvalidParametersError):
        krank.RandomizedRangeFinder(np.eye(4), "generic", {}, Context(0),
                                    device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        krank.RandomizedRangeFinder(np.eye(4), "magic", {"s": 2},
                                    Context(0), device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        krank.RangeAssistedEVD(np.eye(4), np.eye(4), "one_pass", {"s": 2},
                               device="cpu")


def test_deterministic_from_the_context():
    A = _spread()
    Q1 = krank.RandomizedRangeFinder(A, "generic", {"s": 10}, Context(7),
                                     device="cpu").compute()
    Q2 = krank.RandomizedRangeFinder(A, "generic", {"s": 10}, Context(7),
                                     device="cpu").compute()
    assert torch.equal(Q1, Q2)


def test_results_stay_on_the_operands_device():
    A = torch.from_numpy(_spread())
    Q = krank.RandomizedRangeFinder(A, "fast_generic", {"s": 10},
                                    Context(8), device="cpu").compute()
    assert Q.device == torch.device("cpu")
