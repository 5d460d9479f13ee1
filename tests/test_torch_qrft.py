"""The port's quasi-random features (GaussianQRFT, LaplacianQRFT,
ExpSemigroupQRLT) and leaped Halton sequences against the JAX package, on
the CPU.

- Halton panels, W and the shifts are made by the same float64 numpy code
  on the host: bit-equal;
- ``.apply`` both orientations: max |Δ| ≤ 1e-4·max|ref| (the reference's
  oracle; the matmul and cos run in float32 in another order);
- the serialized form (sequence, skip, kernel parameter) is the
  reference's, and a reference JSON loads to the same W.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base import quasirand as jqr
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import interop
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors, quasirand
from libskylark_tpu_torch.base.context import Context

ORACLE = 1e-4

FAMILIES = {
    "gaussian": (jsk.GaussianQRFT, sk.GaussianQRFT, {"sigma": 4.0}, False),
    "laplacian": (jsk.LaplacianQRFT, sk.LaplacianQRFT, {"sigma": 64.0},
                  False),
    "expsemigroup": (jsk.ExpSemigroupQRLT, sk.ExpSemigroupQRLT,
                     {"beta": 0.5}, True),
}


def _operand(m, n, nonneg, seed=0):
    A = np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)
    return np.abs(A) / n if nonneg else A


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ORACLE * np.abs(want).max()


@pytest.mark.parametrize("d,leap", [(5, -1), (65, -1), (7, 11)])
def test_halton_panel_is_bit_equal(d, leap):
    want = jqr.LeapedHaltonSequence(d, leap)
    got = quasirand.LeapedHaltonSequence(d, leap)
    assert got.leap == want.leap and got.to_dict() == want.to_dict()
    np.testing.assert_array_equal(got.panel(3, 40, d), want.panel(3, 40, d))
    assert got.coordinate(17, d - 1) == want.coordinate(17, d - 1)
    with pytest.raises(errors.InvalidParametersError):
        got.panel(0, 2, d + 1)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_operator_and_shifts_are_bit_equal(name):
    jcls, cls, kw, _ = FAMILIES[name]
    jT, T = jcls(64, 96, JContext(1), **kw), cls(64, 96, Context(1), **kw)
    np.testing.assert_array_equal(T._W_host, jT._W_host)
    np.testing.assert_array_equal(T.shifts(torch.float64).numpy(),
                                  np.asarray(jT._shifts_host))


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("N,m,S,skip", [(64, 20, 96, 0), (33, 7, 50, 5)])
def test_apply_matches_reference(name, rowwise, N, m, S, skip):
    jcls, cls, kw, nonneg = FAMILIES[name]
    jT = jcls(N, S, JContext(1), skip=skip, **kw)
    T = cls(N, S, Context(1), skip=skip, **kw)
    A = _operand(m, N, nonneg)
    if not rowwise:
        A = np.ascontiguousarray(A.T)
    jdim = jsk.ROWWISE if rowwise else jsk.COLUMNWISE
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    got = T.apply(A, dim, device="cpu")
    assert got.dtype == torch.float32
    _close(got, jT.apply(jnp.asarray(A), jdim))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_reference_json_loads_to_same_operator(name):
    jcls, cls, kw, _ = FAMILIES[name]
    jT = jcls(40, 24, JContext(3), skip=2,
              sequence=jqr.LeapedHaltonSequence(41, 13), **kw)
    T = interop.transform_from_reference(jT.to_json())
    assert type(T) is cls and T.to_dict() == jT.to_dict()
    np.testing.assert_array_equal(T._W_host, jT._W_host)


def test_materialized_operator_serves_later_applies():
    T = sk.GaussianQRFT(32, 16, Context(0), sigma=2.0)
    A = _operand(5, 32, False)
    want = T.apply(A, sk.ROWWISE, device="cpu")
    T.materialize(torch.float32, "cpu")
    T._op_cache.mul_(0.0)  # a pinned operator that is read gives cos(shift)
    got = T.apply(A, sk.ROWWISE, device="cpu")
    torch.testing.assert_close(
        got, T.outscale * torch.cos(T.shifts())[None, :].expand(5, 16))
    assert not torch.equal(got, want)
