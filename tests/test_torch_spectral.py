"""The port's copy of the Chebyshev spectral helpers against the JAX
package's (numpy float64 on the host in both): ``np.array_equal``."""

import numpy as np
import pytest

from libskylark_tpu.nla import spectral as jspectral
from libskylark_tpu_torch import nla
from libskylark_tpu_torch.nla import spectral

CASES = [(2, -1.0, 1.0), (5, -1.0, 1.0), (12, 0.0, 5.0), (21, 0.0, 5.0),
         (33, -2.0, 3.5)]


@pytest.mark.parametrize("N,a,b", CASES)
def test_chebyshev_points_equal(N, a, b):
    assert np.array_equal(spectral.chebyshev_points(N, a, b),
                          jspectral.chebyshev_points(N, a, b))


@pytest.mark.parametrize("N,a,b", CASES)
def test_chebyshev_diff_matrix_equal(N, a, b):
    D, x = spectral.chebyshev_diff_matrix(N, a, b)
    Dj, xj = jspectral.chebyshev_diff_matrix(N, a, b)
    assert np.array_equal(D, Dj) and np.array_equal(x, xj)


def test_exported_from_nla():
    assert nla.chebyshev_points is spectral.chebyshev_points
    assert nla.chebyshev_diff_matrix is spectral.chebyshev_diff_matrix


def test_differentiates_a_polynomial():
    D, x = spectral.chebyshev_diff_matrix(12, 0.0, 2.0)
    np.testing.assert_allclose(D @ x**3, 3 * x**2, atol=1e-9)
