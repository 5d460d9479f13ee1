"""Chebyshev spectral helpers for time-dependent PPR (the port's own
copy of libskylark_tpu/nla/spectral.py, libSkylark's nla/spectral.hpp).

Built on the host in float64 numpy: small dense setup matrices of
ml/graph.py's time-dependent PPR, not device work.
"""

from __future__ import annotations

import numpy as np


def chebyshev_points(N: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """N Chebyshev points of the second kind mapped to [a, b]
    (ref: nla/spectral.hpp:17-30; the reference's affine map is only correct
    for its default interval — here the map is x = a + (cos+1)·(b−a)/2 so the
    points actually land in [a, b], with the midpoint snapped exactly to the
    interval center, generalizing the reference's exact-zero fix)."""
    n = N - 1
    j = np.arange(n + 1)
    s = (b - a) / 2.0
    x = a + (np.cos(j * np.pi / n) + 1.0) * s
    if n % 2 == 0:
        x[n // 2] = a + s
    return x


def chebyshev_diff_matrix(
    N: int, a: float = -1.0, b: float = 1.0
) -> tuple[np.ndarray, np.ndarray]:
    """Differentiation matrix D on N Chebyshev points: p' = D·p for the
    interpolating polynomial (ref: nla/spectral.hpp:54-96). Returns (D, X)
    with X the points rescaled to [a, b]."""
    x = chebyshev_points(N)  # on [-1, 1]
    n = N - 1
    D = np.empty((n + 1, n + 1))
    for j in range(n + 1):
        for i in range(n + 1):
            d = i - j
            v = 2.0 / (b - a)
            if i == 0 and j == 0:
                v *= (2.0 * n * n + 1.0) / 6.0
            elif i == n and j == n:
                v *= -(2.0 * n * n + 1.0) / 6.0
            else:
                if i in (0, n):
                    v *= 2.0
                if j in (0, n):
                    v /= 2.0
                if d == 0:
                    v *= -x[j] / (2.0 * (1.0 - x[j] * x[j]))
                elif d % 2 == 0:
                    v *= 1.0 / (x[i] - x[j])
                else:
                    v *= -1.0 / (x[i] - x[j])
            D[i, j] = v

    if a != -1.0 or b != 1.0:
        x = a + (x + 1.0) * (b - a) / 2.0
    return D, x
