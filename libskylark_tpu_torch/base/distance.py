"""Distance matrices for kernel Gram matrices (the port of
libskylark_tpu/base/distance.py).

Rows are points: ``X`` is (m, d), ``Y`` is (n, d), the result is (m, n).
Like the reference, the Euclidean variant returns **squared** distances,
by the norm expansion ‖x‖² + ‖y‖² − 2·x·y clamped at 0.
"""

from __future__ import annotations

import torch


def euclidean_distance_matrix(X: torch.Tensor,
                              Y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances D[i, j] = ‖xᵢ − yⱼ‖²."""
    nx = torch.sum(X * X, dim=1)
    ny = torch.sum(Y * Y, dim=1)
    D = nx[:, None] + ny[None, :] - 2.0 * (X @ Y.T)
    return torch.clamp_min(D, 0.0)


def symmetric_euclidean_distance_matrix(X: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances among the rows of X."""
    return euclidean_distance_matrix(X, X)


def l1_distance_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """L1 distances D[i, j] = ‖xᵢ − yⱼ‖₁, without the (m, n, d)
    broadcast the reference forms."""
    return torch.cdist(X, Y, p=1.0)


def symmetric_l1_distance_matrix(X: torch.Tensor) -> torch.Tensor:
    """L1 distances among the rows of X."""
    return l1_distance_matrix(X, X)
