"""Dominant-subspace approximation by two-level sketching (the port of
``approximate_dominant_subspace_basis`` of libskylark_tpu/nla/lowrank.py,
which ml.nonlinear's SketchPCR uses; its serve endpoint is not ported):
sketch twice (sizes s and t), QR the first sketch, SVD the cross product,
truncate.

A DTensor A whose rows are split over a mesh (parallel/mesh.py) is
sketched rank by rank (the maps' DTensor applies); the QR is the
reference's Householder QR, which XLA replicates, so the (m × s) sketch
is gathered for it and each rank keeps its rows; Uᵀ·Y is the ranks' local
products and one all_reduce. Z comes back split like A's rows, R and V
Replicate()."""

from __future__ import annotations

from typing import Tuple

import torch

from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.parallel import mesh as pmesh


def approximate_dominant_subspace_basis(
    A, k: int, s: int, t: int, context: Context, kernel=None,
    tag: str = "regular", device=None,
) -> Tuple[torch.Tensor, object, torch.Tensor, torch.Tensor]:
    """Returns (Z, S, R, V) with Z = QR(S(A)).Q·V; S is the feature
    transform kept so that test points map through the same sketch.
    ``s = Ω(k/ε)``, ``t = Ω(k/ε²)`` give the (1+ε)‖A_k − A‖_F
    guarantee."""
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.ml.kernels import Linear

    if kernel is None:
        kernel = Linear(A.shape[1])
    S = kernel.create_rft(s, context, tag)
    X = S.apply(A, sk.ROWWISE, device=device)
    T = kernel.create_rft(t, context, tag)
    Y = T.apply(A, sk.ROWWISE, device=X.device)
    blocks = pmesh._Blocks(X)
    rows = blocks.rows
    if blocks.sharded:
        Y = Y.to_local()
    U, R = torch.linalg.qr(rows.gather(blocks.local))
    U = rows.take(U)
    M = torch.linalg.svd(rows.sum(U.T @ Y), full_matrices=False)[0]
    V = M[:, :k]
    return rows.wrap(U @ V), S, rows.whole(R), rows.whole(V)
