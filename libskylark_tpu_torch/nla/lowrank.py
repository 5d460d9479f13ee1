"""Dominant-subspace approximation by two-level sketching (the port of
libskylark_tpu/nla/lowrank.py): sketch twice (sizes s and t), QR the first
sketch, SVD the cross product, truncate. ``approximate_dominant_subspace_
basis`` is the library call (ml.nonlinear's SketchPCR uses it);
``lowrank_serve_apply`` is one request of the serve layer's ``lowrank``
endpoint as a function of the two transforms' keys, and ``lowrank_serve``
its eager twin.

A DTensor A whose rows are split over a mesh (parallel/mesh.py) is
sketched rank by rank (the maps' DTensor applies); the QR is the
reference's Householder QR, which XLA replicates, so the (m × s) sketch
is gathered for it and each rank keeps its rows; Uᵀ·Y is the ranks' local
products and one all_reduce. Z comes back split like A's rows, R and V
Replicate()."""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def _lowrank_tail(X: torch.Tensor, Y: torch.Tensor, k: int) -> torch.Tensor:
    """Z = U·M[:, :k] with U from QR(X) and M the left singular vectors of
    Uᵀ·Y: the library half of one lowrank request, shared by the serve
    program and the serve layer's kernel flush (engine/serve.py)."""
    U = torch.linalg.qr(X)[0]
    M = torch.linalg.svd(U.T @ Y, full_matrices=False)[0]
    return U @ M[:, : int(k)]


def lowrank_serve_apply(kd_s, scale_s, kd_t, scale_t, A, *, dist, s: int,
                        t: int, k: int) -> torch.Tensor:
    """One request's dominant-subspace basis Z as a function of the two
    sketch keys ((2,) uint32 each), their scales and the operand A (m, d):
    the two rowwise dense sketches through ``dense.serve_apply`` (the
    operator made in torch), then QR, the cross product's SVD and the
    truncation of :func:`approximate_dominant_subspace_basis`. Zero-padded
    rows of A sketch to zero rows, QR keeps them zero rows of U, and Z's
    padded rows are zeros the serve layer cuts off."""
    from libskylark_tpu_torch.sketch.dense import serve_apply

    X = serve_apply(kd_s, float(scale_s), A, dist=dist, s_dim=int(s),
                    rowwise=True)
    Y = serve_apply(kd_t, float(scale_t), A, dist=dist, s_dim=int(t),
                    rowwise=True)
    return _lowrank_tail(X, Y, k)


def lowrank_serve(transform_s, transform_t, A, k: int, device=None):
    """Eager twin of the ``lowrank`` serve endpoint: the same computation
    from the two caller-held dense transforms (e.g. ``Linear(d).
    create_rft(s, ctx)`` JLTs) at the serve layer's pow2 row class, on
    ``device``. Returns the (m, k) basis on the host."""
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.engine import bucket as bucketing
    from libskylark_tpu_torch.engine.serve import (_lowrank_key_data,
                                                   _lowrank_statics)

    _statics, info = _lowrank_statics(transform_s, transform_t, A, k,
                                      bucketing.PAD_FLOOR)
    A = info["A"]
    dev = resolve_device(device)
    Ap = torch.zeros(info["padded"], dtype=getattr(torch, info["dtype"]),
                     device=dev)
    Ap[: A.shape[0]] = torch.as_tensor(A).to(dev)
    kd_s, sc_s = _lowrank_key_data(transform_s, info["dtype"])
    kd_t, sc_t = _lowrank_key_data(transform_t, info["dtype"])
    Z = lowrank_serve_apply(kd_s, sc_s, kd_t, sc_t, Ap, dist=info["dist"],
                            s=transform_s.sketch_dim,
                            t=transform_t.sketch_dim, k=int(k))
    return np.asarray(Z[: A.shape[0]].cpu())
