"""Kernel ridge regression, the five-regime solver family (the port of
libskylark_tpu/ml/krr.py):

=============================  ==============================================
``kernel_ridge``               exact Gram + Cholesky solve
``approximate_kernel_ridge``   random features + (optionally sketched) ridge
                               regression
``sketched_approximate_kernel_ridge``
                               features made in splits, each sketched down
                               before the solve: memory-bounded
``faster_kernel_ridge``        exact Gram solved by CG with a random-features
                               preconditioner applied by Sherman-Morrison-
                               Woodbury
``large_scale_kernel_ridge``   block coordinate descent over split feature
                               maps with cached Cholesky factors
=============================  ==============================================

Rows are examples: X is (n, d), Y is (n, t); feature maps apply ROWWISE
giving Z (n, s); W is (s, t); Gram coefficients A are (n, t).

The regimes run on the device of X (``device=``, else the package
default). The feature maps are allocated first, in the reference's
order, so one Context gives both packages the same maps. As in the
reference, ``kernel_ridge``, ``approximate_kernel_ridge``,
``sketched_approximate_kernel_ridge`` and ``krr_predict`` each run as one
program from the engine's executable cache (engine/compiled.py): a CUDA
graph on the card, captured once per (shapes, kernel, the feature maps'
and sketch's signatures), their keys and per-seed streams graph inputs
and λ an input too, so a new seed or λ replays it. Their Cholesky
factors are unchecked (``cholesky_ex``), as the reference's are. The
iterative regimes stay eager and read one scalar per iteration on the
host to decide whether to go on: the PCG's stopping flag
(``algorithms.krylov.cg``) and the BCD sweep's relative update (ROADMAP
B-ii 7).

X may be a DTensor whose rows (examples) are split over a mesh
(parallel/mesh.py); Y then comes split the same way or whole on every
rank (each rank takes its rows). The random-features regimes never
gather X: each rank featurizes its rows (B1-cos on the card), ZᵀZ and
ZᵀY are local products summed by one all_reduce each (s × s, s × t), a
regression sketch contracts the split rows by its own DTensor route
(CWT: B2 with the rank's offset; FJLT: one all-to-all, then the sketched
panel's split columns gathered), and the ridge solve runs on every rank;
W comes back Replicate(). Exact ``kernel_ridge`` solves the whole n × n
system on every rank, as XLA's replicated Cholesky does: the examples
are gathered once (an all_gather of X, n × d) to form it, and A comes
back split like X's rows.

X may also have its features (columns) split, alone or with its rows.
Exact ``kernel_ridge`` then forms K by the kernel's own DTensor route
(ml/kernels.py: each rank's features' partial, one all_reduce, f on the
sum) and gathers K's rows where they are split. Every other regime first
lays X out split on its rows by one all-to-all (``mesh._rows_layout``:
at config 5 it moves X, 60,000 × 784, once, where the feature map's
partial per apply would all-reduce Z, 60,000 × s) and takes the row
route.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from libskylark_tpu_torch import engine
from libskylark_tpu_torch.algorithms.krylov import KrylovParams, cg
from libskylark_tpu_torch.algorithms.precond import FunctionPrecond, IdPrecond
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.ml.kernels import Kernel
from libskylark_tpu_torch.parallel import mesh as pmesh


@dataclasses.dataclass
class KrrParams(Params):
    use_fast: bool = False          # fast feature transforms (Fastfood)
    sketched_rr: bool = False       # sketch the regression problem
    sketch_size: int = -1           # -1 -> 4*s
    fast_sketch: bool = False       # CWT instead of FJLT for the sketch
    iter_lim: int = 1000
    res_print: int = 10
    tolerance: float = 1e-3
    max_split: int = 0              # feature-split bound (0 = input dim)


def _feature_tag(params: KrrParams) -> str:
    return "fast" if params.use_fast else "regular"


def _eye(s: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(s, dtype=like.dtype, device=like.device)


def _panel(Z):
    """(the rows of Z this rank holds, the sum over the ranks that split
    them): a tensor whole, a DTensor's block, its columns gathered where
    they are split (a sketched FJLT panel, t × s, small)."""
    if not pmesh._is_sharded(Z):
        return Z, None
    B = pmesh._Blocks(Z)
    loc = B.local if not B.cols.split else B.cols.gather(B.local.T).T
    return loc, B.rows.sum


def _ridge_solve(Z, Y, lam) -> torch.Tensor:
    """W = argmin ‖Z·W − Y‖²_F + λ‖W‖²_F, by Cholesky of ZᵀZ + λI. Z and
    Y may be DTensors split alike on their rows: ZᵀZ and ZᵀY are then the
    ranks' local products summed, and W is whole on every rank."""
    Z, total = _panel(Z)
    Y, _ = _panel(Y)
    G, ZtY = Z.T @ Z, Z.T @ Y
    if total is not None:
        G, ZtY = total(G), total(ZtY)
    G = G + lam * _eye(Z.shape[1], Z)
    return torch.cholesky_solve(ZtY, torch.linalg.cholesky_ex(G).L)


def _split_sizes(s: int, d: int, max_split: int) -> list[int]:
    """Feature-split schedule: chunks of ``sinc`` = max_split/2 (or d when
    unbounded), the final chunk absorbing up to 2·sinc."""
    sinc = d if max_split == 0 else max(1, max_split // 2)
    sizes, remains = [], s
    while remains > 0:
        thiss = remains if remains <= 2 * sinc else sinc
        sizes.append(thiss)
        remains -= thiss
    return sizes


def _data(X, Y, device):
    """X as a tensor on ``device`` and Y beside it as (n, t). A DTensor X
    (rows split) stays; Y becomes a DTensor split like X's rows (its
    rows taken where it is whole)."""
    if pmesh._is_sharded(X):
        X = pmesh._rows_layout(X)
        B = pmesh._Blocks(X)
        Y = B.row_block(Y)
        return X, B.rows.wrap(Y[:, None] if Y.ndim == 1 else Y)
    X = as_tensor(X, device)
    Y = as_tensor(Y, X.device)
    return X, (Y[:, None] if Y.ndim == 1 else Y)


def _run_program(fn, name: str, extras: tuple, X, Y, lam, *transforms,
                 **statics):
    """``fn(X, Y, lam, *transforms, **statics)``: for a DTensor X called
    directly, its result replicated on X's mesh; otherwise from the
    executable cache, keyed on ``extras`` (digests of what ``fn`` closes
    over, never a transform: those pass positionally, keyed by their
    seed-free signatures), λ a 0-dim tensor of X's dtype as in the
    reference (an input, not a key), and the operands donated only when
    the user opted in (donate="auto")."""
    if pmesh._is_sharded(X):
        return pmesh._like(X, fn(X, Y, lam, *transforms, **statics))
    lam = torch.as_tensor(lam, dtype=X.dtype).to(X.device, non_blocking=True)
    cf = engine.compiled(fn, name=name, donate_argnums=(0, 1),
                         donate="auto", static_argnames=tuple(statics),
                         key_fn=lambda *a, **k: extras)
    return cf(X, Y, lam, *transforms, **statics)


@with_solver_precision
def kernel_ridge(k: Kernel, X, Y, lam: float,
                 params: Optional[KrrParams] = None,
                 device=None) -> torch.Tensor:
    """Exact KRR: A = (K + λI)⁻¹·Y by Cholesky. Predict with
    :func:`krr_predict`."""
    params = params or KrrParams()
    params.log(1, "kernel_ridge: solving (K + lambda I) A = Y")
    if pmesh._is_sharded(X):
        # the whole system on every rank
        B = pmesh._Blocks(X)
        Y = B.row_block(Y)
        Y = B.rows.wrap(Y[:, None] if Y.ndim == 1 else Y)
        if B.cols.split:
            # K by the kernel's features-split route, its rows gathered
            K = B.rows.gather(k.symmetric_gram(X).to_local())
        else:
            # the examples gathered once
            Xw = pmesh._whole(X)
            K = k.symmetric_gram(Xw, Xw.device)
        K = K + lam * _eye(K.shape[0], K)
        A = torch.cholesky_solve(pmesh._whole(Y), torch.linalg.cholesky(K))
        return B.rows.wrap(B.rows.take(A))
    X, Y = _data(X, Y, device)
    return _run_program(_exact_program(k), "kernel_ridge",
                         (engine.digest(k),), X, Y, lam)


def _exact_program(k: Kernel):
    """The body of ``"kernel_ridge"`` for kernel ``k``: the Gram matrix
    plus λI, its Cholesky factor (unchecked, as the reference's), the
    solve."""

    def solve(X, Y, lam):
        K = k.symmetric_gram(X, X.device) + lam * _eye(X.shape[0], X)
        return torch.cholesky_solve(Y, torch.linalg.cholesky_ex(K).L)

    return solve


def _predict_program(k: Kernel):
    """The body of ``"krr_predict"`` for kernel ``k``."""

    def run(X_new, X_train, A):
        return krr_predict_kernel(k, X_new, X_train, A)

    return run


def krr_predict_kernel(k: Kernel, X_new: torch.Tensor,
                       X_train: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The KRR predict program: cross-Gram times the fitted coefficients."""
    return k.gram(X_new, X_train, X_new.device) @ A


@with_solver_precision
def krr_predict(k: Kernel, X_new, X_train, A, device=None) -> torch.Tensor:
    """Predict with a :func:`kernel_ridge` model: gram(X_new, X)·A."""
    X_new = as_tensor(X_new, device)
    X_train = as_tensor(X_train, X_new.device)
    A = as_tensor(A, X_new.device)
    squeeze = A.ndim == 1
    A = A[:, None] if squeeze else A
    if any(pmesh._is_sharded(t) for t in (X_new, X_train, A)):
        out = krr_predict_kernel(k, X_new, X_train, A)
    else:
        out = engine.compiled(_predict_program(k), name="krr_predict",
                              key_fn=lambda *a: (engine.digest(k),))(
            X_new, X_train, A)
    return out[:, 0] if squeeze else out


def _regression_sketch(n: int, t: int, context: Context, params: KrrParams):
    """The row sketch of the regression problem: CWT when ``fast_sketch``
    (B2 columnwise on the card), else the FJLT (DCT mixer, cuFFT)."""
    from libskylark_tpu_torch import sketch as sk

    return (sk.CWT(n, t, context) if params.fast_sketch
            else sk.FJLT(n, t, context))


@with_solver_precision
def approximate_kernel_ridge(k: Kernel, X, Y, lam: float, s: int,
                             context: Context,
                             params: Optional[KrrParams] = None,
                             device=None):
    """Random-features KRR: Z = S(X) with an s-feature map, then a ridge
    solve for W, optionally after sketching the (n, s) regression down to
    (t, s) rows with FJLT (or CWT when ``fast_sketch``). Returns (S, W);
    predict with S.apply(X_new, ROWWISE)·W."""
    params = params or KrrParams()
    X, Y = _data(X, Y, device)
    S = k.create_rft(s, context, _feature_tag(params))
    R = None
    if params.sketched_rr:
        t = 4 * s if params.sketch_size == -1 else params.sketch_size
        R = _regression_sketch(X.shape[0], t, context, params)
    maps = (S,) if R is None else (S, R)
    return S, _run_program(_features_ridge, "approximate_kernel_ridge", (),
                           X, Y, lam, *maps)


def _features_ridge(X, Y, lam, S, R=None):
    """The body of ``"approximate_kernel_ridge"``: the features, the
    regression sketch when there is one, the ridge solve."""
    from libskylark_tpu_torch import sketch as sk

    Z = S.apply(X, sk.ROWWISE, device=X.device)
    if R is not None:
        Z, Y = (R.apply(Z, sk.COLUMNWISE, device=X.device),
                R.apply(Y, sk.COLUMNWISE, device=X.device))
    return _ridge_solve(Z, Y, lam)


@with_solver_precision
def sketched_approximate_kernel_ridge(k: Kernel, X, Y, lam: float, s: int,
                                      context: Context, t: int = -1,
                                      params: Optional[KrrParams] = None,
                                      device=None):
    """Memory-bounded random-features KRR: the s features come from a list
    of split maps, each block scaled by √(s_c/s) and compressed at once by
    a shared row sketch R to t rows, so the (n, s) feature matrix never
    exists. Returns (transforms, W); at predict time apply each map,
    scale by √(s_c/s), and concatenate."""
    params = params or KrrParams()
    X, Y = _data(X, Y, device)
    n, d = X.shape
    t = 4 * s if t == -1 else t
    R = _regression_sketch(n, t, context, params)
    transforms = [k.create_rft(thiss, context, _feature_tag(params))
                  for thiss in _split_sizes(s, d, params.max_split)]
    return transforms, _run_program(
        _split_features_ridge, "sketched_approximate_kernel_ridge", (),
        X, Y, lam, R, *transforms, s=s)


def _split_features_ridge(X, Y, lam, R, *transforms, s: int):
    """The body of ``"sketched_approximate_kernel_ridge"``: each map's
    block scaled by √(s_c/s) and sketched by R at once, then the ridge
    solve of the sketched problem."""
    from libskylark_tpu_torch import sketch as sk

    SY = R.apply(Y, sk.COLUMNWISE, device=X.device)
    B = pmesh._Blocks(X) if pmesh._is_sharded(X) else None
    parts = []
    for S in transforms:
        Z = S.apply(X, sk.ROWWISE, device=X.device)
        scale = math.sqrt(S.sketch_dim / s)
        # a DTensor scales its rank's rows: no traffic
        Z = B.rows.wrap(Z.to_local() * scale) if B else Z * scale
        # the sketched (t × s_c) block is whole on every rank
        parts.append(_panel(R.apply(Z, sk.COLUMNWISE, device=X.device))[0])
    return _ridge_solve(torch.cat(parts, dim=1), _panel(SY)[0], lam)


class FeatureMapPrecond(FunctionPrecond):
    """Random-features preconditioner for (K + λI): with U the (s, n)
    features, K ≈ UᵀU, so (λI + UᵀU)⁻¹ is applied by Sherman-Morrison-
    Woodbury: P(B) = B/λ − Uᵀ·(I + U·Uᵀ/λ)⁻¹·(U·B)/λ².
    :meth:`from_features` builds it from features already made."""

    def __init__(self, k, lam, X, s, context, use_fast: bool = False,
                 device=None):
        from libskylark_tpu_torch import sketch as sk

        X = as_tensor(X, device)
        S = k.create_rft(s, context, "fast" if use_fast else "regular")
        self._init_from_features(
            S.apply(X, sk.ROWWISE, device=X.device).T, lam)

    @classmethod
    def from_features(cls, U: torch.Tensor, lam) -> "FeatureMapPrecond":
        """The preconditioner of a made (s, n) feature matrix."""
        self = cls.__new__(cls)
        self._init_from_features(U, lam)
        return self

    def _init_from_features(self, U: torch.Tensor, lam) -> None:
        C = _eye(U.shape[0], U) + (U @ U.T) / lam
        L = torch.linalg.cholesky(C)

        def apply(B):
            CUB = torch.cholesky_solve(U @ B, L)
            return B / lam - (U.T @ CUB) / (lam * lam)

        FunctionPrecond.__init__(self, apply)
        self.U = U
        self.L = L
        self.lam = lam


@with_solver_precision
def faster_kernel_ridge(k: Kernel, X, Y, lam: float, s: int,
                        context: Context,
                        params: Optional[KrrParams] = None,
                        device=None) -> torch.Tensor:
    """Exact-Gram KRR solved by preconditioned CG with the random-features
    SMW preconditioner; ``s == 0`` runs CG without one. Returns A =
    (K + λI)⁻¹·Y."""
    from libskylark_tpu_torch import sketch as sk

    params = params or KrrParams()
    X, Y = _data(X, Y, device)
    S = None if s == 0 else k.create_rft(s, context, _feature_tag(params))
    cg_params = KrylovParams(tolerance=params.tolerance,
                             iter_lim=params.iter_lim)
    K = k.symmetric_gram(X, X.device) + lam * _eye(X.shape[0], X)
    P = (IdPrecond() if S is None else
         FeatureMapPrecond.from_features(
             S.apply(X, sk.ROWWISE, device=X.device).T, lam))
    A, it = cg(K, Y, cg_params, precond=P, device=X.device)
    params.log(2, f"faster_krr: {it} CG iterations")
    return A


def _bcd_program(transforms, iter_lim: int, tolerance: float):
    """The block-coordinate-descent solve as ``run(X, Y, lam) -> (W,
    sweeps, reldel)``. The first sweep builds and caches each block's
    Cholesky factor; each later sweep regenerates the blocks' features
    and reads the relative update on the host, going on while it is at
    least ``tolerance`` and fewer than ``iter_lim`` sweeps have run."""
    from libskylark_tpu_torch import sketch as sk

    def run(X, Y, lam):
        W0 = [torch.zeros((S.sketch_dim, Y.shape[1]), dtype=X.dtype,
                          device=X.device) for S in transforms]

        # first sweep: build and cache the factors
        Ls, W, R = [], [], Y
        for c, S in enumerate(transforms):
            Z = S.apply(X, sk.ROWWISE, device=X.device)  # (n, s_c)
            L = torch.linalg.cholesky(Z.T @ Z + lam * _eye(Z.shape[1], Z))
            Ls.append(L)
            delW = torch.cholesky_solve(Z.T @ R - lam * W0[c], L)
            W.append(W0[c] + delW)
            R = R - Z @ delW

        it, reldel = 1, math.inf
        while it < iter_lim and reldel >= tolerance:
            delsize = torch.zeros((), dtype=X.dtype, device=X.device)
            for c, S in enumerate(transforms):
                Z = S.apply(X, sk.ROWWISE, device=X.device)
                delW = torch.cholesky_solve(Z.T @ R - lam * W[c], Ls[c])
                W[c] = W[c] + delW
                R = R - Z @ delW
                delsize = delsize + torch.sum(delW * delW)
            wnorm = torch.sqrt(sum(torch.sum(w * w) for w in W))
            reldel = float(torch.sqrt(delsize)
                           / torch.clamp_min(wnorm, 1e-30))
            it += 1
        return torch.cat(W, dim=0), it, reldel

    return run


@with_solver_precision
def large_scale_kernel_ridge(k: Kernel, X, Y, lam: float, s: int,
                             context: Context,
                             params: Optional[KrrParams] = None,
                             device=None):
    """Block coordinate descent over split feature maps: per block c,
    cache L_c = chol(Z_cᵀZ_c + λI) on the first sweep, then iterate
    ΔW_c = L_c⁻ᵀL_c⁻¹·(Z_cᵀR − λW_c), W_c += ΔW_c, R −= Z_c·ΔW_c until the
    relative update falls below the tolerance. The features are
    regenerated from their (seed, counter) every sweep instead of stored.
    Returns (transforms, W), W the stacked block solutions."""
    params = params or KrrParams()
    X, Y = _data(X, Y, device)
    transforms = [k.create_rft(thiss, context, _feature_tag(params))
                  for thiss in _split_sizes(s, X.shape[1], params.max_split)]
    W, it, reldel = _bcd_program(transforms, int(params.iter_lim),
                                 float(params.tolerance))(X, Y, lam)
    params.log(2, f"large_scale_krr: {it} sweeps, relupdate = {reldel:.2e}")
    return transforms, W
