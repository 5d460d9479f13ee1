"""One small request of each of the serve executor's twelve endpoints,
built alike for the JAX package (``side="ref"``) and the port
(``side="port"``) from one numpy seed: the digest and executor tests of
the serve production layer share them. ``variant`` picks operand forms the
digest must see through: ``"strided"`` (non-contiguous views),
``"tensor"`` (the port's operands as CPU tensors, the reference's as the
same numpy arrays) and ``"big_seed"`` (seeds past int32, ROADMAP C16)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

ENDPOINTS = ("sketch_apply", "fastfood_features", "solve_l2_sketched",
             "krr_predict", "sparse_sketch_apply",
             "sparse_solve_l2_sketched", "graph_ase", "graph_ppr",
             "condest", "lowrank", "rlsc_predict", "compressed_matmul")


def _mods(side):
    if side == "ref":
        from libskylark_tpu import ml, sketch
        from libskylark_tpu.base.context import Context

        return sketch, Context, ml, ml.Gaussian, ml.Linear
    from libskylark_tpu_torch import ml, sketch
    from libskylark_tpu_torch.base.context import Context

    return sketch, Context, ml, ml.kernels.Gaussian, ml.kernels.Linear


def _graph_edges(n, p, seed):
    rng = np.random.default_rng(seed)
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def _csr(rows, cols, density, seed):
    return sp.random(rows, cols, density=density, format="csr",
                     random_state=seed, dtype=np.float32)


def case(endpoint: str, side: str, variant: str = "plain",
         seed: int = 0) -> dict:
    """The keyword arguments of one request of ``endpoint``."""
    M, C, ml, Gaussian, Linear = _mods(side)
    rng = np.random.default_rng(100 + seed)
    base = 2**33 + 7 if variant == "big_seed" else 0
    ctx = C(base + 11 + seed)

    def op(a):
        if variant == "strided":
            wide = np.repeat(a, 2, axis=-1)
            wide[..., 1::2] = -1.0
            a = wide[..., ::2]
            assert not a.flags.c_contiguous
        if variant == "tensor" and side == "port":
            return torch.from_numpy(np.ascontiguousarray(a))
        return a

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if endpoint == "sketch_apply":
        return dict(transform=M.JLT(64, 16, ctx), A=op(normal(5, 64)),
                    dimension=M.ROWWISE)
    if endpoint == "fastfood_features":
        return dict(transform=M.FastGaussianRFT(16, 32, ctx, sigma=2.0),
                    A=op(normal(3, 16)))
    if endpoint == "solve_l2_sketched":
        A = normal(48, 4)
        return dict(transform=M.JLT(48, 16, ctx), A=op(A),
                    B=A @ normal(4) + 0.1 * normal(48))
    if endpoint in ("krr_predict", "rlsc_predict"):
        X = np.random.default_rng(5).standard_normal(
            (40, 6)).astype(np.float32)
        cols = 1 if endpoint == "krr_predict" else 3
        coef = np.random.default_rng(6).standard_normal(
            (40, cols)).astype(np.float32)
        kw = dict(kernel=Gaussian(6, 1.5), X_new=op(normal(4, 6)),
                  X_train=X, coef=coef)
        if endpoint == "rlsc_predict":
            kw["coding"] = [-1, 1, 7]
        return kw
    if endpoint == "sparse_sketch_apply":
        return dict(transform=M.CWT(80, 16, ctx),
                    A=_csr(12, 80, 0.1, 3 + seed), dimension=M.ROWWISE)
    if endpoint == "sparse_solve_l2_sketched":
        return dict(transform=M.CWT(90, 24, ctx), A=_csr(90, 5, 0.2, 4),
                    B=normal(90))
    if endpoint in ("graph_ase", "graph_ppr"):
        G = ml.Graph(_graph_edges(16, 0.3, 5))
        if endpoint == "graph_ase":
            return dict(A=G, k=3, seed=base + seed, iters=3)
        s = np.zeros(G.num_vertices(), np.float32)
        s[seed % G.num_vertices()] = 1.0
        return dict(A=G, s=s, alpha=0.85, iters=6)
    if endpoint == "condest":
        return dict(A=op(normal(30, 10)), steps=4, seed=base + seed)
    if endpoint == "lowrank":
        kern = Linear(12)
        return dict(transform_s=kern.create_rft(4, ctx),
                    transform_t=kern.create_rft(6, ctx),
                    A=op(normal(20, 12)), k=2)
    if endpoint == "compressed_matmul":
        return dict(transform=M.FJLT(64, 16, ctx, fut="wht"),
                    A=op(normal(7, 64)), B=normal(64, 5))
    raise ValueError(endpoint)


def same(a, b) -> bool:
    """Bit equality of two served results (a tuple memberwise, a host
    array by value, a tensor by torch.equal)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def tensors(value) -> list:
    """The tensors of a served result."""
    if isinstance(value, tuple):
        return [t for v in value for t in tensors(v)]
    return [value] if isinstance(value, torch.Tensor) else []
