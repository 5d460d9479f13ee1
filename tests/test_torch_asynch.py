"""The port's randomized block solvers (algorithms/asynch.py) against the
JAX package's, on the CPU, on the same SPD systems. Bounds: each sweep's
block order ``torch.equal`` to ``jax.random.permutation``; each sweep's
iterate within 1e-4 relative (norm); the drivers' solutions within 1e-4
relative and their sweep and iteration counts equal. The cases mirror
tests/test_algorithms.py's TestRandBlock.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.algorithms import asynch as jasynch
from libskylark_tpu.algorithms import krylov as jkrylov
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import algorithms
from libskylark_tpu_torch.algorithms import asynch, krylov
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context

TOL = 1e-4


def _spd(n, seed, cond):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.geomspace(1.0, cond, n)) @ Q.T
    B = rng.standard_normal((n, 3))
    return A.astype(np.float32), B.astype(np.float32)


def _rel(got, want):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 250, 1000])
@pytest.mark.parametrize("seed", [0, 9])
def test_block_order_is_jax_permutation(n, seed):
    key = jax.random.fold_in(jax.random.key(seed), 3)
    kd = np.asarray(jax.random.key_data(key))
    want = torch.from_numpy(np.asarray(jax.random.permutation(key, n),
                                       np.int64))
    assert torch.equal(randgen.permutation(kd, n), want)


@pytest.mark.parametrize("n,bs", [(96, 32), (100, 32), (64, 64)])
def test_each_sweep_matches_reference(n, bs):
    A, B = _spd(n, 5, 20.0)
    jsys = jasynch._BlockSystem(jnp.asarray(A), bs)
    sys = asynch._BlockSystem(A, bs, "cpu")
    assert (sys.nblocks, sys.pad) == (jsys.nblocks, jsys.pad)
    key = jax.random.key(7)
    Xj = jsys.pad_cols(jnp.zeros((n, 3), jnp.float32))
    X = sys.pad_cols(torch.zeros(n, 3))
    Bj = jsys.pad_cols(jnp.asarray(B))
    Bp = sys.pad_cols(torch.from_numpy(B))
    for i in range(5):
        sk = jax.random.fold_in(key, i)
        Xj = jsys.sweep(Xj, Bj, sk)
        X = sys.sweep(X, Bp, np.asarray(jax.random.key_data(sk)))
        assert _rel(X, Xj) <= TOL, i


@pytest.mark.parametrize("vector", [False, True])
def test_gauss_seidel_matches_reference(vector):
    A, B = _spd(100, 5, 20.0)
    if vector:
        B = B[:, 0]
    jp = jasynch.RandBlockParams(block_size=32, sweeps=3, tolerance=1e-6,
                                 max_outer=40)
    p = asynch.RandBlockParams(block_size=32, sweeps=3, tolerance=1e-6,
                               max_outer=40)
    want, jsweeps = jasynch.rand_block_gauss_seidel(
        jnp.asarray(A), jnp.asarray(B), JContext(7), jp)
    got, sweeps = algorithms.asynch.rand_block_gauss_seidel(
        A, B, Context(7), p, device="cpu")
    assert sweeps == jsweeps and tuple(got.shape) == B.shape
    assert _rel(got, want) <= TOL
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, B),
                               atol=5e-3)


def test_gauss_seidel_from_a_start():
    A, B = _spd(80, 6, 10.0)
    X0 = np.ones_like(B)
    jp = jasynch.RandBlockParams(block_size=16, sweeps=2, max_outer=3)
    p = asynch.RandBlockParams(block_size=16, sweeps=2, max_outer=3)
    want, _ = jasynch.rand_block_gauss_seidel(
        jnp.asarray(A), jnp.asarray(B), JContext(2), jp, jnp.asarray(X0))
    got, _ = asynch.rand_block_gauss_seidel(A, B, Context(2), p, X0,
                                            device="cpu")
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n,bs", [(64, 16), (70, 16)])
def test_fcg_matches_reference(n, bs):
    A, B = _spd(n, 6, 200.0)
    want, jit = jasynch.rand_block_fcg(
        jnp.asarray(A), jnp.asarray(B), JContext(11),
        jasynch.RandBlockParams(block_size=bs),
        jkrylov.KrylovParams(tolerance=1e-6, iter_lim=200))
    got, it = asynch.rand_block_fcg(
        A, B, Context(11), asynch.RandBlockParams(block_size=bs),
        krylov.KrylovParams(tolerance=1e-6, iter_lim=200), device="cpu")
    assert it == int(jit)
    assert _rel(got, want) <= TOL
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, B),
                               atol=5e-3)


def test_params_round_trip_with_the_reference():
    p = asynch.RandBlockParams(block_size=16, sweeps=2)
    assert p.to_dict() == jasynch.RandBlockParams(block_size=16,
                                                  sweeps=2).to_dict()
    assert asynch.RandBlockParams.from_json(p.to_json()) == p
