"""The port's serve programs against the JAX package, on the CPU, on the
same raw key data:

- ``dense.serve_apply`` (JLT, CT) within the reference's oracle, max |Δ| ≤
  1e-4·max|ref|, including extents that are not powers of two;
- ``frft.serve_streams``: Rademacher, the permutations and the Uniform
  shifts bit-equal to the reference's, Normal within ROADMAP C2 (max |Δ| ≤
  1e-5), for several keys at once;
- ``frft.fastfood_serve_apply`` within 1e-4·max|ref|;
- ``sparse_serve.csr_row_ids`` and ``scatter_dense`` exact;
- ``sparse_serve.cwt_sparse_serve_apply`` bit-equal, both orientations,
  on padded lanes;
- ``sparse_serve.dense_sparse_serve_apply`` within 1e-4·max|ref|;
- each kernel's batched entry, which on a CPU tensor runs its plain
  version, equal lane by lane (torch.equal) to the per-lane program at
  capacities 1, 2, 4 and 8: the plain side of capacity invariance.
"""

import math

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from libskylark_tpu.base import randgen as jrandgen
from libskylark_tpu.sketch import dense as jdense
from libskylark_tpu.sketch import frft as jfrft
from libskylark_tpu.sketch import sparse_serve as jss
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.engine import bucket
from libskylark_tpu_torch.engine.serve import MicrobatchExecutor
from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood, cuda_fwht,
                                         cuda_hash, cuda_sparse, dense, frft,
                                         sparse_serve)

ORACLE = 1e-4
C2 = 1e-5
CAPACITIES = [1, 2, 4, 8]


def _keys(seed, B=1):
    ctx = Context(seed)
    return np.stack([ctx.allocate().key for _ in range(B)])


def _close(got, want, tol=ORACLE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _operand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("family", ["JLT", "CT"])
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("n", [256, 700])
def test_dense_serve_apply(family, rowwise, n):
    kd = _keys(3)[0]
    dist, jdist = ((randgen.Normal(), jrandgen.Normal()) if family == "JLT"
                   else (randgen.Cauchy(), jrandgen.Cauchy()))
    scale = np.float32(1 / math.sqrt(48) if family == "JLT" else 2.0 / 48)
    A = _operand((37, n) if rowwise else (n, 37), n)
    got = dense.serve_apply(kd, scale, torch.from_numpy(A), dist=dist,
                            s_dim=48, rowwise=rowwise)
    want = jdense.serve_apply(kd, scale, jnp.asarray(A), dist=jdist,
                              s_dim=48, rowwise=rowwise)
    _close(got, want)


@pytest.mark.parametrize("sm_kind,sm_param", [("ones", None),
                                              ("gauss", 3.5)])
@pytest.mark.parametrize("NB,nb,s_dim", [(512, 1, 300), (256, 3, 700)])
def test_serve_streams(sm_kind, sm_param, NB, nb, s_dim):
    kd = _keys(11, 3)
    got = frft.serve_streams(kd, NB=NB, nb=nb, s_dim=s_dim, sm_kind=sm_kind,
                             sm_param=sm_param)
    for b in range(3):
        want = jfrft.serve_streams(jr.wrap_key_data(jnp.asarray(kd[b])),
                                   jnp.float32, NB=NB, nb=nb, s_dim=s_dim,
                                   sm_kind=sm_kind, sm_param=sm_param)
        bd, gd, sm, pm, sh = (np.asarray(w) for w in want)
        assert np.array_equal(got[0][b].numpy(), bd)
        assert np.abs(got[1][b].numpy() - gd).max() <= C2
        assert np.array_equal(got[2][b].numpy(), sm)
        assert np.array_equal(got[3][b].numpy(), pm)
        assert np.array_equal(got[4][b].numpy(), sh)


def test_serve_streams_refuse_matern():
    """The Matern Sm kind raised while the Gamma sampler was missing; now
    each lane's Sm is FastMaternRFT's: √(2ν/χ²(2ν))/(l√NB), χ²(2ν) =
    Gamma(ν, scale 2) on sub-stream 4 of the lane's key."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.base.context import fold_in

    keys = _keys(2, 2)
    sm = frft.serve_streams(keys, NB=8, nb=2, s_dim=12, sm_kind="matern",
                            sm_param=(1.5, 2.0))[2]
    assert tuple(sm.shape) == (2, 16)
    for b in range(2):
        chi2 = randgen.stream_slice(fold_in(keys[b], 4),
                                    randgen.Gamma(1.5, 2.0), 0, 16)
        assert torch.equal(sm[b], frft.matern_sm(chi2, 1.5, 2.0, 8))


@pytest.mark.parametrize("fut", ["wht", "dct"])
@pytest.mark.parametrize("n_dim,s_dim", [(60, 40), (100, 300)])
def test_fastfood_serve_apply(fut, n_dim, s_dim):
    kd = _keys(5)[0]
    A = _operand((9, n_dim), n_dim)
    args = dict(n_dim=n_dim, s_dim=s_dim, fut=fut, sm_kind="gauss",
                sm_param=math.sqrt(n_dim))
    got = frft.fastfood_serve_apply(kd, torch.from_numpy(A), **args)
    want = jfrft.fastfood_serve_apply(kd, jnp.asarray(A), **args)
    _close(got, want)


def _lanes(B, shape, density, seed, nnz_class=None):
    """B packed CSR lanes of random operands, as the executor packs them,
    padded to one nnz class and the padded row extent."""
    from libskylark_tpu_torch.base.sparse import SparseMatrix
    import scipy.sparse as sp

    ops = [SparseMatrix.from_scipy(sp.random(
        *shape, density=density, format="csr", dtype=np.float32,
        random_state=seed + b)) for b in range(B)]
    nnz_class = nnz_class or bucket.nnz_class(max(A.nnz for A in ops))
    padded = bucket.pad_shape(shape, (0, 1))
    packed = [MicrobatchExecutor._pack_csr(A, padded[0], nnz_class,
                                           np.float32) for A in ops]
    data, idx, ptr = (np.stack(x) for x in zip(*packed))
    return ops, padded, data, idx, ptr


def test_csr_row_ids_and_scatter_dense_exact():
    ops, padded, data, idx, ptr = _lanes(3, (37, 300), 0.05, 1)
    rows = sparse_serve.csr_row_ids(torch.from_numpy(ptr), data.shape[1])
    for b, A in enumerate(ops):
        want = np.asarray(jss.csr_row_ids(jnp.asarray(ptr[b]),
                                          data.shape[1]))
        assert np.array_equal(rows[b].numpy(), want)
        one = sparse_serve.csr_row_ids(torch.from_numpy(ptr[b]),
                                       data.shape[1])
        assert np.array_equal(one.numpy(), want)
        D = sparse_serve.scatter_dense(
            torch.from_numpy(data[b]), torch.from_numpy(idx[b]),
            torch.from_numpy(ptr[b]), shape=padded)
        Dj = jss.scatter_dense(jnp.asarray(data[b]), jnp.asarray(idx[b]),
                               jnp.asarray(ptr[b]), shape=padded)
        assert np.array_equal(D.numpy(), np.asarray(Dj))
        assert np.array_equal(D[:37, :300].numpy(), A.to_scipy().toarray())
    stacked = sparse_serve.scatter_dense(
        torch.from_numpy(data), torch.from_numpy(idx), torch.from_numpy(ptr),
        shape=padded)
    for b in range(3):
        assert np.array_equal(stacked[b, :37, :300].numpy(),
                              ops[b].to_scipy().toarray())


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("s_dim", [7, 300])
def test_cwt_sparse_serve_apply_bit_equal(rowwise, s_dim):
    shape = (40, 5000) if rowwise else (5000, 40)
    ops, padded, data, idx, ptr = _lanes(2, shape, 0.02, s_dim)
    kd = _keys(s_dim, 2)
    for b in range(2):
        got = sparse_serve.cwt_sparse_serve_apply(
            kd[b], torch.from_numpy(data[b]), torch.from_numpy(idx[b]),
            torch.from_numpy(ptr[b]), s_dim=s_dim, rowwise=rowwise,
            shape=padded)
        want = jss.cwt_sparse_serve_apply(
            kd[b], jnp.asarray(data[b]), jnp.asarray(idx[b]),
            jnp.asarray(ptr[b]), s_dim=s_dim, rowwise=rowwise, shape=padded)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rowwise", [True, False])
def test_dense_sparse_serve_apply(rowwise):
    shape = (30, 200) if rowwise else (200, 30)
    _, padded, data, idx, ptr = _lanes(1, shape, 0.05, 8)
    kd = _keys(8)[0]
    scale = np.float32(1 / math.sqrt(32))
    got = sparse_serve.dense_sparse_serve_apply(
        kd, scale, torch.from_numpy(data[0]), torch.from_numpy(idx[0]),
        torch.from_numpy(ptr[0]), dist=randgen.Normal(), s_dim=32,
        rowwise=rowwise, shape=padded)
    want = jss.dense_sparse_serve_apply(
        kd, scale, jnp.asarray(data[0]), jnp.asarray(idx[0]),
        jnp.asarray(ptr[0]), dist=jrandgen.Normal(), s_dim=32,
        rowwise=rowwise, shape=padded)
    _close(got, want)


@pytest.mark.parametrize("B", CAPACITIES)
@pytest.mark.parametrize("rowwise", [True, False])
def test_dense_batched_plain_lanes(B, rowwise):
    kd = _keys(20 + B, B)
    scale = np.linspace(0.5, 2.0, B).astype(np.float32)
    A = torch.from_numpy(_operand((B, 24, 300) if rowwise else (B, 300, 24),
                                  B))
    for dist in (randgen.Normal(), randgen.Cauchy()):
        got = cuda_dense.serve_batched_apply(kd, scale, A, dist, 40, rowwise)
        for b in range(B):
            assert torch.equal(got[b], dense.serve_apply(
                kd[b], scale[b], A[b], dist=dist, s_dim=40, rowwise=rowwise))
    assert cuda_dense.launches["dense_batched_rowwise"] == 0
    assert cuda_dense.launches["dense_batched_columnwise"] == 0


@pytest.mark.parametrize("B", CAPACITIES)
def test_fastfood_batched_plain_lanes(B):
    kd = _keys(30 + B, B)
    A = torch.from_numpy(_operand((B, 5, 100), B))
    args = (100, 300, "wht", "gauss", 10.0)
    got = cuda_fastfood.serve_features_batched(kd, A, *args)
    for b in range(B):
        assert torch.equal(got[b], frft.fastfood_serve_apply(
            kd[b], A[b], n_dim=100, s_dim=300, fut="wht", sm_kind="gauss",
            sm_param=10.0))
    assert cuda_fastfood.launches["fastfood_batched"] == 0


@pytest.mark.parametrize("B", CAPACITIES)
@pytest.mark.parametrize("rowwise", [True, False])
def test_sparse_batched_plain_lanes(B, rowwise):
    shape = (30, 700) if rowwise else (700, 30)
    _, padded, data, idx, ptr = _lanes(B, shape, 0.03, 40 + B)
    kd = _keys(40 + B, B)
    data, idx, ptr = (torch.from_numpy(x) for x in (data, idx, ptr))
    rows = sparse_serve.csr_row_ids(ptr, data.shape[1])
    got = cuda_sparse.cwt_sparse_apply_batched(kd, data, rows, idx, 16,
                                               rowwise, padded)
    for b in range(B):
        want = sparse_serve.cwt_sparse_serve_apply(
            kd[b], data[b], idx[b], ptr[b], s_dim=16, rowwise=rowwise,
            shape=padded)
        assert torch.equal(got[b], want)
        assert torch.equal(got[b], cuda_sparse.cwt_sparse_apply(
            kd[b], data[b], rows[b], idx[b], 16, rowwise, padded))
    assert cuda_sparse.launches["sparse_rowwise"] == 0
    assert cuda_sparse.launches["sparse_columnwise"] == 0


@pytest.mark.parametrize("B", CAPACITIES)
def test_hash_and_fwht_batched_plain_lanes(B):
    kd = _keys(50 + B, B)
    A = torch.from_numpy(_operand((B, 6, 256), B))
    got = cuda_hash.cwt_apply_batched(kd, A, 32, True)
    got_f = cuda_fwht.srht_apply_batched(kd, A, 32, True)
    for b in range(B):
        assert torch.equal(got[b], cuda_hash.cwt_apply_plain(kd[b], A[b], 32,
                                                             True))
        assert torch.equal(got_f[b], cuda_fwht.srht_apply_plain(
            kd[b], A[b], 32, True))
    assert torch.equal(got, cuda_hash.cwt_apply_batched_plain(kd, A, 32,
                                                              True))
    assert torch.equal(got_f, cuda_fwht.srht_apply_batched_plain(kd, A, 32,
                                                                 True))
