"""The port's sparse×dense products (base/sparse.py ``spmm``, ``spmm_t``,
``gemm``) against the JAX package's, on the CPU, and the device caches of
``SparseMatrix``.

- On a CPU tensor a product is the reference's ``segment_sum``
  formulation: v·B[c] added into its output row by ``index_add_`` in the
  COO (CSC) order, which on the CPU adds in index order as XLA's CPU
  ``segment_sum`` does. Tolerance: bit-equal (``np.array_equal``) to the
  reference's ``spmm``/``spmm_t``/``gemm`` on the same float32 operands,
  matrices and vectors, duplicates summed, empty columns. The installed
  JAX runs without x64, so float64 products are held to scipy's float64
  product instead, within 1e-12 relative (another summation order).
- ``coo``/``csr``/``csr_t`` are made once per (dtype, device) and shared
  by later products; another dtype makes its own entry. The transpose is
  kept and shares A's CSR forms, so a wide SVD uploads its operand once.
- ``products`` counts the route of each product, ``conversions`` the
  densifications.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu.base import sparse as jsparse
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import sparse as bs
from libskylark_tpu_torch.base.sparse import (SparseMatrix, gemm, spmm,
                                              spmm_t)


def _operand(m, n, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, format="csc", dtype=dtype,
                     random_state=seed,
                     data_rvs=lambda k: rng.standard_normal(k))


def _pair(M):
    return SparseMatrix.from_scipy(M), jsparse.SparseMatrix.from_scipy(M)


@pytest.fixture(autouse=True)
def _zero_counters():
    for c in (bs.products, bs.conversions):
        for k in c:
            c[k] = 0
    yield


CASES = [(50, 40, 0.2, 3), (300, 700, 0.01, 17), (1000, 64, 0.3, 1),
         (64, 2000, 0.05, 128), (1, 30, 0.5, 2), (30, 30, 0.0, 4)]


@pytest.mark.parametrize("m,n,density,k", CASES)
def test_spmm_and_spmm_t_bit_equal(m, n, density, k):
    dtype = np.float32
    rng = np.random.default_rng(m + n)
    M = _operand(m, n, density, m * n, dtype)
    A, JA = _pair(M)
    B = rng.standard_normal((n, k)).astype(dtype)
    Bt = rng.standard_normal((m, k)).astype(dtype)
    got = spmm(A, torch.from_numpy(B))
    got_t = spmm_t(A, torch.from_numpy(Bt))
    assert got.dtype == torch.from_numpy(B).dtype
    assert np.array_equal(got.numpy(), np.asarray(jsparse.spmm(JA, B)))
    assert np.array_equal(got_t.numpy(),
                          np.asarray(jsparse.spmm_t(JA, Bt)))
    assert bs.products["plain_calls"] == 2
    assert bs.products["plain_nnz"] == 2 * M.nnz
    assert bs.products["csr_calls"] == 0


@pytest.mark.parametrize("m,n,density,k", CASES[:4])
def test_float64_products(m, n, density, k):
    rng = np.random.default_rng(m * k)
    M = _operand(m, n, density, m + k, np.float64)
    A = SparseMatrix.from_scipy(M)
    B = rng.standard_normal((n, k))
    Bt = rng.standard_normal((m, k))
    got = spmm(A, torch.from_numpy(B))
    got_t = spmm_t(A, torch.from_numpy(Bt))
    assert got.dtype == got_t.dtype == torch.float64
    scale = np.abs(M).toarray()
    np.testing.assert_array_less(np.abs(got.numpy() - M @ B),
                                 1e-12 * (scale @ np.abs(B)) + 1e-300)
    np.testing.assert_array_less(np.abs(got_t.numpy() - M.T @ Bt),
                                 1e-12 * (scale.T @ np.abs(Bt)) + 1e-300)


def test_vectors_and_duplicates():
    rng = np.random.default_rng(5)
    r = rng.integers(0, 60, 900)
    c = rng.integers(0, 45, 900)
    v = rng.standard_normal(900).astype(np.float32)
    A = SparseMatrix.from_coo(r, c, v, (60, 45))
    JA = jsparse.SparseMatrix.from_coo(r, c, v, (60, 45))
    x = rng.standard_normal(45).astype(np.float32)
    u = rng.standard_normal(60).astype(np.float32)
    got, got_t = spmm(A, torch.from_numpy(x)), spmm_t(A, torch.from_numpy(u))
    assert got.shape == (60,) and got_t.shape == (45,)
    assert np.array_equal(got.numpy(), np.asarray(jsparse.spmm(JA, x)))
    assert np.array_equal(got_t.numpy(), np.asarray(jsparse.spmm_t(JA, u)))


@pytest.mark.parametrize("transpose_a", [False, True])
def test_gemm_every_kind_bit_equal(transpose_a):
    rng = np.random.default_rng(6)
    M = _operand(80, 50, 0.1, 7)
    N = _operand(50, 30, 0.1, 8) if not transpose_a else _operand(80, 30,
                                                                  0.1, 8)
    A, JA = _pair(M)
    B, JB = _pair(N)
    # sparse × sparse stays on the host, a SparseMatrix as in the reference
    got, want = gemm(A, B, transpose_a), jsparse.gemm(JA, JB, transpose_a)
    assert isinstance(got, SparseMatrix)
    assert np.array_equal(got.to_scipy().toarray(),
                          want.to_scipy().toarray())
    # sparse × dense
    D = rng.standard_normal(((80 if transpose_a else 50), 9)).astype(
        np.float32)
    got = gemm(A, torch.from_numpy(D), transpose_a, device="cpu")
    assert np.array_equal(got.numpy(),
                          np.asarray(jsparse.gemm(JA, D, transpose_a)))
    # dense × sparse
    E = rng.standard_normal(((80, 11) if transpose_a else (11, 80))).astype(
        np.float32)
    got = gemm(torch.from_numpy(E), A, transpose_a, device="cpu")
    assert np.array_equal(got.numpy(),
                          np.asarray(jsparse.gemm(E, JA, transpose_a)))
    # dense × dense: a matmul, against numpy within float32 rounding
    F = rng.standard_normal((9, 5)).astype(np.float32)
    Dd = rng.standard_normal((7, 9)).astype(np.float32)
    got = gemm(torch.from_numpy(Dd), torch.from_numpy(F), device="cpu")
    np.testing.assert_allclose(got.numpy(), Dd @ F, rtol=1e-5, atol=1e-5)


def test_shapes_are_checked():
    A = SparseMatrix.from_scipy(_operand(20, 10, 0.3, 1))
    with pytest.raises(errors.InvalidParametersError):
        spmm(A, torch.zeros(11, 2))
    with pytest.raises(errors.InvalidParametersError):
        spmm_t(A, torch.zeros(10, 2))


def test_products_reuse_one_cache_entry_per_dtype():
    """Two products in one dtype share the COO triplets; another dtype
    makes its own, and the first stays."""
    A = SparseMatrix.from_scipy(_operand(40, 30, 0.2, 9))
    spmm(A, torch.ones(30, 2))
    first = A.coo(torch.float32, "cpu")
    spmm_t(A, torch.ones(40, 3))
    assert all(a is b for a, b in zip(first, A.coo(torch.float32, "cpu")))
    assert len([k for k in A._dev if k[0] == "coo"]) == 1
    spmm(A, torch.ones(30, 2, dtype=torch.float64))
    wide = A.coo(torch.float64, "cpu")
    assert wide[2].dtype == torch.float64 and wide[2] is not first[2]
    assert len([k for k in A._dev if k[0] == "coo"]) == 2
    assert all(a is b for a, b in zip(first, A.coo(None, "cpu")))
    # the CSR forms of the card's route are cached the same way
    assert A.csr(device="cpu")[0] is A.csr(device="cpu")[0]
    assert A.csr_t(device="cpu")[0] is A.csr_t(device="cpu")[0]


def test_transpose_is_kept_and_shares_the_csr_forms():
    """A.transpose() is made once; Aᵀ's csr is A's csr_t and the other way
    round, one device entry for both, equal to Aᵀ's own canonical CSR."""
    A = SparseMatrix.from_scipy(_operand(40, 30, 0.2, 5))
    At = A.transpose()
    assert A.T is At and At.T is A
    first = A.csr_t(device="cpu")
    assert all(a is b for a, b in zip(first, At.csr(device="cpu")))
    second = At.csr_t(device="cpu")
    assert all(a is b for a, b in zip(second, A.csr(device="cpu")))
    fresh = SparseMatrix.from_scipy(A.to_scipy().T)
    for got, want in ((first, fresh.csr(device="cpu")),
                      (second, fresh.csr_t(device="cpu"))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wide_svd_uploads_its_operand_once():
    """A wide operand is factored as its kept transpose: a second
    approximate_svd adds no device entry and reuses the first's."""
    from libskylark_tpu_torch import nla
    from libskylark_tpu_torch.base.context import Context

    A = SparseMatrix.from_scipy(_operand(60, 200, 0.05, 6))
    params = nla.ApproximateSVDParams(num_iterations=1)
    nla.approximate_svd(A, 4, Context(1), params, device="cpu")
    kept = dict(A.transpose()._dev)
    assert kept
    nla.approximate_svd(A, 4, Context(2), params, device="cpu")
    assert A.transpose()._dev.keys() == kept.keys()
    assert all(a is b for k in kept
               for a, b in zip(kept[k], A.transpose()._dev[k]))


def test_resolve_device_fills_in_the_cuda_index(monkeypatch):
    """One resolver for every path: "cuda" resolves to the current card's
    index, so the sparse caches and a pinned operator see one device."""
    from libskylark_tpu_torch.base.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_csr_forms_are_the_product_operands():
    """csr() is A's canonical CSR and csr_t() Aᵀ's: as torch CSR tensors
    they densify to A and Aᵀ exactly."""
    r = np.array([3, 0, 3, 1, 0, 3])
    c = np.array([0, 0, 0, 2, 1, 1])
    v = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0], np.float32)
    A = SparseMatrix.from_coo(r, c, v, (4, 3))
    D = A.to_scipy().toarray()
    for parts, want in ((A.csr(device="cpu"), D),
                        (A.csr_t(device="cpu"), D.T)):
        data, indices, indptr = parts
        assert indices.dtype == torch.int32 and indptr.dtype == torch.int32
        M = torch.sparse_csr_tensor(indptr, indices, data, want.shape,
                                    check_invariants=True)
        assert np.array_equal(M.to_dense().numpy(), want)


def test_todense_is_counted():
    A = SparseMatrix.from_scipy(_operand(10, 10, 0.3, 2))
    A.todense(device="cpu")
    A.todense(torch.float64, device="cpu")
    assert bs.conversions["todense"] == 2
