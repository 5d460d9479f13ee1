"""The port's sparse operands against the JAX package, on the CPU:

- ``SparseMatrix`` (base/sparse.py): CSC buffers, canonical CSR parts,
  COO triplets, the dense form, transpose and column views equal to the
  reference's ``SparseMatrix`` on the same scipy input (exact: integer
  structure and copied values), its tensors on the package default device
  unless a device is named;
- LIBSVM IO (io/libsvm.py): ``write_libsvm`` writes the reference's text
  byte for byte, and ``read_libsvm``/``read_dir_libsvm`` read a generated
  file (one and two targets, dense and sparse, rows and columns, ``min_d``
  and ``max_n``) into the reference's arrays exactly; both refuse a
  zero-based index;
- the sparse CountSketch: ``CWT.apply`` of a SparseMatrix, rowwise and
  columnwise, bit-equal to the reference's (the CPU scatter adds in CSR
  order, as XLA's does); MMT within ROADMAP C2 (its Cauchy values differ
  by backend at ~1e-5 relative), max |Δ| ≤ 1e-4·max|ref|; and
  ``apply_sparse`` equal to the reference's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.base.sparse import SparseMatrix as JSparse
from libskylark_tpu.io import libsvm as jlibsvm
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import (default_device,
                                              set_default_device)
from libskylark_tpu_torch.base.sparse import SparseMatrix, as_sparse
from libskylark_tpu_torch.io import libsvm

ORACLE = 1e-4


def _csr(m, n, density, seed, dtype=np.float32):
    return sp.random(m, n, density=density, format="csr", dtype=dtype,
                     random_state=seed)


def _dense(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_from_scipy_matches_the_reference(dtype):
    A = _csr(40, 70, 0.1, 1, dtype)
    got, want = SparseMatrix.from_scipy(A), JSparse.from_scipy(A)
    assert got.shape == want.shape and got.nnz == want.nnz
    assert got.density == want.density
    assert got.device_dtype == np.dtype(want.device_dtype)
    for a, b in [(got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)]:
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(got.csr_parts(), want.csr_parts()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(_dense(got.todense(device="cpu")),
                          _dense(want.todense()))
    for a, b in zip(got.coo(device="cpu"), want.coo()):
        assert np.array_equal(_dense(a), _dense(b))
    assert (got.to_scipy() != want.to_scipy()).nnz == 0


def test_constructors_sum_duplicates_as_the_reference():
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 20, 300), rng.integers(0, 30, 300)
    v = rng.standard_normal(300).astype(np.float32)
    got, want = (SparseMatrix.from_coo(r, c, v, (20, 30)),
                 JSparse.from_coo(r, c, v, (20, 30)))
    assert np.array_equal(_dense(got.todense(device="cpu")),
                          _dense(want.todense()))
    d, i, p = want.csr_parts()
    got2, want2 = (SparseMatrix.from_csr(d, i, p, (20, 30)),
                   JSparse.from_csr(d, i, p, (20, 30)))
    for a, b in zip(got2.csr_parts(), want2.csr_parts()):
        assert np.array_equal(a, b)
    X = rng.standard_normal((12, 9)).astype(np.float32)
    for thr in (0.0, 0.5):
        assert np.array_equal(
            _dense(SparseMatrix.from_dense(X, thr).todense(device="cpu")),
            _dense(JSparse.from_dense(X, thr).todense()))


def test_from_csr_leaves_the_callers_arrays_alone():
    d = np.array([1.0, 2.0, 3.0], np.float32)
    i = np.array([2, 0, 1], np.int32)      # unsorted within row 0
    p = np.array([0, 2, 3], np.int32)
    M = SparseMatrix.from_csr(d, i, p, (2, 3))
    assert np.array_equal(i, [2, 0, 1]) and np.array_equal(d, [1, 2, 3])
    data, indices, _ = M.csr_parts()
    assert np.array_equal(indices, [0, 2, 1]) and np.array_equal(
        data, [2, 1, 3])


def test_structural_ops_match_the_reference():
    A = _csr(30, 50, 0.1, 4)
    got, want = SparseMatrix.from_scipy(A), JSparse.from_scipy(A)
    assert np.array_equal(_dense(got.T.todense(device="cpu")),
                          _dense(want.T.todense()))
    v, w = got.column_view(7, 31), want.column_view(7, 31)
    assert v.shape == w.shape
    assert np.array_equal(_dense(v.todense(device="cpu")),
                          _dense(w.todense()))
    assert as_sparse(A).nnz == got.nnz and as_sparse(got) is got
    with pytest.raises(TypeError):
        as_sparse(np.zeros((2, 2)))


def test_dense_forms_land_on_the_default_device():
    A = SparseMatrix.from_scipy(_csr(20, 30, 0.2, 6))
    if not torch.cuda.is_available():  # the package default is "cuda"
        with pytest.raises(errors.UnsupportedError):
            A.todense()
    set_default_device("cpu")
    try:
        D = A.todense()
        assert D.device == default_device() and D.dtype == torch.float32
        assert all(t.device == default_device() for t in A.coo())
        assert np.array_equal(D.numpy(), A.to_scipy().toarray())
    finally:
        set_default_device("cuda")


def _write_sample(path, nt, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(25):
        labels = " ".join(f"{rng.integers(-1, 2)}" for _ in range(nt))
        idx = np.sort(rng.choice(60, int(rng.integers(0, 8)), replace=False))
        feats = " ".join(f"{j + 1}:{rng.standard_normal():.6g}" for j in idx)
        lines.append(labels + (" " + feats if feats else ""))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("nt", [1, 2])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("direction", ["rows", "columns"])
def test_read_libsvm_matches_the_reference(tmp_path, nt, sparse, direction):
    f = tmp_path / "data.libsvm"
    _write_sample(f, nt, 10 * nt)
    for kw in ({}, {"min_d": 80}, {"max_n": 9}):
        X, Y = libsvm.read_libsvm(str(f), direction, sparse, **kw)
        Xr, Yr = jlibsvm.read_libsvm(str(f), direction, sparse, **kw)
        assert Y.dtype == Yr.dtype and np.array_equal(Y, Yr)
        if sparse:
            assert X.shape == Xr.shape
            X, Xr = _dense(X.todense(device="cpu")), _dense(Xr.todense())
        assert X.dtype == Xr.dtype and np.array_equal(X, Xr)


def test_libsvm_stops_at_a_comment_and_refuses_zero_based(tmp_path):
    f = tmp_path / "c.libsvm"
    f.write_text("1 1:2 3:4\n-1 2:1\n# trailing comment\n1 4:4\n")
    X, Y = libsvm.read_libsvm(str(f))
    Xr, Yr = jlibsvm.read_libsvm(str(f))
    assert X.shape == (2, 3) and np.array_equal(X, Xr)
    assert np.array_equal(Y, Yr)
    z = tmp_path / "z.libsvm"
    z.write_text("1 0:2 3:4\n")
    with pytest.raises(errors.IOError_):
        libsvm.read_libsvm(str(z))
    with pytest.raises(Exception):
        jlibsvm.read_libsvm(str(z))


@pytest.mark.parametrize("sparse", [False, True])
def test_write_libsvm_writes_the_reference_text(tmp_path, sparse):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((15, 30)).astype(np.float32)
    X[rng.random(X.shape) < 0.7] = 0.0
    Y = rng.integers(0, 3, (15, 2)).astype(np.float32)
    Xp = SparseMatrix.from_dense(X) if sparse else X
    Xj = JSparse.from_dense(X) if sparse else X
    libsvm.write_libsvm(tmp_path / "a", Xp, Y)
    jlibsvm.write_libsvm(tmp_path / "b", Xj, Y)
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()
    X2, Y2 = libsvm.read_libsvm(str(tmp_path / "a"), min_d=30)
    assert np.allclose(X2, X, rtol=1e-7) and np.array_equal(Y2, Y)


def test_read_dir_libsvm_matches_the_reference(tmp_path):
    d = tmp_path / "shards"
    d.mkdir()
    _write_sample(d / "part-0", 1, 1)
    _write_sample(d / "part-1", 1, 2)
    X, Y = libsvm.read_dir_libsvm(str(d), sparse=True)
    Xr, Yr = jlibsvm.read_dir_libsvm(str(d), sparse=True)
    assert np.array_equal(_dense(X.todense(device="cpu")),
                          _dense(Xr.todense()))
    assert np.array_equal(Y, Yr)


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("s_dim", [7, 300, 1024])
def test_cwt_sparse_apply_bit_equal(rowwise, s_dim):
    # ragged n (not a multiple of the 4096-chunk); s = 7 puts many
    # nonzeros of a row or column into one bucket
    A = _csr(300, 5000, 0.02, s_dim) if rowwise else _csr(5000, 300, 0.02,
                                                          s_dim)
    n = 5000
    dim, jdim = ((sk.ROWWISE, jsk.ROWWISE) if rowwise
                 else (sk.COLUMNWISE, jsk.COLUMNWISE))
    T, Tj = sk.CWT(n, s_dim, Context(s_dim)), jsk.CWT(n, s_dim,
                                                      JContext(s_dim))
    got = T.apply(A, dim, device="cpu")
    want = np.asarray(Tj.apply(JSparse.from_scipy(A), jdim))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    # the same as the port's dense apply of the densified operand
    assert torch.equal(got, T.apply(A.toarray(), dim, device="cpu"))


@pytest.mark.parametrize("rowwise", [True, False])
def test_mmt_sparse_apply_within_c2(rowwise):
    A = _csr(200, 900, 0.03, 9) if rowwise else _csr(900, 200, 0.03, 9)
    dim, jdim = ((sk.ROWWISE, jsk.ROWWISE) if rowwise
                 else (sk.COLUMNWISE, jsk.COLUMNWISE))
    got = sk.MMT(900, 64, Context(9)).apply(A, dim, device="cpu").numpy()
    want = np.asarray(jsk.MMT(900, 64, JContext(9)).apply(
        JSparse.from_scipy(A), jdim))
    assert np.abs(got - want).max() <= ORACLE * np.abs(want).max()


@pytest.mark.parametrize("rowwise", [True, False])
def test_cwt_apply_sparse_matches_the_reference(rowwise):
    A = _csr(120, 400, 0.05, 2) if rowwise else _csr(400, 120, 0.05, 2)
    dim, jdim = ((sk.ROWWISE, jsk.ROWWISE) if rowwise
                 else (sk.COLUMNWISE, jsk.COLUMNWISE))
    got = sk.CWT(400, 32, Context(4)).apply_sparse(A, dim)
    want = jsk.CWT(400, 32, JContext(4)).apply_sparse(JSparse.from_scipy(A),
                                                      jdim)
    assert got.shape == want.shape
    assert np.array_equal(got.to_scipy().toarray(),
                          want.to_scipy().toarray())


def test_sparse_apply_checks_its_extent():
    A = _csr(30, 40, 0.1, 1)
    with pytest.raises(errors.SketchError):
        sk.CWT(41, 8, Context(0)).apply(A, sk.ROWWISE, device="cpu")
    with pytest.raises(errors.NotImplementedYetError):
        sk.JLT(40, 8, Context(0)).apply(A, sk.ROWWISE, device="cpu")
    assert jax.default_backend() == "cpu"
