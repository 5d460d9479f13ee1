"""The port's HDF5 IO (io/hdf5.py) against the JAX package's: round trips
in the reference's layout, and each package reading the other's files.
Needs h5py, which is imported at call time (the card's machine has
none: there these tests skip). The cases mirror tests/test_io.py."""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import libskylark_tpu.io as jio  # noqa: E402
from libskylark_tpu.base.sparse import SparseMatrix as JSparse  # noqa: E402
from libskylark_tpu_torch import io  # noqa: E402
from libskylark_tpu_torch.base.sparse import SparseMatrix  # noqa: E402


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((6, 4)).astype(np.float32)
    X[X < 0.3] = 0.0
    Y = rng.integers(0, 2, 6).astype(np.float32) * 2 - 1
    return X, Y


def test_have_hdf5():
    assert io.have_hdf5() and jio.have_hdf5()


def test_dense_round_trip(tmp_path):
    X, Y = _data()
    p = tmp_path / "d.h5"
    io.write_hdf5(p, X, Y)
    Xg, Yg = io.read_hdf5(p)
    np.testing.assert_array_equal(Xg, X)
    np.testing.assert_array_equal(Yg, Y)
    Xg, _ = io.read_hdf5(p, min_d=7)
    assert Xg.shape == (6, 7) and not Xg[:, 4:].any()


def test_sparse_round_trip(tmp_path):
    X, Y = _data()
    p = tmp_path / "s.h5"
    io.write_hdf5(p, SparseMatrix.from_dense(X), Y)
    Xg, Yg = io.read_hdf5(p, sparse=True)
    assert isinstance(Xg, SparseMatrix)
    np.testing.assert_array_equal(Xg.to_scipy().toarray(), X)
    np.testing.assert_array_equal(Yg, Y)
    with h5py.File(p, "r") as f:
        assert {"dimensions", "indptr", "indices", "values", "Y"} <= set(f)


@pytest.mark.parametrize("sparse", [False, True])
def test_reads_a_file_the_reference_wrote(tmp_path, sparse):
    X, Y = _data()
    p = tmp_path / "ref.h5"
    jio.write_hdf5(p, JSparse.from_dense(X) if sparse else X, Y)
    Xg, Yg = io.read_hdf5(p, sparse=sparse)
    Xw, Yw = jio.read_hdf5(p, sparse=sparse)
    if sparse:
        Xg, Xw = Xg.to_scipy().toarray(), Xw.to_scipy().toarray()
    np.testing.assert_array_equal(Xg, Xw)
    np.testing.assert_array_equal(Yg, Yw)


@pytest.mark.parametrize("sparse", [False, True])
def test_the_reference_reads_a_file_the_port_wrote(tmp_path, sparse):
    X, Y = _data()
    p = tmp_path / "port.h5"
    io.write_hdf5(p, SparseMatrix.from_dense(X) if sparse else X, Y)
    Xw, Yw = jio.read_hdf5(p, sparse=sparse)
    if sparse:
        Xw = Xw.to_scipy().toarray()
    np.testing.assert_array_equal(Xw, X)
    np.testing.assert_array_equal(Yw, Y)
