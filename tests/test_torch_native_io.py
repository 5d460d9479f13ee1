"""The port's native parsers (io/native.py over its own csrc/io_parsers.cpp,
built by g++ into build/torch_host) and the readers that use them
(io/libsvm.py, io/arclist.py), against the JAX package and the port's
Python parsers, on the CPU.

Parsing is exact, so every comparison is exact: ``np.array_equal`` of
the per-line targets, indices and values, of dense arrays, and of the
CSR (indptr, indices, data) of sparse results. The library is the
port's own: its path lies under the port's build directory, never the
JAX package's ``native/``. Without the library the readers take their
Python parser, as the reference's do; ``native.runs`` counts which ran.
"""

import io as _io

import numpy as np
import pytest
import scipy.sparse as sp

from libskylark_tpu.io import arclist as jarclist
from libskylark_tpu.io import libsvm as jlibsvm
from libskylark_tpu.io import native as jnative
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.sparse import SparseMatrix
from libskylark_tpu_torch.io import arclist, libsvm, native
from libskylark_tpu_torch.kernels import build

TEXT = """1 1:0.5 3:-2 10:1e-3
-1 2:4
+1 5:0.25 6:0.5 7:1
-1
1 10:3.5 1:7
"""
TWO_TARGETS = """1 0.5 1:1 4:2
2 -0.5 2:3
3 1.5 3:4 4:5
"""
ARCS = """# a graph
0 1
1 2 0.5
2 0 3

3 3 2.5
0 1 1.0
"""


@pytest.fixture(autouse=True)
def _zero_runs():
    for k in native.runs:
        native.runs[k] = 0
    yield


def _csr(X):
    A = X.to_scipy().tocsr()
    A.sort_indices()
    return A.indptr, A.indices, A.data


def _lists_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_the_library_is_the_ports_own():
    from pathlib import Path

    from libskylark_tpu.native import build as jbuild

    assert native.available()
    path = build.host_library_path("io_parsers")
    assert path.exists() and path.parent == build.HOST_BUILD_DIR
    assert native._load()._name == str(path)
    assert path.resolve() != Path(jbuild.lib_path()).resolve()
    assert (build.CSRC / "io_parsers.cpp").exists()


@pytest.mark.parametrize("text", [TEXT, TWO_TARGETS])
@pytest.mark.parametrize("max_n", [-1, 2])
def test_parse_libsvm_matches_the_reference(text, max_n):
    got = native.parse_libsvm(_io.StringIO(text), max_n)
    want = jnative.parse_libsvm(_io.StringIO(text), max_n)
    py = libsvm._parse_lines(text.splitlines(), max_n)
    for other in (want, py):
        for i in range(3):
            _lists_equal(got[i], other[i])
        assert got[3:] == tuple(other[3:])


@pytest.mark.parametrize("text", [TEXT, TWO_TARGETS])
@pytest.mark.parametrize("direction", [libsvm.ROWS, libsvm.COLUMNS])
@pytest.mark.parametrize("sparse", [False, True])
def test_read_libsvm_matches_the_reference(text, direction, sparse):
    X, Y = libsvm.read_libsvm(_io.StringIO(text), direction, sparse,
                              min_d=12)
    jX, jY = jlibsvm.read_libsvm(_io.StringIO(text), direction, sparse,
                                 min_d=12)
    assert native.runs == {"native": 1, "python": 0}
    assert np.array_equal(Y, jY)
    if sparse:
        for a, b in zip(_csr(X), _csr(jX)):
            assert np.array_equal(a, b)
    else:
        assert np.array_equal(X, jX)


def test_native_and_python_parsers_read_alike(monkeypatch, tmp_path):
    """A generated file through both parsers of the port: the same CSR;
    with no library the Python parser reads, and the count says so."""
    rng = np.random.default_rng(4)
    M = sp.random(200, 3000, density=0.01, format="csr", random_state=4,
                  dtype=np.float32,
                  data_rvs=lambda k: rng.choice([0.25, 0.5, 1.0], k))
    path = tmp_path / "x.svm"
    libsvm.write_libsvm(path, SparseMatrix.from_scipy(M),
                        np.where(np.arange(200) % 2, 1.0, -1.0))
    X, y = libsvm.read_libsvm(path, sparse=True, min_d=3000)
    monkeypatch.setattr(native, "_load", lambda: None)
    X2, y2 = libsvm.read_libsvm(path, sparse=True, min_d=3000)
    assert native.runs == {"native": 1, "python": 1}
    assert np.array_equal(y, y2)
    for a, b, c in zip(_csr(X), _csr(X2), _csr(SparseMatrix.from_scipy(M))):
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("bad", ["1 0:1\n", "1 a:1\n", "1 2:x\n",
                                 "1 2 3:1\n1 3:1\n"])
def test_malformed_lines_raise(bad):
    with pytest.raises(errors.IOError_):
        libsvm.read_libsvm(_io.StringIO(bad))


@pytest.mark.parametrize("symmetrize", [False, True])
def test_read_arc_list_matches_the_reference(symmetrize):
    got = arclist.read_arc_list(_io.StringIO(ARCS), symmetrize)
    want = jarclist.read_arc_list(_io.StringIO(ARCS), symmetrize)
    assert native.runs == {"native": 1, "python": 0}
    assert got.shape == want.shape == (4, 4)
    for a, b in zip(_csr(got), _csr(want)):
        assert np.array_equal(a, b)
    assert np.array_equal(
        np.asarray(native.parse_arc_list(_io.StringIO(ARCS))),
        np.asarray(jnative.parse_arc_list(_io.StringIO(ARCS))))


def test_arc_list_round_trip_both_parsers(monkeypatch, tmp_path):
    rng = np.random.default_rng(6)
    G = SparseMatrix.from_scipy(sp.random(
        500, 500, density=0.01, format="csc", random_state=6,
        dtype=np.float32, data_rvs=lambda k: rng.choice([0.5, 2.0], k)))
    path = tmp_path / "g.arcs"
    arclist.write_arc_list(path, G)
    jarclist.write_arc_list(tmp_path / "j.arcs", G)
    assert path.read_text() == (tmp_path / "j.arcs").read_text()
    got = arclist.read_arc_list(path)
    monkeypatch.setattr(native, "_load", lambda: None)
    py = arclist.read_arc_list(path)
    assert native.runs == {"native": 1, "python": 1}
    n = got.shape[0]
    want = G.to_scipy()[:n, :n]
    for a, b in zip(_csr(got), _csr(py)):
        assert np.array_equal(a, b)
    assert np.array_equal(got.to_scipy().toarray(), want.toarray())


def test_bad_arc_lines_raise(monkeypatch):
    for text in ("0\n", "a b\n", "-1 2\n"):
        with pytest.raises(errors.IOError_):
            arclist.read_arc_list(_io.StringIO(text))
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(errors.IOError_):
        arclist.read_arc_list(_io.StringIO("0\n"))
