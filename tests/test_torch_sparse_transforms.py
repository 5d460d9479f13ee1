"""Sparse operands through the port's sketch transforms, against the JAX
package's sparse applies and the port's own dense applies, on the CPU.

Every transform the reference lets take a ``SparseMatrix`` — JLT, CT
(sketch/dense.py: spmm against the operator, whole, pinned or panel by
panel), GaussianRFT, LaplacianRFT, ExpSemigroupRLT (sketch/rft.py:
spmm, then the features), UST (a host gather) and CWT — rowwise and
columnwise. Tolerances:

- JLT, GaussianRFT, ExpSemigroupRLT: max |port − reference| ≤ 1e-4 ·
  max|reference| (the reference's oracle; their Normal and Lévy entries
  differ by ROADMAP C2's residue);
- CT: entry by entry, |port − reference| ≤ 1e-4 · (|A|·|S|ᵀ), the sum of
  each entry's term magnitudes (C2: a Cauchy entry differs by up to 1e-5
  relative, and one heavy-tailed entry sets max|reference|);
- LaplacianRFT: entry by entry, outscale · (1e-4 · (|A|·|W|ᵀ) + 2 ulp(2π)):
  the same limit on the phase, plus the featurization's own rounding of
  phase + shift (the shift lies in [0, 2π)), times cos's Lipschitz
  factor;
- UST and CWT: bit-equal.

The same limits hold against the port's dense apply of the densified
operand. FJLT, FastGaussianRFT, the QRFTs and PPT have no sparse apply in
the reference and raise NotImplementedYetError, as there.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.base.sparse import SparseMatrix as JSparse
from libskylark_tpu.sketch import params as jparams
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import sparse as bs
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import SparseMatrix
from libskylark_tpu_torch.sketch import params as sparams

ORACLE = 1e-4
M_ROWS, N_COLS, S_DIM = 300, 700, 64

TRANSFORMS = [
    ("JLT", {}), ("CT", {"C": 2.0}), ("GaussianRFT", {"sigma": 30.0}),
    ("LaplacianRFT", {"sigma": 2800.0}), ("ExpSemigroupRLT", {"beta": 0.1}),
    ("UST", {}), ("UST", {"replace": False}), ("CWT", {}),
]


def _operand(seed=2, nonneg=False):
    rng = np.random.default_rng(seed)
    M = sp.random(M_ROWS, N_COLS, density=0.02, format="csc",
                  random_state=seed, dtype=np.float32,
                  data_rvs=lambda k: rng.standard_normal(k))
    return abs(M) if nonneg else M


def _dims(dim_name):
    return (getattr(sk, dim_name), getattr(jsk, dim_name),
            N_COLS if dim_name == "ROWWISE" else M_ROWS)


def _limit(T, A, dim_name):
    """The entry-by-entry limit of the Cauchy transforms (module doc)."""
    D = np.abs(A.toarray()).astype(np.float64)
    rowwise = dim_name == "ROWWISE"
    if isinstance(T, sk.CT):
        S = np.abs(T.s_panel(0, T.input_dim, device="cpu").double().numpy())
        return ORACLE * (D @ S.T if rowwise else S @ D)
    W = np.abs(T.w_panel(0, T.input_dim, device="cpu").double().numpy())
    phase = ORACLE * (D @ W.T if rowwise else W @ D)
    return T.outscale * (phase + 2 * np.spacing(np.float32(2 * np.pi)))


def _held(T, got, want, A, dim_name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if isinstance(T, (sk.UST, sk.CWT)):
        assert np.array_equal(got, want)
    elif isinstance(T, (sk.CT, sk.LaplacianRFT)):
        assert (np.abs(got - want) <= _limit(T, A, dim_name)).all()
    else:
        assert np.abs(got - want).max() <= ORACLE * np.abs(want).max()


@pytest.mark.parametrize("dim_name", ["ROWWISE", "COLUMNWISE"])
@pytest.mark.parametrize("name,kw", TRANSFORMS)
def test_sparse_apply_matches_the_reference(name, kw, dim_name):
    A = _operand(nonneg=name == "ExpSemigroupRLT")
    dim, jdim, N = _dims(dim_name)
    T = getattr(sk, name)(N, S_DIM, Context(7), **kw)
    want = np.asarray(getattr(jsk, name)(N, S_DIM, JContext(7), **kw).apply(
        JSparse.from_scipy(A), jdim))
    bs.conversions["todense"] = 0
    got = T.apply(SparseMatrix.from_scipy(A), dim, device="cpu")
    assert bs.conversions["todense"] == 0  # never densified
    _held(T, got.numpy(), want, A, dim_name)
    # the scipy operand takes the same route
    assert torch.equal(T.apply(A, dim, device="cpu"), got)


@pytest.mark.parametrize("dim_name", ["ROWWISE", "COLUMNWISE"])
@pytest.mark.parametrize("name,kw", TRANSFORMS)
def test_sparse_apply_matches_the_dense_apply(name, kw, dim_name):
    A = _operand(3, nonneg=name == "ExpSemigroupRLT")
    dim, _, N = _dims(dim_name)
    T = getattr(sk, name)(N, S_DIM, Context(8), **kw)
    got = T.apply(SparseMatrix.from_scipy(A), dim, device="cpu")
    want = T.apply(A.toarray(), dim, device="cpu")
    _held(T, got.numpy(), want.numpy(), A, dim_name)


@pytest.mark.parametrize("dim_name", ["ROWWISE", "COLUMNWISE"])
@pytest.mark.parametrize("name", ["JLT", "CT"])
def test_panel_loop_matches_the_reference(name, dim_name):
    """With a blocksize the operator is made panel by panel (the sparse
    panel loop, columnwise over Aᵀ); the reference loops alike."""
    A = _operand(4)
    dim, jdim, N = _dims(dim_name)
    sparams.set_blocksize(256)
    jparams.set_blocksize(256)
    try:
        T = getattr(sk, name)(N, S_DIM, Context(9))
        assert T._effective_blocksize(torch.float32) == 256
        got = T.apply(SparseMatrix.from_scipy(A), dim, device="cpu")
        want = getattr(jsk, name)(N, S_DIM, JContext(9)).apply(
            JSparse.from_scipy(A), jdim)
    finally:
        sparams.set_blocksize(0)
        jparams.set_blocksize(0)
    _held(T, got.numpy(), want, A, dim_name)


def test_auto_blocking_bounds_the_panel():
    """Past the auto-blocking threshold no more than one panel of S is
    made at a time, and the result is the unblocked one's."""
    A = _operand(5)
    T = sk.JLT(N_COLS, S_DIM, Context(10))
    whole = T.apply(SparseMatrix.from_scipy(A), sk.ROWWISE, device="cpu")
    widths = []
    panel = T.s_panel

    def counting(p0, p1, *a, **k):
        widths.append(p1 - p0)
        return panel(p0, p1, *a, **k)

    T.s_panel = counting
    sparams.set_auto_block_bytes(S_DIM * 256 * 4)
    try:
        got = T.apply(SparseMatrix.from_scipy(A), sk.ROWWISE, device="cpu")
    finally:
        sparams.set_auto_block_bytes(2 << 30)
    assert widths == [256, 256, N_COLS - 512]
    assert (got - whole).abs().max() <= ORACLE * whole.abs().max()


@pytest.mark.parametrize("name,kw", [("JLT", {}), ("CT", {}),
                                     ("GaussianRFT", {"sigma": 30.0})])
def test_pinned_operator_serves_the_sparse_apply(name, kw):
    A = _operand(6)
    T = getattr(sk, name)(N_COLS, S_DIM, Context(11), **kw).materialize(
        device="cpu")
    J = getattr(jsk, name)(N_COLS, S_DIM, JContext(11), **kw)
    J.materialize()
    calls = []
    T._full_operator = lambda *a: calls.append(a)  # never made again
    got = T.apply(SparseMatrix.from_scipy(A), sk.ROWWISE, device="cpu")
    want = J.apply(JSparse.from_scipy(A), jsk.ROWWISE)
    assert not calls
    _held(T, got.numpy(), want, A, "ROWWISE")


@pytest.mark.parametrize("name", ["FJLT", "FastGaussianRFT", "GaussianQRFT",
                                  "LaplacianQRFT", "PPT"])
def test_transforms_without_a_sparse_apply_raise(name):
    A = SparseMatrix.from_scipy(_operand(7))
    T = getattr(sk, name)(N_COLS, S_DIM, Context(12))
    with pytest.raises(errors.NotImplementedYetError):
        T.apply(A, sk.ROWWISE, device="cpu")
    J = getattr(jsk, name)(N_COLS, S_DIM, JContext(12))
    with pytest.raises(Exception, match="not implemented"):
        J.apply(JSparse.from_scipy(A.to_scipy()), jsk.ROWWISE)


def test_sparse_extent_is_checked():
    A = SparseMatrix.from_scipy(_operand(8))
    for name in ("JLT", "GaussianRFT", "UST"):
        with pytest.raises(errors.SketchError):
            getattr(sk, name)(N_COLS + 1, 8, Context(0)).apply(
                A, sk.ROWWISE, device="cpu")
        with pytest.raises(errors.SketchError):
            getattr(sk, name)(N_COLS, 8, Context(0)).apply(
                A, sk.COLUMNWISE, device="cpu")
