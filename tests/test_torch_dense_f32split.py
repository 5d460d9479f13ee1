"""The f32 regime's 3×TF32 split, emulated on the CPU, before the card.

On the card the f32 regime of the dense kernel (csrc/dense_sketch.cu)
contracts hi·hi + hi·lo + lo·hi on the tensor cores, with hi = tf32(x) and
lo = tf32(x − hi) for each operand, tf32 being cvt.rna's rounding to 10
stored mantissa bits, to nearest, ties away from zero. No CPU runs that
kernel, so this module emulates its arithmetic (test code only; nothing in
the package changes for it): the rounding by integer operations on the
float bits, the three products in float64 (each product of tf32 values is
exact in fp32), and their sum in fp32. The kernel adds the three passes in
the tensor cores' accumulator, whose truncating adds the emulation does
not model; the kernel promotes each 32-deep k-block into an fp32 sum,
which keeps that to one k-block's worth (PERF.md).

It holds:

- LaplacianRFT's features with the projection in the emulated split
  against the JAX reference's (``libskylark_tpu`` on the CPU) at
  ``test_torch_rft.py``'s σ = 4N, max |Δ| ≤ 1e-4 · max |features|, both
  orientations; at ROADMAP C5's harder σ = 512, N = 700 the figure is
  printed (``pytest -rP`` shows it), not asserted: there the phases are
  large enough that one-ulp differences of an f32 product move features
  visibly;
- the emulated split against the f32 plain version
  (``dense.regime_matmul(..., "f32")``, X @ Y) for Normal and Cauchy
  operators at the regimes file's shapes, rowwise and columnwise: max |Δ|
  ≤ 1e-4 · max |plain|, Cauchy entry by entry ≤ 1e-4 · (|A|·|S|).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_dense
from libskylark_tpu_torch.sketch.dense import BLOCK_COLS

ORACLE = 1e-4
# (m, n, s) of tests/test_torch_dense_regimes.py
SHAPES = [(37, 700, 48), (1000, 3000, 300)]
# (N, m, S) of tests/test_torch_rft.py
RFT_SHAPES = [(512, 48, 64), (700, 37, 48)]


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 x rounded to tf32 as cvt.rna.tf32.f32 rounds it: add half
    of the 13 dropped bits' weight to the magnitude's bits, then clear
    them (ties go away from zero)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x: np.ndarray):
    hi = _tf32(x)
    return hi, _tf32(x - hi)  # x − hi is exact in float32


def split_matmul(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """X @ Y as the f32 regime forms it: (hi·hi + hi·lo) + lo·hi, each
    product in float64, the sum in float32."""
    Xh, Xl = _split(X)
    Yh, Yl = _split(Y)

    def prod(P, Q):
        return (P.astype(np.float64) @ Q.astype(np.float64)).astype(
            np.float32)

    return (prod(Xh, Yh) + prod(Xh, Yl)) + prod(Xl, Yh)


def _operator(key, dist, s, n):
    return randgen.dense_panel(key, dist, s, 0, n, BLOCK_COLS).numpy()


def split_features(T, A: np.ndarray, rowwise: bool) -> np.ndarray:
    """``T.apply`` with its projection in the emulated split: the kernel
    scales the finished sum by inscale, then the features."""
    W = _operator(T.subkey(0), T.dist, T._S, T._N)
    P = split_matmul(A, W.T) if rowwise else split_matmul(W, A)
    proj = torch.from_numpy(np.float32(T.inscale) * P)
    return T._featurize(proj, 1 if rowwise else 0).numpy()


def _operand(N, m, rowwise, seed=0):
    A = np.random.default_rng(seed).standard_normal((N, m)).astype(
        np.float32)
    return np.ascontiguousarray(A.T) if rowwise else A


def _laplacian_err(N, m, S, sigma, rowwise, seed=3):
    """max |split features − reference features| / max |reference|."""
    T = sk.LaplacianRFT(N, S, Context(seed), sigma=sigma)
    jT = jsk.LaplacianRFT(N, S, JContext(seed), sigma=sigma)
    A = _operand(N, m, rowwise)
    want = np.asarray(jT.apply(jnp.asarray(A), jsk.ROWWISE if rowwise
                               else jsk.COLUMNWISE))
    got = split_features(T, A, rowwise)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # tf32's ulp at 1
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -20, -(1 + ulp / 2),
                  1 + 3 * ulp / 2, 3.14159265], np.float32)
    got = _tf32(x)
    assert got[0] == one + ulp and got[1] == one and got[2] == -(one + ulp)
    assert got[3] == one + 2 * ulp
    assert (got.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    hi, lo = _split(x)
    assert (np.abs((hi.astype(np.float64) + lo) - x)
            <= 2.0 ** -21 * np.abs(x)).all()


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("N,m,S", RFT_SHAPES)
def test_laplacian_features_with_the_split_match_reference(N, m, S,
                                                           rowwise):
    assert _laplacian_err(N, m, S, 4.0 * N, rowwise) <= ORACLE


def test_laplacian_features_at_the_harder_sigma_are_recorded():
    # ROADMAP C5's figure: σ = 512, N = 700 (the f32 plain version's own
    # figure beside it)
    N, m, S = RFT_SHAPES[1]
    err = _laplacian_err(N, m, S, 512.0, True)
    T = sk.LaplacianRFT(N, S, Context(3), sigma=512.0)
    jT = jsk.LaplacianRFT(N, S, JContext(3), sigma=512.0)
    A = _operand(N, m, True)
    want = np.asarray(jT.apply(jnp.asarray(A), jsk.ROWWISE))
    plain = T.apply(A, sk.ROWWISE, device="cpu").numpy()
    print(f"sigma=512 N=700: split features_err_over_max={err:.3e}, f32 "
          f"plain {float(np.abs(plain - want).max() / np.abs(want).max()):.3e}")
    assert math.isfinite(err)


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("dist", ["normal", "cauchy"])
@pytest.mark.parametrize("m,n,s", SHAPES)
def test_split_within_oracle_of_f32_plain(m, n, s, dist, rowwise):
    d = {"normal": randgen.Normal(), "cauchy": randgen.Cauchy()}[dist]
    key = Context(50 + s).allocate().key
    A = _operand(n, m, rowwise, seed=s)
    scale = 1.0 / math.sqrt(s)
    plain = cuda_dense.dense_apply_plain(key, d, torch.from_numpy(A), s,
                                         scale, rowwise, "f32").numpy()
    S = _operator(key, d, s, n)
    got = np.float32(scale) * (split_matmul(A, S.T) if rowwise
                               else split_matmul(S, A))
    diff = np.abs(got.astype(np.float64) - plain)
    if dist == "cauchy":
        Aa, Sa = np.abs(A.astype(np.float64)), np.abs(S.astype(np.float64))
        limit = ORACLE * scale * (Aa @ Sa.T if rowwise else Sa @ Aa)
        assert (diff <= limit).all()
    else:
        assert diff.max() <= ORACLE * np.abs(plain).max()
