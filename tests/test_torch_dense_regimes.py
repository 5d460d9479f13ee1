"""The dense kernel's plain versions in every contraction regime, against
the JAX package's Pallas kernels in interpret mode, on the CPU.

On a CPU tensor each wrapper of ``sketch/cuda_dense.py`` runs the plain
version of the regime it is given. These tests hold it to
``libskylark_tpu.sketch.pallas_dense`` at ``precision=p, interpret=True``
for p in f32, bf16x3, bf16gen2 and bf16, with Normal, Cauchy and
Rademacher operators, at small ragged shapes (37×700 → 48 and 1000×3000 →
300, and their transposes): ``rowwise_apply``, ``columnwise_apply``,
``rft_rowwise_apply`` and ``serve_batched_apply`` (the last two in
``test_torch_dense_regimes_cos.py`` and ``…_batched.py``, which import
this module's helpers: under the test runner's one-file-per-worker
schedule the three files run side by side).

Tolerance, per output entry, the sum of:

- the reference's oracle, 1e-4 · max |reference|; for Cauchy operators,
  whose heavy tail puts max |reference| far above a typical entry, 1e-4 ·
  (|A|·|S|) entry by entry instead (the limit chip_smoke.py holds the
  kernels to);
- in the bf16 and bf16gen2 regimes, where the operator is rounded to
  bf16, Σ_k |a_k| · |bf16(S_port) − bf16(S_ref)|_k: the two packages'
  f32 erfinv and tan differ in the last bits of about 5% of Normal and 4%
  of Cauchy entries, and now and then such an entry rounds to the next
  bf16 value (one entry at 1000×3000 → 300 moved a column by 2.2e-4 of
  max |reference|; with the reference's own operator the port's product
  agrees to 3e-7). bf16x3 carries the entry's low half too and needs no
  such term.

That term is only as small as the generators' disagreement, so every
test first asserts that the two operators differ in at most GEN_SHARE of
their entries, each by at most GEN_ULPS f32 ulps (measured at these
shapes and keys: ≤ 4.9% and 3 ulps for Normal, ≤ 3.9% and 1 ulp for
Cauchy, none for Rademacher). A wrong generator fails there; past it, an
entry's bf16 values differ by at most one bf16 ulp, and the term stays
below 2⁻⁷ · Σ |a_k| · |S_k| over at most GEN_SHARE of the k.

The two operators of a (key, distribution, s, n) are generated once per
module (the ``operators`` fixture): every regime's case of one shape and
distribution contracts the same operator, and the reference's eager
generation was most of a case's time.

Both sides split and round the same operands the same way
(``dense.regime_matmul`` is ``pallas_dense._dot`` term for term); beyond
those entries only the order of the sums differs. The cos kernel's
features are held to the same limit on its phase, times outscale ·
inscale · sc (cos is 1-Lipschitz). The batched kernel scales the operator
entries before the product, as both the reference's batched kernel and
the port's plain version (``dense.serve_apply``) do, so its regimes round
the same scaled entries on both sides.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.base import randgen as jrandgen
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import pallas_dense as jpd
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_dense
from libskylark_tpu_torch.sketch.dense import BLOCK_COLS

ORACLE = 1e-4  # relative to max |reference|
# the most the two packages' operators may disagree (see the doc)
GEN_SHARE, GEN_ULPS = 0.06, 4

REGIMES = ["f32", "bf16x3", "bf16gen2", "bf16"]
DISTS = {"normal": (jrandgen.Normal(), randgen.Normal()),
         "cauchy": (jrandgen.Cauchy(), randgen.Cauchy()),
         "rademacher": (jrandgen.Rademacher(), randgen.Rademacher())}
# (m, n, s): the data extent m, the contracted n, the sketch dimension s
SHAPES = [(37, 700, 48), (1000, 3000, 300)]


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_generators_agree(S_ref, S):
    """The f32 operators differ in at most GEN_SHARE of their entries,
    each by at most GEN_ULPS ulps (same-sign bit patterns GEN_ULPS apart)."""
    bits = S.view(np.int32).astype(np.int64)
    ulps = np.abs(S_ref.view(np.int32).astype(np.int64) - bits)
    assert (ulps <= GEN_ULPS).all()
    assert (ulps > 0).mean() <= GEN_SHARE


@pytest.fixture(scope="module")
def operators():
    """``get(jkey, key, jd, d, s, n, scale=1.0)``: (S_ref, S_port) in
    float64, each entry times ``scale``, once the generators are seen to
    agree as the doc says; each pair generated once per module."""
    made = {}

    def get(jkey, key, jd, d, s, n, scale=1.0):
        tag = (np.asarray(key, np.uint32).tobytes(), type(d).__name__, s, n)
        if tag not in made:
            S_ref = np.asarray(jrandgen.dense_panel(jkey, jd, s, 0, n,
                                                    BLOCK_COLS), np.float32)
            S = randgen.dense_panel(key, d, s, 0, n, BLOCK_COLS).numpy(
            ).astype(np.float32)
            _assert_generators_agree(S_ref, S)
            made[tag] = S_ref, S
        S_ref, S = made[tag]
        return ((scale * S_ref).astype(np.float64),
                (scale * S).astype(np.float64))

    return get


def _bf16(x):
    return torch.from_numpy(x).float().bfloat16().double().numpy()


def _limit(A, S_ref, S, oracle, dist, precision, rowwise):
    """The per-entry limit of the module's doc, in the units of the
    product A·Sᵀ (rowwise, A (m, n)) or S·A (A (n, m)); S_ref, S (s, n) as
    the product sees them (scaled entries for the batched kernel);
    ``oracle`` the oracle term for a non-Cauchy operator."""
    Aa = np.abs(A.astype(np.float64))

    def product(X):
        return Aa @ X.T if rowwise else X @ Aa

    if dist == "cauchy":
        limit = ORACLE * product(np.abs(S_ref))
    else:
        limit = oracle + np.zeros(product(S_ref).shape)
    if precision in ("bf16", "bf16gen2"):
        # bf16 rounds a too, by at most 2⁻⁹ of it
        limit = limit + 1.01 * product(np.abs(_bf16(S) - _bf16(S_ref)))
    return limit


def _oracle(want):
    return ORACLE * np.abs(want).max()


def _close(got, want, limit):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert (np.abs(got.astype(np.float64) - want) <= limit).all()


def _keys(seed):
    return JContext(seed).allocate().key, Context(seed).allocate().key


@pytest.fixture(autouse=True)
def _no_launches():
    yield
    assert not any(cuda_dense.launches.values())


@pytest.mark.parametrize("precision", REGIMES)
@pytest.mark.parametrize("dist", list(DISTS))
@pytest.mark.parametrize("m,n,s", SHAPES)
def test_rowwise_regime_matches_interpreted_kernel(precision, dist, m, n, s,
                                                   operators):
    jd, d = DISTS[dist]
    jkey, key = _keys(10 + s)
    A = _data((m, n), 1)
    scale = 1.0 / math.sqrt(s)
    want = jpd.rowwise_apply(jkey, jd, jnp.asarray(A), s, scale,
                             precision=precision, interpret=True)
    got = cuda_dense.rowwise_apply(key, d, torch.from_numpy(A), s, scale,
                                   precision=precision)
    S_ref, S = operators(jkey, key, jd, d, s, n)
    want = np.asarray(want, np.float64)
    _close(got, want, scale * _limit(A, S_ref, S, _oracle(want) / scale, dist,
                                     precision, True))


@pytest.mark.parametrize("precision", REGIMES)
@pytest.mark.parametrize("dist", list(DISTS))
@pytest.mark.parametrize("m,n,s", SHAPES)
def test_columnwise_regime_matches_interpreted_kernel(precision, dist, m, n,
                                                      s, operators):
    jd, d = DISTS[dist]
    jkey, key = _keys(20 + s)
    A = _data((n, m), 2)
    scale = 1.0 / math.sqrt(s)
    want = jpd.columnwise_apply(jkey, jd, jnp.asarray(A), s, scale,
                                precision=precision, interpret=True)
    got = cuda_dense.columnwise_apply(key, d, torch.from_numpy(A), s, scale,
                                      precision=precision)
    S_ref, S = operators(jkey, key, jd, d, s, n)
    want = np.asarray(want, np.float64)
    _close(got, want, scale * _limit(A, S_ref, S, _oracle(want) / scale,
                                     dist, precision, False))


def test_regimes_differ_as_the_reference_says():
    # bf16x3 is f32-grade; bf16 and bf16gen2 round the operator (and bf16
    # the data too) at ~2⁻⁹ relative — each regime's plain version really
    # computes its own split
    m, n, s = SHAPES[1]
    A = torch.from_numpy(_data((m, n), 6))
    key = Context(7).allocate().key
    out = {p: cuda_dense.rowwise_apply(key, randgen.Normal(), A, s, 1.0,
                                       precision=p) for p in REGIMES}
    top = float(out["f32"].abs().max())

    def rel(p):
        return float((out[p] - out["f32"]).abs().max()) / top

    assert rel("bf16x3") < 1e-5
    assert 1e-4 < rel("bf16gen2") < 1e-2
    assert rel("bf16gen2") < rel("bf16") < 1e-2


def test_batched_lane_equals_its_launch_alone():
    # the plain version's lane b does not depend on the other lanes
    ctx = Context(41)
    kd = np.stack([ctx.allocate().key for _ in range(3)]).astype(np.uint32)
    scale = np.array([0.5, 2.0, 0.25], np.float32)
    A = torch.from_numpy(_data((3, 37, 700), 8))
    for p in REGIMES:
        got = cuda_dense.serve_batched_apply(kd, scale, A, randgen.Normal(),
                                             48, True, precision=p)
        for b in range(3):
            alone = cuda_dense.serve_batched_apply(
                kd[b:b + 1], scale[b:b + 1], A[b:b + 1], randgen.Normal(),
                48, True, precision=p)
            assert torch.equal(got[b], alone[0])


def test_jax_stays_on_the_cpu():
    assert jax.default_backend() == "cpu"
