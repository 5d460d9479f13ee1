"""Kernel B5's plan (csrc/fwht_sketch.cu), replayed in torch on the CPU,
against the plain version and the JAX package.

The CUDA kernel cannot run here, so these tests hold the order of
operations it depends on:

- the register WHT (each thread's levels over its window of index bits,
  the exchanges between windows, the last window's layout) is
  ``torch.equal`` to ``fut._wht_butterfly`` at every whole-row length;
- whole rows (n ≤ 16384): D ⊙ a, the register WHT, the samples read at
  idx from the last exchange, times samp — the direct gather;
- folded segments (n > 16384 rowwise, n > 2048 columnwise): each segment's
  register WHT folded into the s sums in increasing segment order, the
  runs of segments added in run order, then samp;
- columnwise, the same arithmetic down each column (the load stage only
  moves data): the plan of 8 columns a block, 2048-row segments;
- the replay is ``torch.equal`` to ``cuda_fwht.srht_apply_plain`` on dyadic
  data (integers, 1/√n a power of two: every step exact, so any add order
  gives the same bits) and where the plain version also runs the
  butterfly (n < 512); elsewhere max |Δ| ≤ 1e-4·max|ref| against the JAX
  package's XLA twin ``fjlt.srht_serve_apply`` (not Pallas interpret
  output: ROADMAP C1's stream layout);
- the plan reads one lane's shape, and the lane-axis plain route is lane
  by lane the B = 1 call, bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import fjlt as jfjlt
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_fwht
from libskylark_tpu_torch.sketch.fut import _wht_butterfly

ORACLE = 1e-4  # relative to max |reference|


def lay(t, j, lo, L):
    """The element value j of thread t holds in window [lo, lo + L)
    (csrc/wht.cuh: ``tpart(t, lo) | j << lo``)."""
    return (t & ((1 << lo) - 1)) | (j << lo) | ((t >> lo) << (lo + L))


def levels(regs, qa, qb, V):
    """Levels qa .. qb − 1 of each thread's V values, in order, each
    butterfly (a + b, a − b) (csrc/wht.cuh ``levels``)."""
    for q in range(qa, qb):
        r = regs.reshape(*regs.shape[:-1], V >> (q + 1), 2, 1 << q)
        a, b = r[..., 0, :], r[..., 1, :]
        regs = torch.stack([a + b, a - b], dim=-2).reshape(regs.shape)
    return regs


def register_wht(x):
    """The kernel's WHT of each row of x (rows, NB), returned in natural
    order as the last exchange writes it."""
    NB = x.shape[1]
    K = NB.bit_length() - 1
    L = min(4, K)
    V, T = 1 << L, NB >> L
    t = torch.arange(T)[:, None]
    j = torch.arange(V)[None, :]
    regs = levels(x[:, lay(t, j, 0, L)], 0, L, V)
    lo = 0
    for p in range(L, K, L):
        nlo = min(p, K - L)
        buf = torch.empty_like(x)
        buf[:, lay(t, j, lo, L)] = regs
        regs = levels(buf[:, lay(t, j, nlo, L)], p - nlo,
                      min(p + L, K) - nlo, V)
        lo = nlo
    out = torch.empty_like(x)
    out[:, lay(t, j, lo, L)] = regs
    return out


def popcount(v):
    c = torch.zeros_like(v)
    for bit in range(31):
        c += (v >> bit) & 1
    return c


def replay_rows(key, X, s_dim, plan):
    """The kernel's arithmetic on the rows of X (m, n): (m, s)."""
    n = X.shape[1]
    D, idx = cuda_fwht.streams(key, n, s_dim)
    fs, ss = (torch.tensor(v, dtype=torch.float32)
              for v in cuda_fwht.scales(n, s_dim))
    x = (fs * D)[None, :] * X
    K, P, G = plan["seg_bits"], plan["segments"], plan["groups"]
    if P == 1:
        return ss * register_wht(x)[:, idx]
    b = 1 << K
    pk, qk = idx >> K, idx & (b - 1)
    runs = []
    for g in range(G):
        acc = torch.zeros((X.shape[0], s_dim), dtype=torch.float32)
        for p in range(g * P // G, (g + 1) * P // G):
            y = register_wht(x[:, p * b:(p + 1) * b])[:, qk]
            acc = torch.where((popcount(pk & p) & 1).bool(), acc - y, acc + y)
        runs.append(acc)
    total = runs[0]
    for r in runs[1:]:
        total = total + r
    return ss * total


def replay(key, A, s_dim, rowwise):
    """The kernel on a 2-D operand; columnwise the same arithmetic down the
    columns under the columnwise plan."""
    n, m = (A.shape[1], A.shape[0]) if rowwise else A.shape
    plan = cuda_fwht.plan(n, m, rowwise)
    if rowwise:
        return replay_rows(key, A, s_dim, plan)
    return replay_rows(key, A.T.contiguous(), s_dim, plan).T


def operand(shape, dyadic, seed):
    g = np.random.default_rng(seed)
    if dyadic:
        return g.integers(-8, 9, shape).astype(np.float32)
    return g.standard_normal(shape).astype(np.float32)


def twin(n, s_dim, seed, A, rowwise):
    jkey = jax.random.key_data(jsk.FJLT(n, s_dim, JContext(seed),
                                        fut="wht").allocation.key)
    return np.asarray(jfjlt.srht_serve_apply(jkey, jnp.asarray(A),
                                             s_dim=s_dim, rowwise=rowwise))


def hold(n, s_dim, shape, rowwise, dyadic, seed=5):
    T = sk.FJLT(n, s_dim, Context(seed), fut="wht")
    A = operand(shape, dyadic, seed + 1)
    got = replay(T.allocation.key, torch.from_numpy(A), s_dim, rowwise)
    plain = cuda_fwht.srht_apply_plain(T.allocation.key, torch.from_numpy(A),
                                       s_dim, rowwise)
    want = twin(n, s_dim, seed, A, rowwise)
    assert got.shape == plain.shape == want.shape
    if dyadic or n < 512:  # exact, or the plain version's butterfly too
        assert torch.equal(got, plain)
    if dyadic:
        assert np.array_equal(got.numpy(), want)
    assert np.abs(got.numpy() - want).max() <= ORACLE * np.abs(want).max()
    return got


@pytest.mark.parametrize("n", [128, 4096, 8192, 16384])
def test_register_wht_is_the_butterfly(n):
    x = torch.from_numpy(operand((3, n), False, n))
    assert torch.equal(register_wht(x), _wht_butterfly(x, axis=1))


@pytest.mark.parametrize("n,s_dim,dyadic", [
    (128, 64, False), (4096, 256, True), (4096, 1024, False),
    (8192, 1024, False), (16384, 2048, True), (16384, 300, False)])
def test_whole_rows_and_the_direct_gather(n, s_dim, dyadic):
    p = cuda_fwht.plan(n, 5, True)
    assert (p["seg_bits"], p["segments"], p["groups"]) == (
        n.bit_length() - 1, 1, 1)
    hold(n, s_dim, (5, n), True, dyadic)


@pytest.mark.parametrize("m,groups", [(37, 4), (200, 1)])
@pytest.mark.parametrize("dyadic", [True, False])
def test_folded_segments_of_16384_at_65536(m, groups, dyadic):
    p = cuda_fwht.plan(65536, m, True)
    assert (p["seg_bits"], p["segments"], p["groups"]) == (14, 4, groups)
    hold(65536, 2048, (m, 65536), True, dyadic)


# columnwise runs by (n, m): the runs double until ⌈m/8⌉ blocks × runs
# reach 132, at most one run a segment
COL_GROUPS = {(128, 9): 1, (2048, 20): 1, (4096, 20): 2, (8192, 37): 4,
              (65536, 9): 32, (65536, 513): 4}


@pytest.mark.parametrize("n,m,s_dim,dyadic,segments", [
    (128, 9, 16, False, 1), (2048, 20, 512, False, 1),
    (4096, 20, 256, True, 2), (8192, 37, 1024, False, 4),
    (65536, 9, 2048, True, 32), (65536, 513, 2048, False, 32)])
def test_columnwise_strips_and_segments_of_2048(n, m, s_dim, dyadic,
                                               segments):
    p = cuda_fwht.plan(n, m, False)
    assert p["seg_bits"] == min(11, n.bit_length() - 1)
    assert p["segments"] == segments
    assert p["groups"] == COL_GROUPS[(n, m)]
    if m > 64:  # the plan of the SRHT-LS shape; replay a narrow slice
        m = 24
    hold(n, s_dim, (n, m), False, dyadic)


def test_columnwise_load_stage_is_conflict_free():
    """The load stage's slots (element i of column c at swz(c·NB + i) ^
    (c << 2)) are a permutation of the 8 columns' buffer; each warp's
    store of 4 rows × 8 columns hits 32 banks, and each warp's read in
    window 0 too."""
    def swz(v):
        return v ^ (((v >> 5) & 15) | (((v >> 8) & 1) << 4))

    NB, T = 2048, 128
    q = torch.arange(8 * NB)
    c, i = q & 7, q >> 3
    slot = swz(c * NB + i) ^ (c << 2)
    assert torch.equal(torch.sort(slot).values, torch.arange(8 * NB))
    banks = (slot % 32).reshape(-1, 32)
    assert all(len(set(w.tolist())) == 32 for w in banks)
    tid = torch.arange(8 * T)
    g, t = tid // T, tid % T
    for j in range(16):
        rd = (swz(g * NB + (t << 4) + j) ^ (g << 2)) % 32
        assert all(len(set(w.tolist())) == 32 for w in rd.reshape(-1, 32))


@pytest.mark.parametrize("n", [1 << k for k in range(7, 19)])
@pytest.mark.parametrize("m", [1, 9, 37, 513, 8192, 1 << 20])
@pytest.mark.parametrize("rowwise", [True, False])
def test_plan_reads_one_lane_and_fits_the_card(n, m, rowwise):
    """The runs reach the card's 132 SMs with the fewest runs: a fold's
    block takes one row or 8 columns, and halving the runs would leave the
    lane short of 132 blocks."""
    p = cuda_fwht.plan(n, m, rowwise)
    assert p == cuda_fwht.plan(n, m, rowwise)  # no lane count, no state
    assert p["seg_bits"] == min(n.bit_length() - 1, 14 if rowwise else 11)
    assert p["segments"] << p["seg_bits"] == n
    g = p["groups"]
    assert g & (g - 1) == 0 and p["segments"] % g == 0
    blocks = m if rowwise else -(-m // 8)
    assert blocks * g >= min(132, blocks * p["segments"])
    assert g == 1 or blocks * (g // 2) < 132


@pytest.mark.parametrize("rowwise", [True, False])
def test_lane_axis_plain_route_is_lane_by_lane(rowwise):
    kd = np.stack([Context(40 + b).allocate().key for b in range(3)])
    shape = (3, 11, 4096) if rowwise else (3, 4096, 11)
    A = torch.from_numpy(operand(shape, False, 3))
    got = cuda_fwht.srht_apply_batched(kd, A, 256, rowwise)
    for b in range(3):
        assert torch.equal(got[b], cuda_fwht.srht_apply(kd[b], A[b], 256,
                                                        rowwise))
    assert cuda_fwht.launches["fwht_batched"] == 0
    assert math.isfinite(float(got.abs().max()))


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("lanes,vectors", [(2, 0), (0, 5)])
def test_an_empty_operand_launches_and_counts_nothing(rowwise, lanes,
                                                      vectors):
    """The launch path returns before it loads the kernel when a cohort has
    no vectors or no lanes, and counts no launch."""
    kd = np.zeros((lanes, 2), dtype=np.uint32)
    shape = (lanes, vectors, 256) if rowwise else (lanes, 256, vectors)
    before = dict(cuda_fwht.launches)
    out = cuda_fwht._launch(kd, torch.zeros(shape), 64, rowwise,
                            "fwht_batched")
    assert out.shape == ((lanes, vectors, 64) if rowwise
                         else (lanes, 64, vectors))
    assert cuda_fwht.launches == before
