"""Kernel B4's phase plan (csrc/fastfood.cu, its register WHT in
csrc/wht.cuh), modelled in torch on the CPU, against the butterfly it
must reproduce bit for bit and against the JAX package.

The CUDA kernel cannot run here, so these tests hold the arithmetic it
depends on:

- a model of its WHT — each thread's register levels over its window of
  index bits, the swizzled shared-memory exchanges between windows, the
  last window's layout — is ``torch.equal`` to ``fut._wht_butterfly`` for
  every NB from 2 to 16384, on float32 Gaussian data (where a different
  sum order would change bits);
- the gather placed in the exchange (u written in natural order, read at
  ``perm``) and the whole fused chain on that model agree with the plain
  version and with the JAX package's Pallas kernel in interpret mode,
  max |Δ| ≤ 1e-4·max|ref|;
- the swizzle is a permutation of each group's buffer and leaves the main
  path's exchanges free of bank conflicts;
- ``plan`` reads one lane's shape only and stays within 1024 threads and
  227 KB of shared memory.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import pallas_fastfood as jpf
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_fastfood as cf
from libskylark_tpu_torch.sketch.fut import _wht_butterfly

ORACLE = 1e-4  # relative to max |reference|
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
ALL_NB = [1 << k for k in range(1, 15)]


def swz(n):
    """csrc/wht.cuh ``swz``."""
    return n ^ (((n >> 5) & 15) | (((n >> 8) & 1) << 4))


def lay(t, j, lo, L):
    """The element that value j of thread t holds in window [lo, lo + L)
    (csrc/wht.cuh: ``tpart(t, lo) | j << lo``)."""
    return (t & ((1 << lo) - 1)) | (j << lo) | ((t >> lo) << (lo + L))


class Model:
    """The kernel's steps on a (rows, NB) float32 tensor. ``regs`` is
    (blocks, groups, T, V): value j of thread t of group g; the exchange
    buffer is (blocks, groups·NB) per block."""

    def __init__(self, NB, m):
        self.NB, self.k = NB, NB.bit_length() - 1
        p = cf.plan(NB, m)
        self.L, self.T, self.G = p["levels"], p["threads"], p["groups"]
        self.V = 1 << self.L
        t = torch.arange(self.T)[:, None]
        j = torch.arange(self.V)[None, :]
        self.lay = lambda lo: lay(t, j, lo, self.L)
        self.base = (torch.arange(self.G) * NB)[:, None, None]

    def to_regs(self, x, lo=0):
        """Rows (blocks·G, NB) in window lo's layout."""
        return x.reshape(-1, self.G, self.NB)[:, :, self.lay(lo)]

    def from_regs(self, regs, lo):
        out = torch.empty(regs.shape[0], self.G, self.NB, dtype=regs.dtype)
        out[:, :, self.lay(lo)] = regs
        return out.reshape(-1, self.NB)

    def levels(self, regs, qa, qb):
        for q in range(qa, qb):
            r = regs.reshape(*regs.shape[:3], self.V >> (q + 1), 2, 1 << q)
            a, b = r[..., 0, :], r[..., 1, :]
            regs = torch.stack([a + b, a - b], dim=-2).reshape(regs.shape)
        return regs

    def write(self, regs, lo):
        buf = torch.full((regs.shape[0], self.G * self.NB), float("nan"))
        slot = swz(self.base + self.lay(lo)).reshape(-1)
        buf[:, slot] = regs.reshape(regs.shape[0], -1)
        return buf

    def read(self, buf, idx):
        """Values at block-wide elements ``base + idx`` (idx (G, T, V) or
        broadcastable)."""
        return buf[:, swz(self.base + idx).reshape(-1)].reshape(
            buf.shape[0], self.G, self.T, self.V)

    def wht(self, regs):
        regs = self.levels(regs, 0, self.L)
        lo = 0
        for p in range(self.L, self.k, self.L):
            nlo = min(p, self.k - self.L)
            regs = self.read(self.write(regs, lo), self.lay(nlo))
            regs = self.levels(regs, p - nlo, min(p + self.L, self.k) - nlo)
            lo = nlo
        return regs

    def gather(self, regs, perm, gdiag):
        """The gather exchange: u written in window k − L's layout, read
        at perm for window 0's positions, times scal·G."""
        buf = self.write(regs, self.k - self.L)
        i = self.lay(0)
        return gdiag[i] * self.read(buf, perm[i])


def _levels_high_first(x):
    """The same transform with its levels in the opposite order (h =
    NB/2 first): equal in exact arithmetic, not in float32."""
    m, NB = x.shape
    h = NB // 2
    while h:
        r = x.reshape(m, NB // (2 * h), 2, h)
        x = torch.stack([r[:, :, 0] + r[:, :, 1], r[:, :, 0] - r[:, :, 1]],
                        dim=2).reshape(m, NB)
        h //= 2
    return x


def _pad_rows(x, G):
    m = x.shape[0]
    return torch.cat([x, x.new_zeros((-m % G, x.shape[1]))]), m


def model_wht(x):
    """The kernel's WHT of each row of x (rows, NB)."""
    M = Model(x.shape[1], x.shape[0])
    xp, m = _pad_rows(x, M.G)
    regs = M.wht(M.to_regs(xp))
    return M.from_regs(regs, M.k - M.L)[:m]


def model_fused(T, A):
    """The fused kernel's chain on the model: (m, S) features."""
    streams = cf.kernel_streams(T, "cpu")
    bdiag, perms, gdiag, smdiag, sh = streams
    nb, NB = bdiag.shape
    m = A.shape[0]
    M = Model(NB, m)
    X = torch.nn.functional.pad(A, (0, NB - A.shape[1]))
    X, _ = _pad_rows(X, M.G)
    feats = []
    for b in range(nb):
        x = M.to_regs(X) * bdiag[b][M.lay(0)]
        u = M.wht(x)
        v = M.wht(M.gather(u, perms[b], gdiag[b]))
        i = M.lay(M.k - M.L)
        z = smdiag[b][i] * v + sh[b][i]
        feats.append(M.from_regs(T.scale * torch.cos(z), M.k - M.L)[:m])
    return torch.cat(feats, dim=1)[:, :T._S]


@pytest.mark.parametrize("NB", ALL_NB)
def test_phase_plan_is_the_butterfly_bit_for_bit(NB):
    g = np.random.default_rng(NB)
    G = cf.plan(NB, 1)["groups"]
    m = 3 if NB >= 4096 else G + 3   # several groups, the last one ragged
    x = torch.from_numpy(g.standard_normal((m, NB)).astype(np.float32))
    want = _wht_butterfly(x, axis=1)
    got = model_wht(x)
    assert torch.equal(got, want)
    if NB >= 64:  # the sum order matters here: another order moves bits
        other = torch.allclose(_levels_high_first(x), want, rtol=1e-5,
                               atol=1e-4)
        assert other and not torch.equal(_levels_high_first(x), want)


@pytest.mark.parametrize("NB", ALL_NB)
def test_swizzle_permutes_each_buffer(NB):
    G = cf.plan(NB, 1)["groups"]
    n = torch.arange(G * NB)
    assert torch.equal(torch.sort(swz(n)).values, n)


@pytest.mark.parametrize("NB", ALL_NB)
def test_swizzle_splits_into_thread_part_and_value_constant(NB):
    """The kernel addresses slot swz(base + lay(t, j, lo)) as
    swz(base | thread part) ^ swz(j << lo): swz is linear over XOR and
    the three parts lie on disjoint bits."""
    p = cf.plan(NB, 1)
    L, T, G, k = p["levels"], p["threads"], p["groups"], NB.bit_length() - 1
    g = torch.arange(G)[:, None, None]
    t = torch.arange(T)[None, :, None]
    j = torch.arange(1 << L)[None, None, :]
    for lo in sorted({min(q, k - L) for q in range(0, k, L)}):
        tp = (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + L))
        assert torch.equal(swz(g * NB + lay(t, j, lo, L)),
                           swz(g * NB | tp) ^ swz(j << lo))
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(NB))
    assert torch.equal(swz(g * NB + perm), swz(g * NB) ^ swz(perm))


def warp_local(NB, lo, nlo):
    """csrc/wht.cuh ``warp_local``: the element bits that select the
    holder's warp are the same in both windows (or a row group fits in a
    warp)."""
    p = cf.plan(NB, 1)
    L, T, k = p["levels"], p["threads"], NB.bit_length() - 1

    def bits(lo):
        return {q if q < lo else q + L for q in range(5, k - L)}
    return T <= 32 or bits(lo) == bits(nlo)


@pytest.mark.parametrize("NB", ALL_NB)
def test_warp_local_exchanges_stay_in_their_warp(NB):
    """Every exchange the kernel runs with warp barriers only moves each
    element between threads of one warp; the gather crosses warps unless
    a row group fits in a warp. At NB = 4096 a row takes three block
    barriers (WHT1 4 → 8, the gather, WHT2 4 → 8)."""
    p = cf.plan(NB, 1)
    L, T, G, k = p["levels"], p["threads"], p["groups"], NB.bit_length() - 1
    tid = torch.arange(G * T)
    g, t = tid // T, tid % T
    windows = [0] + [min(q, k - L) for q in range(L, k, L)]
    barriers = 0
    for lo, nlo in zip(windows, windows[1:]):
        holder = {}
        for j in range(1 << L):
            for th, e in zip(tid.tolist(), (g * NB + lay(t, j, lo, L)).tolist()):
                holder[e] = th // 32
        moved = {(g * NB + lay(t, j, nlo, L))[i].item(): tid[i].item() // 32
                 for j in range(1 << L) for i in range(G * T)}
        same = all(holder[e] == w for e, w in moved.items())
        if warp_local(NB, lo, nlo):
            assert same, (lo, nlo)
        else:
            barriers += 1
    barriers = 2 * barriers + (T > 32)
    if NB == 4096:
        assert barriers == 3
    if T <= 32:
        assert barriers == 0


@pytest.mark.parametrize("NB", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_main_exchanges_are_free_of_bank_conflicts(NB):
    """Every warp's 32 accesses of one value j hit 32 banks, in each
    window the WHT visits (a warp is 32 consecutive threads of the
    block; with G groups, thread g·T + t)."""
    p = cf.plan(NB, 1)
    L, T, G, k = p["levels"], p["threads"], p["groups"], NB.bit_length() - 1
    tid = torch.arange(G * T)
    g, t = tid // T, tid % T
    windows = sorted({min(q, k - L) for q in range(0, k, L)})
    for lo in windows:
        for j in range(1 << L):
            bank = swz(g * NB + lay(t, j, lo, L)) % 32
            for w in range(0, G * T, 32):
                assert len(set(bank[w:w + 32].tolist())) == 32, (lo, j, w)


@pytest.mark.parametrize("NB", ALL_NB)
@pytest.mark.parametrize("m", [1, 37, 2048, 16384, 1 << 20])
def test_plan_reads_one_lane_and_fits_the_card(NB, m):
    p = cf.plan(NB, m)
    assert p == cf.plan(NB, m)  # no lane count, no state
    assert p["block"] == p["groups"] * p["threads"] <= 1024
    assert p["block"] >= min(256, p["block"])
    assert p["threads"] << p["levels"] == NB
    assert p["smem"] <= SMEM_LIMIT
    assert p["groups"] * p["rows"] * p["grid_rows"] >= m
    assert 1 <= p["rows"] <= 16


def test_plan_fills_the_card_at_the_main_shape():
    p = cf.plan(4096, 16384)
    assert (p["levels"], p["threads"], p["groups"]) == (4, 256, 1)
    assert p["rows"] == 16 and p["grid_rows"] == 1024
    assert p["smem"] == 49152


@pytest.mark.parametrize("N,S", [(1000, 3000), (2048, 2048), (5, 7),
                                 (40, 64)])
def test_model_chain_matches_plain_and_reference(N, S):
    sigma = math.sqrt(N)
    T = sk.FastGaussianRFT(N, S, Context(3), sigma=sigma)
    jT = jsk.FastGaussianRFT(N, S, JContext(3), sigma=sigma)
    A = np.random.default_rng(4).standard_normal((11, N)).astype(np.float32)
    got = model_fused(T, torch.from_numpy(A))
    plain = cf.fastfood_plain(T, torch.from_numpy(A))
    assert got.shape == plain.shape == (11, S)
    assert (got - plain).abs().max() <= ORACLE * plain.abs().max()
    want = np.asarray(jpf.features_rows(jT, jnp.asarray(A), interpret=True,
                                        precision="f32", variant="fused"))
    assert np.abs(got.numpy() - want).max() <= ORACLE * np.abs(want).max()


def test_split_model_first_kernel_is_the_butterfly():
    """B4-split's first kernel output W (nb, m, NB) is the model's WHT of
    B ⊙ x, x zero-padded: chip_smoke.py holds the card's W to exactly
    this."""
    T = sk.FastGaussianRFT(1000, 3000, Context(8), sigma=math.sqrt(1000))
    bdiag = cf.kernel_streams(T, "cpu")[0]
    A = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (5, 1000)).astype(np.float32))
    X = torch.nn.functional.pad(A, (0, T._NB - 1000))
    W = torch.stack([model_wht(bdiag[b] * X) for b in range(T._numblks)])
    assert torch.equal(W, _wht_butterfly(bdiag[:, None, :] * X[None],
                                         axis=2))
