"""Kernel B2's plan (csrc/hash_sketch.cu), replayed in torch on the CPU,
against the plain version and the JAX package.

The CUDA kernel cannot run here, so these tests hold the order of
operations it depends on, and that order must give the sequential
scatter's bits (every v·a is exact, so only the order of the adds
matters):

- rowwise, a warp per row: the row's coordinates in batches of 32, in
  increasing j; each batch added into the on-chip output row at once
  when its buckets are distinct, else rank by rank, the rank of a
  coordinate being the number of earlier coordinates of its batch with
  the same bucket (what ``hash_table_kernel`` takes from
  ``__match_any_sync``, once a lane); rows wider than 1024 buckets in
  tiles of 1024;
- columnwise: each 1024-coordinate tile (inside one stream chunk) sorted by
  (bucket, j), each bucket's first sorted position, and a bucket's
  coordinates walked tile by tile, in sorted order, into its row;
- both ``torch.equal`` to ``cuda_hash.cwt_apply_plain`` and to the JAX
  package's ``hash.cwt_serve_apply`` (the XLA twin; not Pallas interpret
  output: ROADMAP C1's stream layout), at ragged n (5000, 12305), s = 300
  (a nonzero randint multiplier), s = 2048, and rows with many equal
  buckets;
- the lane-axis plain route is lane by lane the B = 1 call, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import hash as jhash
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_hash

ROW_BUF = 1024  # csrc/hash_sketch.cu kRowBuf: output columns a warp holds


def ranks(h):
    """Each coordinate's rank in its batch of 32 (earlier coordinates with
    the same bucket) and the batch's largest rank."""
    n = h.numel()
    pad = -(-n // 32) * 32 - n
    hb = torch.cat([h, -1 - torch.arange(pad)]).reshape(-1, 32)
    earlier = torch.ones(32, 32, dtype=torch.bool).tril(-1)
    rank = ((hb[:, :, None] == hb[:, None, :]) & earlier).sum(2)
    top = rank.max(1, keepdim=True).values.expand(-1, 32)
    return rank.reshape(-1)[:n], top.reshape(-1)[:n]


def replay_rows(key, A, s_dim):
    """The rowwise kernel's adds on A (m, n): (m, s)."""
    m, n = A.shape
    h, v = cuda_hash.streams(key, n, s_dim)
    rank, top = ranks(h)
    x = torch.where(v[None, :] < 0, -A, A)  # the sign flip
    buf_w = -(-min(s_dim, ROW_BUF) // 4) * 4
    out = torch.empty((m, s_dim), dtype=torch.float32)
    for c0 in range(0, s_dim, buf_w):
        cw = min(s_dim - c0, buf_w)
        row = torch.zeros((m, cw), dtype=torch.float32)
        for j0 in range(0, n, 32):
            sl = slice(j0, min(j0 + 32, n))
            b = h[sl] - c0
            valid = (b >= 0) & (b < cw)
            for q in range(int(top[j0]) + 1):
                sel = valid & (rank[sl] == q)  # distinct buckets
                row[:, b[sel]] = row[:, b[sel]] + x[:, sl][:, sel]
        out[:, c0:c0 + cw] = row
    return out


def sort_tiles(h, s_dim):
    """Per tile of ``cuda_hash.TILE`` coordinates: the coordinates sorted by
    (bucket, j) and off[b], the first sorted position with bucket ≥ b."""
    tiles = []
    for t0 in range(0, h.numel(), cuda_hash.TILE):
        hb = h[t0:t0 + cuda_hash.TILE]
        e = torch.arange(hb.numel())
        perm = torch.argsort(hb * (2 * cuda_hash.TILE) + 2 * e)
        off = torch.searchsorted(hb[perm], torch.arange(s_dim + 1))
        tiles.append((t0 + e[perm], off))
    return tiles


def replay_cols(key, A, s_dim):
    """The columnwise kernel's adds on A (n, m): (s, m), each bucket's
    coordinates tile by tile in sorted order."""
    n, m = A.shape
    h, v = cuda_hash.streams(key, n, s_dim)
    x = torch.where(v[:, None] < 0, -A, A)
    tiles = sort_tiles(h, s_dim)
    walk = [torch.cat([j[off[b]:off[b + 1]] for j, off in tiles])
            for b in range(s_dim)]
    for b, js in enumerate(walk):
        assert bool((h[js] == b).all()) and bool((js[1:] > js[:-1]).all())
    depth = max(len(js) for js in walk)
    J = torch.full((s_dim, depth), -1, dtype=torch.long)
    for b, js in enumerate(walk):
        J[b, :len(js)] = js
    out = torch.zeros((s_dim, m), dtype=torch.float32)
    for k in range(depth):
        sel = J[:, k] >= 0
        out[sel] = out[sel] + x[J[sel, k]]
    return out


def twin(n, s_dim, seed, A, rowwise):
    jkey = jax.random.key_data(jsk.CWT(n, s_dim, JContext(seed))
                               .allocation.key)
    return np.asarray(jhash.cwt_serve_apply(jkey, jnp.asarray(A),
                                            s_dim=s_dim, rowwise=rowwise))


def hold(shape, s_dim, rowwise, seed=3):
    n = shape[1] if rowwise else shape[0]
    T = sk.CWT(n, s_dim, Context(seed))
    A = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    At = torch.from_numpy(A)
    got = (replay_rows if rowwise else replay_cols)(T.allocation.key, At,
                                                    s_dim)
    assert torch.equal(got, cuda_hash.cwt_apply_plain(T.allocation.key, At,
                                                      s_dim, rowwise))
    assert np.array_equal(got.numpy(), twin(n, s_dim, seed, A, rowwise))


@pytest.mark.parametrize("shape,s_dim", [
    ((6, 5000), 300), ((4, 12305), 2048), ((3, 12305), 1500),
    ((5, 8192), 1024), ((5, 1000), 3)])
def test_rowwise_warp_order_with_ranked_equal_buckets(shape, s_dim):
    hold(shape, s_dim, True)


@pytest.mark.parametrize("shape,s_dim", [
    ((5000, 7), 300), ((12305, 5), 2048), ((12305, 9), 1500),
    ((8192, 6), 1024), ((1000, 4), 3)])
def test_columnwise_sorted_tiles(shape, s_dim):
    hold(shape, s_dim, False)


def test_ranks_order_equal_buckets_by_position():
    """A row of few buckets: many batches add rank by rank, and the
    ranks count each bucket's earlier lanes, 0, 1, 2, ... in lane order."""
    h, _ = cuda_hash.streams(Context(9).allocate().key, 4096, 3)
    rank, top = ranks(h)
    assert int(top.max()) >= 10
    for j0 in range(0, 4096, 32):
        hb, rb = h[j0:j0 + 32], rank[j0:j0 + 32]
        for b in range(3):
            assert torch.equal(rb[hb == b], torch.arange(int((hb == b).sum())))
    assert randgen.randint_multiplier(300) != 0  # s = 300 takes two draws


@pytest.mark.parametrize("rowwise", [True, False])
def test_lane_axis_plain_route_is_lane_by_lane(rowwise):
    kd = np.stack([Context(60 + b).allocate().key for b in range(3)])
    shape = (3, 7, 5000) if rowwise else (3, 5000, 7)
    A = torch.from_numpy(np.random.default_rng(2).standard_normal(
        shape).astype(np.float32))
    got = cuda_hash.cwt_apply_batched(kd, A, 300, rowwise)
    for b in range(3):
        assert torch.equal(got[b], cuda_hash.cwt_apply(kd[b], A[b], 300,
                                                       rowwise))
    assert cuda_hash.launches["hash_batched"] == 0


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("lanes,vectors,n", [(2, 0, 300), (2, 5, 0),
                                             (0, 5, 300)])
def test_an_empty_operand_launches_and_counts_nothing(rowwise, lanes,
                                                      vectors, n):
    """The launch path returns zeros before it loads the kernel when a
    cohort has no vectors, no coordinates or no lanes, and counts no
    launch."""
    kd = np.zeros((lanes, 2), dtype=np.uint32)
    shape = (lanes, vectors, n) if rowwise else (lanes, n, vectors)
    before = dict(cuda_hash.launches)
    out = cuda_hash._launch(kd, torch.ones(shape), 64, rowwise,
                            "hash_batched")
    assert out.shape == ((lanes, vectors, 64) if rowwise
                         else (lanes, 64, vectors))
    assert not out.any()
    assert cuda_hash.launches == before
