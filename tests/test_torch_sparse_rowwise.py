"""Kernel B3 rowwise (csrc/sparse_sketch.cu) on the CPU: the arithmetic
it depends on, against the port's streams and the JAX package.

The CUDA kernel cannot run here, so these tests hold:

- the chunk-key table it derives once per (lane, chunk) —
  ``cuda_sparse.chunk_table`` and ``hash_columns``, its plain helpers —
  gives h and v ``torch.equal`` to ``randgen``'s counter streams
  (``cuda_hash.streams``) at every column, for n = 47236 (rcv1), 2^21
  (512 chunks) and a ragged n, with randint's multiplier zero (s = 1024)
  and not (s = 300, s = 7);
- the rowwise plain scatter that the kernel is bit-equal to on the card
  (``cwt_sparse_apply_batched`` on CPU lanes) is bit-equal to the JAX
  package's ``cwt_sparse_serve_apply`` lane by lane on the new chip
  cases: outputs wider than the kernel's on-chip row (s = 2048, 8192), a
  row of more than 1024 nonzeros, an all-padding lane;
- the row ids the kernel route asks for in int32 are the int64 ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libskylark_tpu.sketch import sparse_serve as jsparse_serve
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_hash, cuda_sparse, sparse_serve


def _key(seed):
    return np.asarray(Context(seed).allocate().key, np.uint32)


@pytest.mark.parametrize("n", [47236, 1 << 21, 12305])
@pytest.mark.parametrize("s_dim", [1024, 300, 7])
def test_chunk_table_gives_the_streams_at_every_column(n, s_dim):
    kd = _key(n % 97 + s_dim)
    table = cuda_sparse.chunk_table(kd, n)
    assert table.shape == (cuda_sparse.rowwise_chunks(n), 6)
    h, v = cuda_sparse.hash_columns(table, np.arange(n), s_dim)
    want_h, want_v = cuda_hash.streams(kd, n, s_dim)
    assert torch.equal(h, want_h) and torch.equal(v, want_v)
    assert (randgen.randint_multiplier(s_dim) != 0) == (s_dim != 1024)


def test_chunk_table_is_the_kernel_key_algebra():
    """Entry c: fold_in(chunk_key(kh, c), 1), fold_in(chunk_key(kh, c),
    0), chunk_key(kv, c), with kh, kv the lane's sub-stream keys."""
    kd = _key(3)
    table = cuda_sparse.chunk_table(kd, 3 * randgen.CHUNK + 1)
    kh = randgen.fold_in_batched(kd[None], 0)[0]
    kv = randgen.fold_in_batched(kd[None], 1)[0]
    for c in range(4):
        ck = randgen.chunk_key(kh, c)
        lo = randgen.fold_in_batched(np.asarray(ck)[None], 1)[0]
        hi = randgen.fold_in_batched(np.asarray(ck)[None], 0)[0]
        assert list(table[c]) == [*lo, *hi, *randgen.chunk_key(kv, c)]


def _lanes(B, rows, cols, density, seed, variant=None):
    """B CSR lanes padded to one nnz class as the serve layer pads them
    (value 0.0 at column 0 in the last row): (data, indices, indptr)
    stacks and the padded shape. ``"long_row"`` fills row 1 at every
    column; ``"empty_lane"`` leaves lane 1 with padding only."""
    g = np.random.default_rng(seed)
    lanes = []
    for b in range(B):
        dense = np.where(g.random((rows, cols)) < density,
                         g.standard_normal((rows, cols)), 0.0)
        if variant == "long_row":
            dense[1] = g.standard_normal(cols)
        if variant == "empty_lane" and b == 1:
            dense[:] = 0.0
        r, c = np.nonzero(dense)
        lanes.append((dense[r, c].astype(np.float32), c.astype(np.int32),
                      np.concatenate([[0], np.cumsum(
                          np.bincount(r, minlength=rows))]).astype(np.int32)))
    nnz = 1 << max(4, max(len(d) for d, _, _ in lanes).bit_length())
    data = np.zeros((B, nnz), np.float32)
    idx = np.zeros((B, nnz), np.int32)
    for b, (d, c, _) in enumerate(lanes):
        data[b, :len(d)], idx[b, :len(d)] = d, c
    ptr = np.stack([p for _, _, p in lanes])
    return data, idx, ptr, (rows, cols)


@pytest.mark.parametrize("case", [
    (2, 50, 3000, 0.01, 2048, None),
    (2, 30, 2000, 0.01, 8192, None),
    (2, 20, 1500, 0.002, 64, "long_row"),
    (3, 30, 5000, 0.02, 300, "empty_lane"),
])
def test_rowwise_plain_scatter_matches_the_reference(case):
    B, rows, cols, density, s_dim, variant = case
    data, idx, ptr, shape = _lanes(B, rows, cols, density, s_dim, variant)
    kd = np.stack([_key(40 + b) for b in range(B)])
    rid = sparse_serve.csr_row_ids(torch.from_numpy(ptr).long(),
                                   data.shape[1])
    got = cuda_sparse.cwt_sparse_apply_batched(
        kd, torch.from_numpy(data), rid, torch.from_numpy(idx), s_dim, True,
        shape)
    assert got.shape == (B, rows, s_dim)
    if variant == "long_row":
        assert (np.diff(ptr[0])[1] > 1024)
    if variant == "empty_lane":
        assert not got[1].any()
    for b in range(B):
        want = np.asarray(jsparse_serve.cwt_sparse_serve_apply(
            kd[b], jnp.asarray(data[b]), jnp.asarray(idx[b]),
            jnp.asarray(ptr[b]), s_dim=s_dim, rowwise=True, shape=shape))
        assert np.array_equal(got[b].numpy(), want)
    assert not any(cuda_sparse.launches.values())


@pytest.mark.parametrize("batched", [False, True])
def test_row_ids_in_int32_are_the_int64_ones(batched):
    _, _, ptr, _ = _lanes(3, 40, 300, 0.05, 1)
    ptr = torch.from_numpy(ptr).long()
    if not batched:
        ptr = ptr[0]
    r64 = sparse_serve.csr_row_ids(ptr, 512)
    r32 = sparse_serve.csr_row_ids(ptr, 512, torch.int32)
    assert r64.dtype == torch.int64 and r32.dtype == torch.int32
    assert torch.equal(r32.long(), r64)


def test_rowwise_chunks_cover_every_column():
    assert cuda_sparse.rowwise_chunks(47236) == 12
    assert cuda_sparse.rowwise_chunks(1 << 21) == 512
    assert cuda_sparse.rowwise_chunks(4096) == 1
    assert cuda_sparse.rowwise_chunks(4097) == 2
