"""The port's hash sketches (CWT, MMT, WZT) against the JAX package, on
the CPU.

On a CPU tensor the CountSketch kernel's wrapper runs its plain version,
the sequential scatter in increasing coordinate order. With ±1 values
every product is exact and the reference's CPU ``segment_sum`` adds in
the same order, so the bucket and value streams, ``CWT.apply`` both ways,
``cwt_serve_apply`` and the plain version are held **bit-equal** to the
reference's ``HashTransform.apply`` and ``hash.cwt_serve_apply`` — never
to the Pallas kernel's interpret output (ROADMAP C1). MMT and WZT values
go through tan and log1p/pow, which round by backend: applies relative
≤ 1e-5 of max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import hash as jhash
from libskylark_tpu_torch import interop
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_hash, hash as phash

VALUE_BOUND = 1e-5

# (N, S): ragged in one chunk, over chunk boundaries with a span that is
# not a power of two (randint's multiplier is nonzero), a power-of-two S
SHAPES = [(700, 48), (9000, 300), (5000, 256)]


def _operand(n, m, rowwise, seed=0):
    A = np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)
    return np.ascontiguousarray(A.T) if rowwise else A


def _dims(rowwise):
    return ((jsk.ROWWISE, sk.ROWWISE) if rowwise
            else (jsk.COLUMNWISE, sk.COLUMNWISE))


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    for k in cuda_hash.launches:
        cuda_hash.launches[k] = 0


@pytest.mark.parametrize("n,s", SHAPES)
def test_streams_bit_equal(n, s):
    jT, T = jsk.CWT(n, s, JContext(5)), sk.CWT(n, s, Context(5))
    np.testing.assert_array_equal(T.bucket_indices().numpy(),
                                  np.asarray(jT.bucket_indices()))
    np.testing.assert_array_equal(T.values().numpy(), np.asarray(jT.values()))
    h, v = cuda_hash.streams(T.allocation.key, n, s)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jT.bucket_indices()))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jT.values()))


@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("n,s", SHAPES)
def test_cwt_apply_bit_equal_to_reference(rowwise, n, s):
    jT, T = jsk.CWT(n, s, JContext(6)), sk.CWT(n, s, Context(6))
    A = _operand(n, 7, rowwise)
    jdim, dim = _dims(rowwise)
    want = np.asarray(jT.apply(jnp.asarray(A), jdim))
    got = T.apply(A, dim, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    jkey = jax.random.key_data(jT.allocation.key)
    np.testing.assert_array_equal(
        np.asarray(jhash.cwt_serve_apply(jkey, jnp.asarray(A), s_dim=s,
                                         rowwise=rowwise)), want)
    for fn in (lambda: phash.cwt_serve_apply(T.allocation.key,
                                             torch.from_numpy(A), s_dim=s,
                                             rowwise=rowwise),
               lambda: cuda_hash.cwt_apply(T.allocation.key,
                                           torch.from_numpy(A), s, rowwise),
               lambda: cuda_hash.cwt_apply_plain(T.allocation.key,
                                                 torch.from_numpy(A), s,
                                                 rowwise)):
        np.testing.assert_array_equal(fn().numpy(), want)
    assert cuda_hash.launches == {"hash_rowwise": 0, "hash_columnwise": 0,
                                  "hash_batched": 0, "hash_offset": 0}


def test_cwt_zero_padding_past_n_is_exact():
    T = sk.CWT(700, 48, Context(2))
    A = torch.from_numpy(_operand(700, 3, False))
    padded = torch.cat([A, torch.zeros(324, 3)])
    np.testing.assert_array_equal(
        phash.cwt_serve_apply(T.allocation.key, padded, s_dim=48,
                              rowwise=False).numpy(),
        T.apply(A, sk.COLUMNWISE, device="cpu").numpy())


@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("n0,n", [(0, 700), (300, 400), (1000, 4096),
                                  (4090, 9), (5000, 3000)])
def test_cwt_offset_scatter_is_its_rows_of_the_whole(rowwise, n0, n):
    """B2's plain version with ``n0``: a shard's coordinates [n0, n0 + n)
    hashed by their global index equal, bit for bit, the scatter of a
    full-length operand that holds the shard at rows n0… and zeros
    elsewhere (over chunk boundaries, and a shard inside one chunk)."""
    key = Context(9).allocate().key
    N, s = 8192, 300
    shard = _operand(n, 5, rowwise, seed=3)
    whole = np.zeros((5, N) if rowwise else (N, 5), np.float32)
    if rowwise:
        whole[:, n0:n0 + n] = shard
    else:
        whole[n0:n0 + n] = shard
    got = cuda_hash.cwt_apply(key, torch.from_numpy(shard), s, rowwise, n0)
    want = cuda_hash.cwt_apply_plain(key, torch.from_numpy(whole), s,
                                     rowwise)
    assert torch.equal(got, want)


def test_cwt_vector_operand():
    jT, T = jsk.CWT(300, 16, JContext(1)), sk.CWT(300, 16, Context(1))
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    np.testing.assert_array_equal(
        T.apply(x, sk.COLUMNWISE, device="cpu").numpy(),
        np.asarray(jT.apply(jnp.asarray(x), jsk.COLUMNWISE)))


def test_kernel_route_rule():
    assert cuda_hash.supported(torch.float32)
    assert not cuda_hash.supported(torch.float64)
    assert sk.CWT(10, 4, Context(0))._kernel_serves(torch.ones(10, 1))
    assert not sk.MMT(10, 4, Context(0))._kernel_serves(torch.ones(10, 1))


@pytest.mark.parametrize("cls,kw", [("MMT", {}), ("WZT", {"p": 1.5})])
@pytest.mark.parametrize("rowwise", [False, True])
def test_mmt_wzt_apply_match_reference(cls, kw, rowwise):
    jT = getattr(jsk, cls)(5000, 64, JContext(4), **kw)
    T = getattr(sk, cls)(5000, 64, Context(4), **kw)
    np.testing.assert_array_equal(T.bucket_indices().numpy(),
                                  np.asarray(jT.bucket_indices()))
    A = _operand(5000, 5, rowwise)
    jdim, dim = _dims(rowwise)
    want = np.asarray(jT.apply(jnp.asarray(A), jdim))
    got = T.apply(A, dim, device="cpu").numpy()
    assert np.abs(got - want).max() <= VALUE_BOUND * np.abs(want).max()


@pytest.mark.parametrize("cls,kw", [("CWT", {}), ("MMT", {}),
                                    ("WZT", {"p": 1.25})])
def test_reference_json_loads_as_the_same_operator(cls, kw):
    jT = getattr(jsk, cls)(900, 32, JContext(13, 2), **kw)
    T = interop.transform_from_reference(jT.to_json())
    assert type(T).__name__ == cls and T.to_dict() == {
        **jT.to_dict(), "skylark_version": T.to_dict()["skylark_version"]}
    np.testing.assert_array_equal(T.bucket_indices().numpy(),
                                  np.asarray(jT.bucket_indices()))
    back = jsk.deserialize_sketch(T.to_json())
    np.testing.assert_array_equal(np.asarray(back.bucket_indices()),
                                  T.bucket_indices().numpy())
