"""The port's Threefry stream and key derivation against the JAX package.

Everything here is integer arithmetic, so the bar is bit-equality:
``threefry2x32`` on random counters and keys, ``Allocation.key`` against
``jax.random.key_data`` of the reference's allocation, and ``chunk_key``
across the hi/lo fold at 2^31.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from libskylark_tpu.base import randgen as jrandgen
from libskylark_tpu.base import threefry as jthreefry
from libskylark_tpu.base.context import Allocation as JAllocation
from libskylark_tpu_torch import interop
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import randgen, threefry
from libskylark_tpu_torch.base.context import Allocation, fold_in, seed_key


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_bits_equal_reference(seed):
    rng = np.random.default_rng(seed)
    k0, k1 = (int(w) for w in _words(rng, 2))
    c0, c1 = _words(rng, (8, 64)), _words(rng, (8, 64))
    want0, want1 = jthreefry.threefry2x32(
        np.uint32(k0), np.uint32(k1), jnp.asarray(c0, jnp.uint32),
        jnp.asarray(c1, jnp.uint32))
    got0, got1 = threefry.threefry2x32(
        k0, k1, torch.from_numpy(c0.astype(np.int64)),
        torch.from_numpy(c1.astype(np.int64)))
    np.testing.assert_array_equal(got0.numpy(), np.asarray(want0, np.int64))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1, np.int64))


def test_threefry_same_bits_on_ints_numpy_and_tensors():
    rng = np.random.default_rng(3)
    k0, k1 = (int(w) for w in _words(rng, 2))
    c = _words(rng, (2, 16)).astype(np.int64)
    as_np = threefry.threefry2x32(k0, k1, c[0], c[1])
    as_t = threefry.threefry2x32(k0, k1, torch.from_numpy(c[0]),
                                 torch.from_numpy(c[1]))
    for i in (0, 5, 15):
        as_int = threefry.threefry2x32(k0, k1, int(c[0, i]), int(c[1, i]))
        for w in range(2):
            assert as_int[w] == int(as_np[w][i]) == int(as_t[w][i])


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
@pytest.mark.parametrize("path", [(), (3, 17)])
def test_allocation_key_equals_reference(seed, path):
    want = np.asarray(jr.key_data(JAllocation(seed, 5, path).key))
    got = Allocation(seed, 5, path).key
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_seed_key_and_fold_in_equal_reference():
    for seed in (0, 9, 2**31 - 1):
        k = jr.key(seed)
        np.testing.assert_array_equal(seed_key(seed),
                                      np.asarray(jr.key_data(k), np.uint32))
        for d in (0, 1, 2**31 + 7, 2**32 - 1):
            np.testing.assert_array_equal(
                fold_in(seed_key(seed), d),
                np.asarray(jr.key_data(jr.fold_in(k, d)), np.uint32))


@pytest.mark.parametrize("cid", [0, 5, 2**31 + 3])
def test_chunk_key_equals_reference(cid):
    jkey = JAllocation(42, 3).key
    want = np.asarray(jr.key_data(jrandgen.chunk_key(jkey, cid)), np.uint32)
    key = Allocation(42, 3).key
    np.testing.assert_array_equal(randgen.chunk_key(key, cid), want)
    np.testing.assert_array_equal(randgen.chunk_keys(key, cid, 2)[0], want)


def test_chunk_keys_table_matches_chunk_key():
    key = Allocation(7, 0).key
    table = randgen.chunk_keys(key, 2**31 - 2, 4)
    for i in range(4):
        np.testing.assert_array_equal(
            table[i], randgen.chunk_key(key, 2**31 - 2 + i))


def test_key_from_numpy_round_trips_reference_key_data():
    kd = np.asarray(jr.key_data(JAllocation(11, 2, (4,)).key))
    np.testing.assert_array_equal(interop.key_from_numpy(kd),
                                  Allocation(11, 2, (4,)).key)
    with pytest.raises(errors.InvalidParametersError):
        interop.key_from_numpy(np.zeros(3, np.uint32))


def test_normal_tail_sqrt_is_correctly_rounded_on_the_cpu():
    """The w >= 5 branch of erfinv_f32 takes its sqrt in float64 with two
    Newton steps on the CPU: the float32 root is the correctly rounded
    one, whatever torch's float32 sqrt returned on that call."""
    w = torch.from_numpy(np.random.default_rng(16).uniform(
        5.0, 17.0, 1 << 17).astype(np.float32))
    want = torch.from_numpy(np.sqrt(w.numpy().astype(np.float64))
                            .astype(np.float32))
    assert torch.equal(threefry._sqrt(w), want)
