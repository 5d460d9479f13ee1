"""The port's counter streams and jax.random samplers against the JAX
package, on the CPU.

``bits``, ``split``, and the integer and ±1 streams (UniformInt with
power-of-two and other spans, Rademacher) and Uniform are bit-equal to
the reference across chunk boundaries and at offset slices. Normal,
Cauchy and Exponential go through erf_inv, tan and log1p, which round by
backend: Normal max |Δ| ≤ 1e-5, Cauchy and Exponential relative
(|Δ| / max(|ref|, 1)) ≤ 1e-5.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from libskylark_tpu.base import randgen as jrandgen
from libskylark_tpu.base.context import Allocation as JAllocation
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Allocation

BOUND = 1e-5

DISTS = {
    "int_pow2": (jrandgen.UniformInt(0, 1023), randgen.UniformInt(0, 1023)),
    "int_300": (jrandgen.UniformInt(0, 299), randgen.UniformInt(0, 299)),
    "int_wide": (jrandgen.UniformInt(3, 100002),
                 randgen.UniformInt(3, 100002)),
    "rademacher": (jrandgen.Rademacher(), randgen.Rademacher()),
    "uniform": (jrandgen.Uniform(), randgen.Uniform()),
    "uniform_shifted": (jrandgen.Uniform(-2.0, 3.0),
                        randgen.Uniform(-2.0, 3.0)),
    "normal": (jrandgen.Normal(), randgen.Normal()),
    "cauchy": (jrandgen.Cauchy(), randgen.Cauchy()),
    "exponential": (jrandgen.Exponential(), randgen.Exponential()),
}
EXACT = {"int_pow2", "int_300", "int_wide", "rademacher", "uniform",
         "uniform_shifted"}
# inside one chunk, across one boundary, at a boundary, over three chunks
SLICES = [(0, 4096), (1000, 9500), (4095, 4097), (8191, 20481)]


def _jkey():
    return JAllocation(42, 3).key


def _key():
    return Allocation(42, 3).key


def _assert_stream(name, got, want):
    assert got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    elif name == "normal":
        assert np.abs(got - want).max() <= BOUND
    else:
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert rel.max() <= BOUND


def test_randint_multiplier_is_nonzero_off_powers_of_two():
    assert randgen.randint_multiplier(300) != 0
    assert randgen.randint_multiplier(1024) == 0
    assert randgen.randint_multiplier(100000) == 0  # (2^16)^2 wraps to 0


@pytest.mark.parametrize("length", [1, 4096, 5000])
def test_bits_bit_equal(length):
    want = np.asarray(jr.bits(_jkey(), (length,)))
    np.testing.assert_array_equal(randgen.bits(_key(), length).numpy(), want)


@pytest.mark.parametrize("num", [2, 5])
def test_split_bit_equal(num):
    want = np.asarray(jr.key_data(jr.split(_jkey(), num)))
    np.testing.assert_array_equal(randgen.split(_key(), num), want)


def test_split_keys_matches_split_per_row():
    keys = randgen.chunk_keys(_key(), 0, 3)
    a, b = randgen.split_keys(keys)
    ta, tb = randgen.split_keys(torch.from_numpy(keys.astype(np.int64)))
    for i in range(3):
        np.testing.assert_array_equal(np.stack([a[i], b[i]]),
                                      randgen.split(keys[i]))
    np.testing.assert_array_equal(ta.numpy(), a)
    np.testing.assert_array_equal(tb.numpy(), b)


@pytest.mark.parametrize("name", list(DISTS))
@pytest.mark.parametrize("lo,hi", SLICES)
def test_stream_slice_matches_reference(name, lo, hi):
    jdist, dist = DISTS[name]
    dtype = jnp.int32 if name.startswith("int") else jnp.float32
    want = np.asarray(jrandgen.stream_slice(_jkey(), jdist, lo, hi, dtype))
    got = randgen.stream_slice(_key(), dist, lo, hi).numpy()
    _assert_stream(name, got, want)


@pytest.mark.parametrize("name", ["int_300", "rademacher", "normal"])
def test_sample_matches_jax_random(name):
    jdist, dist = DISTS[name]
    dtype = jnp.int32 if name.startswith("int") else jnp.float32
    want = np.asarray(jdist.sample(_jkey(), (3000,), dtype))
    keys = torch.tensor([_key().astype(np.int64)])
    _assert_stream(name, dist.sample_chunks(keys, 3000)[0].numpy(), want)


def test_stream_chunks_and_slices_agree():
    dist = randgen.UniformInt(0, 299)
    whole = randgen.stream_chunks(_key(), dist, 1, 3)
    part = randgen.stream_slice(_key(), dist, 4096 + 10, 4 * 4096 - 7)
    torch.testing.assert_close(part, whole[10:-7], rtol=0, atol=0)
    assert randgen.stream_slice(_key(), dist, 5, 5).numel() == 0


def test_empty_span_returns_low():
    vals = randgen.stream_slice(_key(), randgen.UniformInt(5, 4), 0, 100)
    want = np.asarray(jrandgen.stream_slice(
        _jkey(), jrandgen.UniformInt(5, 4), 0, 100, jnp.int32))
    np.testing.assert_array_equal(vals.numpy(), want)
    assert set(vals.tolist()) == {5}


def test_stream_dtype_and_device_arguments():
    v = randgen.stream_slice(_key(), randgen.Rademacher(), 0, 10,
                             dtype=torch.float64, device="cpu")
    assert v.dtype == torch.float64 and v.device.type == "cpu"
    h = randgen.stream_slice(_key(), randgen.UniformInt(0, 9), 0, 10)
    assert h.dtype == torch.int64


@pytest.mark.parametrize("dist", [randgen.UniformInt(2, 9),
                                  randgen.Exponential(0.5)])
def test_new_distributions_round_trip_with_reference(dist):
    assert randgen.Distribution.from_dict(dist.to_dict()) == dist
    jd = jrandgen.Distribution.from_dict(dist.to_dict())
    assert jd.to_dict() == dist.to_dict()
