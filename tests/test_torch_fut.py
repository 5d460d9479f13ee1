"""The port's fast unitary transforms against the JAX package, on the CPU.

DCT, IDCT and DHT run FFTs in both packages, in another order of
operations: max |Δ| ≤ 1e-4 · max |reference|. The WHT adds ±1-weighted
terms only: on integer data both forms (butterfly below 512, kron matmul
from 512) are exact and bit-equal to the reference; on Gaussian data
≤ 1e-4 relative as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.sketch import fut as jfut
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.sketch import fut

ORACLE = 1e-4


def _operand(n, axis, integer=False, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, 6) if axis == 0 else (6, n)
    if integer:
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ORACLE * np.abs(want).max()


@pytest.mark.parametrize("name", ["dct", "idct", "dht"])
@pytest.mark.parametrize("n", [7, 64, 1000])
@pytest.mark.parametrize("axis", [0, 1])
def test_fft_transforms_match_reference(name, n, axis):
    A = _operand(n, axis)
    want = getattr(jfut, name)(jnp.asarray(A), axis)
    _close(getattr(fut, name)(torch.from_numpy(A), axis), want)


@pytest.mark.parametrize("n", [64, 256, 512, 2048])
@pytest.mark.parametrize("axis", [0, 1])
def test_wht_matches_reference(n, axis):
    A = _operand(n, axis)
    _close(fut.wht(torch.from_numpy(A), axis), jfut.wht(jnp.asarray(A), axis))
    Ai = _operand(n, axis, integer=True)
    np.testing.assert_array_equal(
        fut.wht(torch.from_numpy(Ai), axis).numpy(),
        np.asarray(jfut.wht(jnp.asarray(Ai), axis)))


@pytest.mark.parametrize("n", [8, 512, 4096])
def test_wht_forms_agree_bitwise_on_integers(n):
    A = torch.from_numpy(_operand(n, 0, integer=True))
    np.testing.assert_array_equal(fut._wht_butterfly(A, 0).numpy(),
                                  fut._wht_matmul(A, 0).numpy())


def test_wht_is_self_inverse_up_to_n():
    A = torch.from_numpy(_operand(1024, 0, integer=True))
    np.testing.assert_array_equal(fut.wht(fut.wht(A)).numpy(),
                                  1024 * A.numpy())


def test_wht_rejects_non_power_of_two():
    with pytest.raises(errors.InvalidParametersError):
        fut.wht(torch.ones(12, 2))


def test_fwht_sketch_matches_reference():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((1024, 5)).astype(np.float32)
    diag = np.where(rng.random(1024) < 0.5, -1.0, 1.0).astype(np.float32)
    idx = rng.integers(0, 1024, 100)
    want = jfut.fwht_sketch(jnp.asarray(A), jnp.asarray(diag),
                            jnp.asarray(idx, jnp.int32), 1 / 32, 3.2)
    got = fut.fwht_sketch(torch.from_numpy(A), torch.from_numpy(diag),
                          torch.from_numpy(idx), 1 / 32, 3.2)
    _close(got, want)
    got_rw = fut.fwht_sketch(torch.from_numpy(A.T.copy()),
                             torch.from_numpy(diag), torch.from_numpy(idx),
                             1 / 32, 3.2, axis=1)
    _close(got_rw.T, want)


@pytest.mark.parametrize("name", ["dct", "dht", "wht"])
def test_fut_scale_and_inverse_match_reference(name):
    n = 256
    F, jF = fut.make_fut(name, n), jfut.make_fut(name, n)
    assert F.scale() == jF.scale()
    A = _operand(n, 0, seed=4)
    back = F.apply_inverse(F.apply(torch.from_numpy(A)))
    _close(back * F.scale() ** 2, A)
    _close(F.apply(torch.from_numpy(A)), jF.apply(jnp.asarray(A)))


def test_hadamard_factor_is_made_once_per_length_and_device():
    fut._hadamard.cache_clear()
    fut.wht(torch.ones(1024, 2))
    fut.wht(torch.ones(1024, 3))
    assert fut._hadamard.cache_info().misses == 1  # a = b = 32


def test_unknown_fut_raises():
    with pytest.raises(errors.InvalidParametersError):
        fut.make_fut("fft", 8)
