"""The port's randomized EVDs of AᵀA (nla/randlobpcg.py) against the JAX
package's, on the CPU, in the "f32" regime of the dense kernel's plain
version (the reference's CPU arithmetic; the JLT's sketch is B1-cw's).
Both packages draw the same sketch from the same Context seed and run
the same scipy LOBPCG on the host. Bounds: eigenvalues within 1e-4
relative; for the power-iteration EVD, the values float32 resolves:
(AᵀA)^q·A·S keeps a direction only while (σ_j/σ_1)^(2q+1) stays above
float32's rounding, so at q = 3 on σ = 10 … 1 only the first three are
determined, in both packages (the reference's own test holds those). The
cases mirror tests/test_nla_krank.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.nla import randlobpcg as jr
from libskylark_tpu_torch import nla
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import params as sketch_params

TOL = 1e-4


@pytest.fixture(autouse=True)
def f32_regime():
    before = sketch_params.get_pallas_precision()
    sketch_params.set_pallas_precision("f32")
    yield
    sketch_params.set_pallas_precision(before)


def _lowrank(m, n, k, noise=1e-3, seed=0):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, k)))[0]
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    A = (U * np.linspace(10, 1, k)) @ V.T + noise * rng.standard_normal(
        (m, n))
    return A.astype(np.float32)


def _rel(got, want):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / np.abs(want))


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("sketch", ["cwt", "jlt", "fjlt"])
def test_lobpcg_rand_evd_matches_reference(sketch):
    A = _lowrank(300, 24, 4)
    want, Vw = jr.lobpcg_rand_evd(jnp.asarray(A), 4, JContext(6),
                                  sketch=sketch)
    got, Vg = nla.lobpcg_rand_evd(A, 4, Context(6), sketch=sketch,
                                  device="cpu")
    assert Vg.shape == (4, 24)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("power_iters,resolved", [(1, 5), (3, 3)])
def test_power_iterations_rand_evd_matches_reference(power_iters, resolved):
    A = _lowrank(200, 30, 5)
    want, Vw = jr.power_iterations_rand_evd(jnp.asarray(A), 5, JContext(5),
                                            power_iters=power_iters)
    got, Vg = nla.power_iterations_rand_evd(A, 5, Context(5),
                                            power_iters=power_iters,
                                            device="cpu")
    assert tuple(Vg.shape) == (5, 30)
    assert _rel(got[:resolved], np.asarray(want)[:resolved]) <= TOL


def test_bad_arguments_raise_as_the_reference():
    A = _lowrank(300, 24, 4)
    with pytest.raises(errors.InvalidParametersError):
        nla.lobpcg_rand_evd(A, 4, Context(0), sketch="nope", device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        nla.lobpcg_rand_evd(A, 4, Context(0), s=10, device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        nla.lobpcg_rand_evd(A, 4, Context(0), s=400, device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        nla.power_iterations_rand_evd(A.T, 4, Context(0), device="cpu")
