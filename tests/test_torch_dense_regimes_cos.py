"""The cos-epilogue kernel's plain version in every contraction regime
against the JAX package's Pallas kernel in interpret mode, on the CPU:
``cuda_dense.rft_rowwise_apply`` against ``pallas_dense.rft_rowwise_apply``
at ``precision=p, interpret=True``. Shapes, operators, the tolerance and
the reference's row tile are ``test_torch_dense_regimes.py``'s (see its
doc)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.sketch import pallas_dense as jpd
from libskylark_tpu_torch.sketch import cuda_dense
from test_torch_dense_regimes import (  # noqa: F401 (fixtures)
    DISTS, REGIMES, SHAPES, _close, _data, _keys, _limit, _oracle,
    _no_launches, one_row_tile, operators)


@pytest.mark.parametrize("precision", REGIMES)
@pytest.mark.parametrize("dist", list(DISTS))
@pytest.mark.parametrize("m,n,s", SHAPES)
def test_cos_regime_matches_interpreted_kernel(precision, dist, m, n, s,
                                               operators):
    # inscale 1/n keeps Cauchy phases (|S| reaches ~1e4 here) within a few
    # hundred radians, where f32 cos still resolves a 1e-4 change
    jd, d = DISTS[dist]
    jkey, key = _keys(30 + s)
    A = _data((m, n), 3)
    rng = np.random.default_rng(4)
    sc = (0.5 + rng.random(s)).astype(np.float32)
    sh = (2 * np.pi * rng.random(s)).astype(np.float32)
    inscale, outscale = 1.0 / n, math.sqrt(2.0 / s)
    with one_row_tile():
        want = jpd.rft_rowwise_apply(jkey, jd, jnp.asarray(A), s, inscale,
                                     outscale, jnp.asarray(sc),
                                     jnp.asarray(sh), precision=precision,
                                     interpret=True)
    got = cuda_dense.rft_rowwise_apply(key, d, torch.from_numpy(A), s,
                                       inscale, outscale,
                                       torch.from_numpy(sc),
                                       torch.from_numpy(sh),
                                       precision=precision)
    S_ref, S = operators(jkey, key, jd, d, s, n)
    want = np.asarray(want, np.float64)
    # the phase's limit times the Lipschitz factor; the oracle term stays
    # 1e-4 · max |features|
    lip = outscale * inscale * sc
    _close(got, want, lip * _limit(A, S_ref, S, _oracle(want) / lip, dist,
                                   precision, True))
