"""The batched kernel's plain version in every contraction regime against
the JAX package's Pallas kernel in interpret mode, on the CPU:
``cuda_dense.serve_batched_apply`` against
``pallas_dense.serve_batched_apply`` at ``precision=p, interpret=True``.
Shapes, operators and the tolerance are ``test_torch_dense_regimes.py``'s
(see its doc)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.sketch import pallas_dense as jpd
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_dense
from test_torch_dense_regimes import (  # noqa: F401 (fixtures)
    DISTS, REGIMES, SHAPES, _close, _data, _limit, _oracle, _no_launches,
    operators)


@pytest.mark.parametrize("precision", REGIMES)
@pytest.mark.parametrize("dist", list(DISTS))
@pytest.mark.parametrize("rowwise", [True, False])
def test_batched_regime_matches_interpreted_kernel(precision, dist, rowwise,
                                                   operators):
    # three lanes of 37×700 → 48 (rowwise) or 700×37 (columnwise), each
    # with its own key and a scale that is not a power of two
    jd, d = DISTS[dist]
    m, n, s = SHAPES[0]
    ctx = Context(40)
    kd = np.stack([ctx.allocate().key for _ in range(3)]).astype(np.uint32)
    scale = np.array([0.3, 1.0, 1.7], np.float32)
    A = _data((3, m, n) if rowwise else (3, n, m), 5)
    want = jpd.serve_batched_apply(jnp.asarray(kd), jnp.asarray(scale),
                                   jnp.asarray(A), dist=jd, s_dim=s,
                                   rowwise=rowwise, precision=precision,
                                   interpret=True)
    got = cuda_dense.serve_batched_apply(kd, scale, torch.from_numpy(A), d,
                                         s, rowwise, precision=precision)
    want = np.asarray(want, np.float64)
    for b in range(3):
        S_ref, S = operators(jax.random.wrap_key_data(jnp.asarray(kd[b])),
                              kd[b], jd, d, s, n, scale[b])
        _close(got[b], want[b], _limit(A[b], S_ref, S, _oracle(want),
                                       dist, precision, rowwise))
