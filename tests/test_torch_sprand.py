"""The port's sparse random matrices (base/sprand.py) against the JAX
package's, on the CPU.

``sample`` and ``hashmap`` draw integer, uniform and sign streams, which
the port reproduces bit for bit (ROADMAP C2, C4), so the tolerance is
exact: the CSR (indptr, indices, data) of the port's matrix is
``np.array_equal`` to the reference's on the same context, and the
contexts advance alike.
"""

import numpy as np
import pytest

from libskylark_tpu.base import sprand as jsprand
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch.base import errors, sprand
from libskylark_tpu_torch.base.context import Context


def _csr_equal(got, want):
    a, b = got.to_scipy().tocsr(), want.to_scipy().tocsr()
    a.sort_indices()
    b.sort_indices()
    assert got.shape == want.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert a.data.dtype == b.data.dtype == np.float32
    assert np.array_equal(a.data, b.data)


@pytest.mark.parametrize("m,n,density,values,probs,seed", [
    (50, 40, 0.1, (0.25, 0.5, 1.0), (1, 1, 1), 5),
    (300, 1000, 0.01, (-1.0, 1.0), (1, 3), 7),
    (2000, 3000, 0.002, (0.25, 0.5, 1.0), (1, 1, 1), 70),
    (17, 9, 0.9, (2.0,), (1,), 3),
    (10, 10, 0.0, (1.0,), (1,), 1),
    (1, 65537, 0.001, (0.5, 1.5, 3.0), (0.2, 0.3, 0.5), 11),
])
def test_sample_bit_equal(m, n, density, values, probs, seed):
    jctx, ctx = JContext(seed), Context(seed)
    want = jsprand.sample(m, n, density, values, probs, jctx)
    got = sprand.sample(m, n, density, values, probs, ctx, device="cpu")
    assert got.nnz == want.nnz == int(round(density * m * n))
    _csr_equal(got, want)
    assert ctx.counter == jctx.counter


@pytest.mark.parametrize("values", ["rademacher", "ones"])
@pytest.mark.parametrize("dimension", [0, 1])
@pytest.mark.parametrize("t,n", [(37, 500), (1024, 4096), (3, 70000)])
def test_hashmap_bit_equal(t, n, values, dimension):
    want = jsprand.hashmap(t, n, JContext(3), values, dimension)
    got = sprand.hashmap(t, n, Context(3), values, dimension, device="cpu")
    _csr_equal(got, want)


def test_bad_arguments_raise():
    with pytest.raises(errors.InvalidParametersError):
        sprand.sample(4, 4, 1.5, (1.0,), (1,), Context(0), device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        sprand.hashmap(4, 8, Context(0), values="gaussian", device="cpu")


def test_default_device_is_the_card():
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(errors.UnsupportedError):
            sprand.sample(4, 4, 0.5, (1.0,), (1,), Context(0))
