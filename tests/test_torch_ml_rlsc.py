"""The port's RLSC family, label coding and metrics against the JAX
package, on the CPU, on ``test_torch_ml_krr.py``'s data and bounds: the
direct solves and the block coordinate descent (20 sweeps in both) within
1e-4·max|ref|, ``faster_kernel_rlsc`` within the reference's ``rtol =
1e-2, atol = 1e-3``, the coding (label order) equal, decoded predictions,
coding, decoding and metrics equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import ml
from libskylark_tpu_torch.base.context import Context
from test_torch_ml_krr import LAM, _data, _held, _held_cg, _kernels

RLSC = {
    "kernel": (
        lambda jk, X, y: jml.kernel_rlsc(jk, X, y, LAM),
        lambda k, X, y: ml.kernel_rlsc(k, X, y, LAM, device="cpu")),
    "approximate": (
        lambda jk, X, y: jml.approximate_kernel_rlsc(
            jk, X, y, LAM, 128, JContext(20)),
        lambda k, X, y: ml.approximate_kernel_rlsc(
            k, X, y, LAM, 128, Context(20), device="cpu")),
    "approximate_sketched_cwt": (
        lambda jk, X, y: jml.approximate_kernel_rlsc(
            jk, X, y, LAM, 48, JContext(21),
            jml.RlscParams(sketched_rls=True, fast_sketch=True)),
        lambda k, X, y: ml.approximate_kernel_rlsc(
            k, X, y, LAM, 48, Context(21),
            ml.RlscParams(sketched_rls=True, fast_sketch=True),
            device="cpu")),
    "sketched_approximate": (
        lambda jk, X, y: jml.sketched_approximate_kernel_rlsc(
            jk, X, y, LAM, 64, JContext(22),
            params=jml.RlscParams(max_split=40)),
        lambda k, X, y: ml.sketched_approximate_kernel_rlsc(
            k, X, y, LAM, 64, Context(22),
            params=ml.RlscParams(max_split=40), device="cpu")),
    "large_scale": (
        lambda jk, X, y: jml.large_scale_kernel_rlsc(
            jk, X, y, LAM, 96, JContext(23),
            jml.RlscParams(max_split=64, tolerance=0.0, iter_lim=20)),
        lambda k, X, y: ml.large_scale_kernel_rlsc(
            k, X, y, LAM, 96, Context(23),
            ml.RlscParams(max_split=64, tolerance=0.0, iter_lim=20),
            device="cpu")),
    "faster": (
        lambda jk, X, y: jml.faster_kernel_rlsc(
            jk, X, y, LAM, 64, JContext(24),
            jml.RlscParams(tolerance=1e-6, iter_lim=400)),
        lambda k, X, y: ml.faster_kernel_rlsc(
            k, X, y, LAM, 64, Context(24),
            ml.RlscParams(tolerance=1e-6, iter_lim=400), device="cpu")),
}


@pytest.fixture(scope="module")
def reference_rlsc():
    X, _, labels = _data()
    jk, _ = _kernels()
    return {name: calls[0](jk, jnp.asarray(X), labels)
            for name, calls in RLSC.items()}


@pytest.mark.parametrize("name", sorted(RLSC))
def test_rlsc_matches_reference(reference_rlsc, name):
    X, _, labels = _data()
    _, k = _kernels()
    want = reference_rlsc[name]
    got = RLSC[name][1](k, X, labels)
    assert got[-1] == want[-1]  # the coding
    if name == "faster":
        _held_cg(got[-2], want[-2])
    else:
        _held(got[-2], want[-2])


def test_rlsc_predict_matches_reference(reference_rlsc):
    X, _, labels = _data()
    Xq = _data(seed=2)[0][:40]
    jk, k = _kernels()
    A, coding = reference_rlsc["kernel"]
    want = jml.rlsc.rlsc_predict(jk, jnp.asarray(Xq), jnp.asarray(X), A,
                                 coding)
    got = ml.rlsc.rlsc_predict(k, Xq, X, np.array(A), coding, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert ml.rlsc.rlsc_predict(k, Xq[0], X, np.array(A),
                                device="cpu") == int(
        jml.rlsc.rlsc_predict(jk, jnp.asarray(Xq[0]), jnp.asarray(X), A))
    # the planted classes are separated on the training data
    train = ml.rlsc.rlsc_predict(k, X, X, np.array(A), coding,
                                 device="cpu")
    assert ml.classification_accuracy(train, labels) > 95.0


# -- coding and metrics --

@pytest.mark.parametrize("labels,coding", [
    ([3, 1, 2, 3, 1], None),
    ([-1, 1, 1, -1], None),
    ([0, 2, 2], [2, 0, 5]),
    (["b", "a", "c", "a"], None),
])
def test_dummy_coding_matches_reference(labels, coding):
    want, wc = jml.dummy_coding(np.asarray(labels), coding)
    got, gc = ml.dummy_coding(np.asarray(labels), coding, device="cpu")
    assert gc == wc
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dummy_decode_matches_reference():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((50, 4)).astype(np.float32)
    scores[0] = 1.0  # a tie: the first column wins in both
    coding = [7, 3, 9, 1]
    np.testing.assert_array_equal(
        ml.dummy_decode(torch.from_numpy(scores), coding),
        jml.dummy_decode(jnp.asarray(scores), coding))
    np.testing.assert_array_equal(ml.dummy_decode(scores, coding),
                                  jml.dummy_decode(scores, coding))


def test_metrics_match_reference():
    rng = np.random.default_rng(4)
    a, b = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
    assert ml.classification_accuracy(torch.from_numpy(a), b) == \
        jml.classification_accuracy(a, b)
    x = rng.standard_normal(30).astype(np.float32)
    y = rng.standard_normal(30).astype(np.float32)
    assert ml.rmse(torch.from_numpy(x), y) == jml.rmse(x, y)
    with pytest.raises(ValueError):
        ml.classification_accuracy(a, b[:5])
