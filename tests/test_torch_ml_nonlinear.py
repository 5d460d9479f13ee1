"""The port's nonlinear RLS toolkit (RLS, SketchRLS, NystromRLS, SketchPCR),
the dominant-subspace basis it builds on, and the model-file wrapper,
against the JAX package, on the CPU.

Both packages get the same float32 data (numpy, seeded: 200 rows of 8
features in 3 planted classes, and a regression target) and the same
Context seed, so they draw the same maps and landmarks. Bounds: multiclass
predictions (decoded labels) equal; regression predictions within
1e-4·max|ref|, the reference's oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu import nla as jnla
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import ml
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.nla import lowrank

N, D, CLASSES = 200, 8, 3
TOL = 1e-4


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = 2.5 * rng.standard_normal((CLASSES, D))
    labels = rng.integers(0, CLASSES, N) * 2 + 1  # labels 1, 3, 5
    X = (centers[labels // 2] + rng.standard_normal((N, D))).astype(
        np.float32)
    y = (np.sin(X[:, 0]) + 0.2 * X[:, 1]).astype(np.float32)
    return X, labels, y


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _kernels():
    return jml.Gaussian(D, 3.0), ml.Gaussian(D, 3.0)


# model: (reference train, port train), each given (model, X, Y, multiclass)
TRAIN = {
    "RLS": (lambda m, X, Y, mc: m.train(X, Y, 0.5, multiclass=mc),
            lambda m, X, Y, mc: m.train(X, Y, 0.5, multiclass=mc,
                                        device="cpu")),
    "SketchRLS": (
        lambda m, X, Y, mc: m.train(X, Y, JContext(2), 64, 0.5,
                                    multiclass=mc),
        lambda m, X, Y, mc: m.train(X, Y, Context(2), 64, 0.5,
                                    multiclass=mc, device="cpu")),
    "NystromRLS-uniform": (
        lambda m, X, Y, mc: m.train(X, Y, JContext(3), 32, 0.5,
                                    multiclass=mc),
        lambda m, X, Y, mc: m.train(X, Y, Context(3), 32, 0.5,
                                    multiclass=mc, device="cpu")),
    "NystromRLS-leverages": (
        lambda m, X, Y, mc: m.train(X, Y, JContext(4), 32, 0.5,
                                    probdist="leverages", multiclass=mc),
        lambda m, X, Y, mc: m.train(X, Y, Context(4), 32, 0.5,
                                    probdist="leverages", multiclass=mc,
                                    device="cpu")),
    "SketchPCR": (
        lambda m, X, Y, mc: m.train(X, Y, JContext(5), 6, multiclass=mc),
        lambda m, X, Y, mc: m.train(X, Y, Context(5), 6, multiclass=mc,
                                    device="cpu")),
}


def _cls(name):
    return name.split("-")[0]


@pytest.fixture(scope="module")
def reference():
    X, labels, y = _data()
    Xq = _data(seed=1)[0]
    jk, _ = _kernels()
    out = {}
    for name, (train, _) in TRAIN.items():
        for mc in (True, False):
            m = getattr(jml, _cls(name))(jk)
            train(m, jnp.asarray(X), labels if mc else y, mc)
            out[name, mc] = np.asarray(m.predict(jnp.asarray(Xq)))
    return out


@pytest.mark.parametrize("multiclass", [True, False])
@pytest.mark.parametrize("name", sorted(TRAIN))
def test_model_matches_reference(reference, name, multiclass):
    X, labels, y = _data()
    Xq = _data(seed=1)[0]
    _, k = _kernels()
    m = getattr(ml, _cls(name))(k)
    TRAIN[name][1](m, X, labels if multiclass else y, multiclass)
    got, want = m.predict(Xq), reference[name, multiclass]
    if multiclass:
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {1, 3, 5}
    else:
        assert _np(got).shape == want.shape == (len(Xq),)
        err = np.abs(_np(got) - want).max() / np.abs(want).max()
        assert err <= TOL, err


def test_models_fit_the_planted_classes():
    X, labels, _ = _data()
    _, k = _kernels()
    for name, (_, train) in TRAIN.items():
        m = getattr(ml, _cls(name))(k)
        train(m, X, labels, True)
        assert ml.classification_accuracy(m.predict(X), labels) > 90.0, name


def test_models_take_a_sparse_operand():
    X, labels, _ = _data()
    Xs = sp.csr_matrix(np.where(np.abs(X) > 1.0, X, 0.0).astype(np.float32))
    jk, k = _kernels()
    want = jml.RLS(jk).train(Xs, labels, 0.5).predict(Xs)
    got = ml.RLS(k).train(Xs, labels, 0.5, device="cpu").predict(Xs)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_predict_before_train_and_bad_probdist():
    _, k = _kernels()
    for cls in (ml.RLS, ml.SketchRLS, ml.NystromRLS, ml.SketchPCR):
        with pytest.raises(errors.MLError):
            cls(k).predict(np.zeros((2, D), np.float32))
    X, labels, _ = _data()
    with pytest.raises(errors.InvalidParametersError):
        ml.NystromRLS(k).train(X, labels, Context(1), 8, probdist="x",
                               device="cpu")


@pytest.mark.parametrize("kernel", [False, True])
def test_dominant_subspace_basis_matches_reference(kernel):
    """Z spans the reference's basis: the projectors Z·Zᵀ agree (Z's
    columns are defined up to sign)."""
    X = _data()[0]
    jk, k = _kernels() if kernel else (None, None)
    Zw, Sw, Rw, _ = jnla.lowrank.approximate_dominant_subspace_basis(
        jnp.asarray(X), 5, 16, 32, JContext(6), kernel=jk)
    Z, S, R, _ = lowrank.approximate_dominant_subspace_basis(
        X, 5, 16, 32, Context(6), kernel=k, device="cpu")
    assert S.to_dict()["creation_context"] == \
        Sw.to_dict()["creation_context"]
    assert Z.shape == (N, 5)
    Pw = _np(Zw) @ _np(Zw).T
    err = np.abs(_np(Z) @ _np(Z).T - Pw).max() / np.abs(Pw).max()
    assert err <= TOL, err
    assert np.allclose(np.abs(_np(R)), np.abs(_np(Rw)),
                       atol=TOL * np.abs(_np(Rw)).max())


def test_linearized_kernel_model_of_a_reference_file(tmp_path):
    """modeling: a model file the reference writes (a SketchRLS's map and
    weights, label coding 1, 3, 5) serves the same labels in the port."""
    X, labels, _ = _data()
    Xq = _data(seed=2)[0]
    jk, _ = _kernels()
    m = jml.SketchRLS(jk).train(jnp.asarray(X), labels, JContext(7), 64, 0.5)
    model = jml.HilbertModel([m._rft], False, 64, CLASSES, False,
                             coef=m.model["weights"],
                             label_coding=m.model["coding"])
    path = str(tmp_path / "model.json")
    model.save(path)
    want = jml.LinearizedKernelModel(path)
    got = ml.LinearizedKernelModel(path, device="cpu")
    np.testing.assert_array_equal(got.predict(Xq), want.predict(Xq))
    np.testing.assert_array_equal(got.predict(Xq), m.predict(Xq))
    assert got.get_input_dimension() == D
    dv, wdv = _np(got.decision_values(Xq)), _np(want.decision_values(Xq))
    assert np.abs(dv - wdv).max() <= TOL * np.abs(wdv).max()
    assert got.hilbert_model.label_coding == [1, 3, 5]
