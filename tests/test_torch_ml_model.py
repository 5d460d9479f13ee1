"""A ``HilbertModel`` carried between the JAX package and the port, on the
CPU: models that the reference's BlockADMMSolver trains (2 iterations on
``test_torch_ml_admm.py``'s data and cases: kernel maps for
classification and regression, and a linear model), saved as the
reference writes them and loaded through
``interop.hilbert_model_from_reference``, and the port's models read by
the reference. Bounds: the same labels; decision values within
1e-5·max|ref| with the port's feature projection in the "f32" regime
(the reference's CPU arithmetic), and within the reference's 1e-4 oracle
in the default "bf16x3" regime, whose three bf16 products keep ≈ 2⁻¹⁶
of each term where the reference's CPU projection is float32.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu_torch import interop, ml
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.sketch import params as sketch_params
from test_torch_ml_admm import CASES, D, PORT, REFERENCE, _data, _np, _rel
from test_torch_ml_admm import _train as _train_case

MODELS = ["hinge_l2", "squared_l1_regression", "lad_none_linear_regression"]


def _train(pkg, name):
    """A model of the case after 2 iterations."""
    return _train_case(pkg, name, iters=2)


@pytest.fixture(scope="module")
def reference_models():
    return {name: _train(REFERENCE, name) for name in MODELS}


DV_TOL = {"f32": 1e-5, "bf16x3": 1e-4}


@pytest.fixture(params=sorted(DV_TOL))
def regime(request):
    """The port's B1 regime for the test, restored after it."""
    before = sketch_params.get_kernel_precision()
    sketch_params.set_kernel_precision(request.param)
    yield request.param
    sketch_params.set_kernel_precision(before)


@pytest.mark.parametrize("name", MODELS)
def test_reference_model_loads_and_predicts_the_same(
        reference_models, name, regime, tmp_path):
    want = reference_models[name]
    want.label_coding = None if want.regression else [10, 20, 30]
    path = os.path.join(tmp_path, "model.json")
    want.save(path, header="written by the reference\nsecond line")
    got = interop.hilbert_model_from_reference(path, device="cpu")
    Xq = _data(seed=6)[0]
    wl, wdv = want.predict(jnp.asarray(Xq))
    gl, gdv = got.predict(Xq)
    assert _rel(gdv, wdv) <= DV_TOL[regime]
    if not want.regression:  # else the labels are the decision values
        np.testing.assert_array_equal(_np(gl), _np(wl))
    # a dict and the JSON text load the same
    d = want.to_dict()
    for src in (d, json.dumps(d)):
        again = interop.hilbert_model_from_reference(src, device="cpu")
        assert torch.equal(again.coef, got.coef)
    # the model-file wrapper decodes to the training labels
    jw = jml.LinearizedKernelModel(path)
    pw = ml.LinearizedKernelModel(path, device="cpu")
    assert pw.get_input_dimension() == jw.get_input_dimension() == D
    if not want.regression:
        np.testing.assert_array_equal(_np(pw.predict(Xq)),
                                      _np(jw.predict(Xq)))
    assert _rel(pw.decision_values(Xq),
                jw.decision_values(Xq)) <= DV_TOL[regime]


def test_port_model_loads_in_the_reference(regime, tmp_path):
    got = _train(PORT, "hinge_l2")
    path = os.path.join(tmp_path, "model.json")
    got.save(path)
    back = ml.HilbertModel.load(path, device="cpu")
    Xq = _data(seed=7)[0]
    assert torch.equal(back.coef, got.coef)
    assert torch.equal(back.predict(Xq)[1], got.predict(Xq)[1])
    ref = jml.HilbertModel.load(path)
    wl, wdv = ref.predict(jnp.asarray(Xq))
    gl, gdv = got.predict(Xq)
    assert _rel(gdv, wdv) <= DV_TOL[regime]
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_model_materialize_predicts_the_same():
    got = _train(PORT, "hinge_l2")
    Xq = _data(seed=8)[0]
    before = got.predict(Xq)[1]
    got.materialize()
    assert all(m._op_cache is not None for m in got.maps)
    assert _rel(got.predict(Xq)[1], before) <= 1e-5
    got.dematerialize()
    assert all(m._op_cache is None for m in got.maps)


def test_model_without_maps_and_one_output():
    coef = np.array([[1.0], [-2.0], [0.5]], np.float32)
    m = ml.HilbertModel([], False, 3, 1, False, coef=coef, device="cpu")
    jm = jml.HilbertModel([], False, 3, 1, False, coef=jnp.asarray(coef))
    X = np.random.default_rng(9).standard_normal((20, 3)).astype(np.float32)
    np.testing.assert_array_equal(m.predict(X)[0].numpy(),
                                  np.asarray(jm.predict(jnp.asarray(X))[0]))
    with pytest.raises(errors.InvalidParametersError):
        ml.HilbertModel(_train(PORT, "hinge_l2").maps, True, 5, 3, False,
                        device="cpu")
