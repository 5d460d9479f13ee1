"""The port's ml.kernels against the JAX package, on the CPU: Gram
matrices, the feature-map factories, serialization, and the random-feature
slice as a whole.

- ``gram`` of every kernel: max |Δ| ≤ 1e-5·max|ref| (float32 on both
  sides; the distance matrices sum in another order);
- ``create_rft``: the same transform class as the reference's for every
  (kernel, tag), the same allocation, and the same refusals;
- ``interop.kernel_from_reference``: the reference's JSON loads to a
  kernel whose ``to_dict`` is the reference's, field for field;
- the slice as a whole: ``Gaussian(256, 16).create_rft(1024, Context(7),
  tag)`` applied rowwise to a 512×256 operand, for the "regular", "fast"
  and "quasi" tags, max |Δ| ≤ 1e-4·max|ref| against the reference's
  features from the same seed;
- chip_smoke.py's Gram-check bounds pass the right Gaussian map at
  S = 4096 and fail it without its shifts or with a doubled scale.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import interop, ml
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context

N = 64
KERNELS = {
    "linear": ((), {}),
    "gaussian": ((8.0,), {}),
    "polynomial": ((3, 0.5, 0.1), {}),
    "laplacian": ((50.0,), {}),
    "expsemigroup": ((0.3,), {}),
    "matern_0.5": ((), {"nu": 0.5, "l": 9.0}),
    "matern_1.5": ((), {"nu": 1.5, "l": 9.0}),
    "matern_2.5": ((), {"nu": 2.5, "l": 9.0}),
    "matern_1.2": ((), {"nu": 1.2, "l": 9.0}),
}


def _pair(name):
    args, kw = KERNELS[name]
    ktype = name.split("_")[0]
    return (jml.make_kernel(ktype, N, **dict(zip(_PARAMS[ktype], args)), **kw),
            ml.make_kernel(ktype, N, **dict(zip(_PARAMS[ktype], args)), **kw))


_PARAMS = {"linear": (), "gaussian": ("sigma",),
           "polynomial": ("q", "c", "gamma"), "laplacian": ("sigma",),
           "expsemigroup": ("beta",), "matern": ()}


def _data(name, m, seed):
    X = np.random.default_rng(seed).standard_normal((m, N)).astype(
        np.float32)
    return np.abs(X) if name == "expsemigroup" else X


@pytest.mark.parametrize("name", list(KERNELS))
def test_gram_matches_reference(name):
    jk, k = _pair(name)
    X, Y = _data(name, 20, 0), _data(name, 7, 1)
    want = np.asarray(jk.gram(jnp.asarray(X), jnp.asarray(Y)))
    got = k.gram(X, Y, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (20, 7)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    sym = k.symmetric_gram(X, device="cpu")
    torch.testing.assert_close(sym, k.gram(X, X, device="cpu"), rtol=0,
                               atol=0)


def test_expsemigroup_gram_in_row_chunks(monkeypatch):
    # the (rows, n, d) broadcast is formed a bounded number of rows at a
    # time; the chunking changes no value
    from libskylark_tpu_torch.ml import kernels

    k = ml.ExpSemigroup(N, 0.2)
    X = torch.from_numpy(_data("expsemigroup", 30, 2))
    whole = k.gram(X, device="cpu")
    monkeypatch.setattr(kernels, "_BROADCAST_ELEMENTS", 7 * 30 * N)
    torch.testing.assert_close(k.gram(X, device="cpu"), whole, rtol=0,
                               atol=0)


# (kernel, tag) pairs the reference defines, and the ones it refuses
TAGS = [("linear", "regular"), ("linear", "fast"), ("linear", "sparse"),
        ("gaussian", "regular"), ("gaussian", "fast"), ("gaussian", "quasi"),
        ("polynomial", "regular"), ("polynomial", "fast"),
        ("laplacian", "regular"), ("laplacian", "quasi"),
        ("expsemigroup", "regular"), ("expsemigroup", "quasi")]
REFUSED = [("linear", "quasi"), ("gaussian", "sparse"),
           ("polynomial", "quasi"), ("laplacian", "fast"),
           ("expsemigroup", "fast"), ("matern_1.5", "quasi")]


@pytest.mark.parametrize("name,tag", TAGS)
def test_create_rft_types_per_tag(name, tag):
    jk, k = _pair(name)
    jctx, ctx = JContext(3), Context(3)
    jT, T = jk.create_rft(96, jctx, tag), k.create_rft(96, ctx, tag)
    assert type(T).__name__ == type(jT).__name__
    assert isinstance(T, sk.SketchTransform)
    assert T.to_dict() == jT.to_dict()
    assert ctx.counter == jctx.counter == 1


@pytest.mark.parametrize("name,tag", REFUSED)
def test_undefined_tags_are_refused(name, tag):
    jk, k = _pair(name)
    with pytest.raises(Exception):
        jk.create_rft(16, JContext(0), tag)
    with pytest.raises(errors.InvalidParametersError):
        k.create_rft(16, Context(0), tag)


@pytest.mark.parametrize("tag", ["regular", "fast"])
def test_matern_feature_maps_raise(tag):
    _, k = _pair("matern_1.5")
    with pytest.raises(errors.NotImplementedYetError, match="Gamma"):
        k.create_rft(16, Context(0), tag)


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_from_reference_round_trip(name):
    jk, k = _pair(name)
    got = interop.kernel_from_reference(jk.to_json())
    assert type(got) is type(k)
    assert got.to_dict() == jk.to_dict() == k.to_dict()
    assert ml.deserialize_kernel(got.to_dict()).to_dict() == jk.to_dict()
    assert repr(got) == repr(jk)


def test_unknown_kernel_type_is_refused():
    with pytest.raises(errors.InvalidParametersError):
        ml.make_kernel("rbf", 4)
    with pytest.raises(errors.InvalidParametersError):
        ml.deserialize_kernel({"kernel_type": "rbf", "N": 4})


@pytest.mark.parametrize("tag", ["regular", "fast", "quasi"])
def test_gaussian_slice_matches_reference(tag):
    d, s, m = 256, 1024, 512
    X = np.random.default_rng(11).standard_normal((m, d)).astype(np.float32)
    jT = jml.Gaussian(d, 16.0).create_rft(s, JContext(7), tag)
    T = ml.Gaussian(d, 16.0).create_rft(s, Context(7), tag)
    want = np.asarray(jT.apply(jnp.asarray(X), jsk.ROWWISE))
    got = T.apply(X, sk.ROWWISE, device="cpu").numpy()
    assert got.shape == (m, s)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_gram_check_bounds_catch_a_wrong_shift_or_scale():
    # chip_smoke.py holds each feature map at S = 4096 to GRAM_BOUNDS; the
    # same check here, on 512 rows of d = 256: the right map passes, the
    # map without its shifts or with a doubled frequency scale does not
    from libskylark_tpu_torch.sketch import cuda_dense

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    d, s = 256, 4096
    X = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (512, d)).astype(np.float32))
    kernel = ml.Gaussian(d, d ** 0.5)
    K = kernel.gram(X.double(), device="cpu")
    T = kernel.create_rft(s, Context(60), "regular")

    def errors_of(inscale, sh):
        Z = cuda_dense.rft_apply_plain(T.subkey(0), T.dist, X, s, inscale,
                                       T.outscale, T.row_scales(), sh)
        err = (Z.double() @ Z.double().T - K).abs() / K.abs().max()
        return float(err.max()), float(err.mean())

    bmax, bmean = chip_smoke.GRAM_BOUNDS["rft_regular"]
    good = errors_of(T.inscale, T.shifts())
    assert good[0] <= bmax and good[1] <= bmean
    for bad in (errors_of(T.inscale, torch.zeros(s)),
                errors_of(2 * T.inscale, T.shifts())):
        assert bad[0] > bmax and bad[1] > bmean
