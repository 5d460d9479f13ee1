"""The port's random Fourier/Laplace features against the JAX package, on
the CPU.

On a CPU tensor the kernels' wrappers run their plain versions, so these
tests hold the plain versions and the port's paths to the reference:

- ``shifts`` bit-equal (a Uniform counter stream);
- ``w_panel`` within ROADMAP C2: Normal max |Δ| ≤ 1e-5·inscale, Cauchy
  and StandardLevy |Δ| ≤ 1e-5·max(|W|, inscale);
- ``GaussianRFT``, ``LaplacianRFT`` and ``ExpSemigroupRLT`` ``.apply``,
  both orientations, max |Δ| ≤ 1e-4·max|ref| (the reference's oracle).
  Laplacian frequencies are Cauchy: a one-ulp change of a large entry
  moves a phase by a visible amount, so its bandwidth is a realistic
  σ = 4N (K ≈ 0.75 on this data), where phases stay moderate;
- ``cuda_dense.rft_apply_plain`` against the JAX package's Pallas kernel
  (``pallas_dense.rft_rowwise_apply``, interpret mode, f32 regime) and
  against ``GaussianRFT.apply``, max |Δ| ≤ 1e-4·max|ref|;
- MaternRFT raises (the Gamma sampler is not ported).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import pallas_dense as jpd
from libskylark_tpu_torch import interop
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_dense

ORACLE = 1e-4  # relative to max |reference|
C2 = 1e-5

# (N, m, S): BLOCK_COLS-aligned, and ragged in every extent
SHAPES = [(512, 48, 64), (700, 37, 48)]


def _families(N):
    """name → (JAX class, port class, kwargs, nonnegative data)."""
    return {
        "gaussian": (jsk.GaussianRFT, sk.GaussianRFT, {"sigma": 16.0}, False),
        "laplacian": (jsk.LaplacianRFT, sk.LaplacianRFT,
                      {"sigma": 4.0 * N}, False),
        "expsemigroup": (jsk.ExpSemigroupRLT, sk.ExpSemigroupRLT,
                         {"beta": 0.5}, True),
    }


def _operand(n, m, rowwise, nonneg=False, seed=0):
    A = np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)
    if nonneg:
        A = np.abs(A) / n
    return np.ascontiguousarray(A.T) if rowwise else A


def _close(got, want, tol=ORACLE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _pair(name, N, S, seed):
    jcls, cls, kw, nonneg = _families(N)[name]
    return jcls(N, S, JContext(seed), **kw), cls(N, S, Context(seed), **kw)


@pytest.fixture(autouse=True)
def _zero_counters():
    yield
    for k in cuda_dense.launches:
        cuda_dense.launches[k] = 0


@pytest.mark.parametrize("name", ["gaussian", "laplacian", "expsemigroup"])
def test_shifts_are_bit_equal(name):
    jT, T = _pair(name, 700, 300, seed=2)
    np.testing.assert_array_equal(T.shifts().numpy(), np.asarray(jT.shifts()))


@pytest.mark.parametrize("name", ["gaussian", "laplacian", "expsemigroup"])
@pytest.mark.parametrize("lo,hi", [(0, 700), (100, 333)])
def test_w_panel_within_c2(name, lo, hi):
    jT, T = _pair(name, 700, 48, seed=3)
    want = np.asarray(jT.w_panel(lo, hi))
    got = T.w_panel(lo, hi).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name == "gaussian":
        assert np.abs(got - want).max() <= C2 * T.inscale
    else:
        scale = np.maximum(np.abs(want), T.inscale)
        assert (np.abs(got - want) / scale).max() <= C2
    np.testing.assert_array_equal(T.s_block(1).numpy(),
                                  T.w_panel(256, 512).numpy())


@pytest.mark.parametrize("name", ["gaussian", "laplacian", "expsemigroup"])
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("N,m,S", SHAPES)
def test_apply_matches_reference(name, rowwise, N, m, S):
    jT, T = _pair(name, N, S, seed=3)
    A = _operand(N, m, rowwise, nonneg=_families(N)[name][3])
    jdim = jsk.ROWWISE if rowwise else jsk.COLUMNWISE
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    want = jT.apply(jnp.asarray(A), jdim)
    got = T.apply(A, dim, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want)
    assert not any(cuda_dense.launches.values())


@pytest.mark.parametrize("N,m,S", SHAPES)
def test_cos_plain_version_matches_interpreted_pallas_kernel(N, m, S):
    jT, T = _pair("gaussian", N, S, seed=4)
    A = _operand(N, m, rowwise=True, seed=1)
    want = jpd.rft_rowwise_apply(
        jT.subkey(0), jT.dist, jnp.asarray(A), S, jT.inscale, jT.outscale,
        jT.row_scales(jnp.float32), jT.shifts(jnp.float32),
        precision="f32", interpret=True)
    assert want is not None
    args = (T.subkey(0), T.dist, torch.from_numpy(A), S, T.inscale,
            T.outscale, T.row_scales(), T.shifts())
    got = cuda_dense.rft_apply_plain(*args)
    _close(got, want)
    _close(got, jT.apply(jnp.asarray(A), jsk.ROWWISE))
    torch.testing.assert_close(cuda_dense.rft_rowwise_apply(*args), got,
                               rtol=0, atol=0)
    assert not any(cuda_dense.launches.values())


def test_cos_epilogue_indexes_scales_and_shifts_by_feature():
    # per-feature sc/sh: the plain version is outscale·cos(P·inscale·sc +
    # sh), P the unscaled projection, column by column
    T = sk.GaussianRFT(300, 40, Context(5), sigma=4.0)
    A = torch.from_numpy(_operand(300, 9, rowwise=True, seed=2))
    g = torch.Generator().manual_seed(0)
    sc = 0.5 + torch.rand(40, generator=g)
    sh = 6.0 * torch.rand(40, generator=g)
    got = cuda_dense.rft_apply_plain(T.subkey(0), T.dist, A, 40, T.inscale,
                                     T.outscale, sc, sh)
    P = cuda_dense.dense_apply_plain(T.subkey(0), T.dist, A, 40, 1.0, True)
    want = T.outscale * torch.cos(P * T.inscale * sc[None, :] + sh[None, :])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(errors.InvalidParametersError):
        cuda_dense.rft_rowwise_apply(T.subkey(0), T.dist, A, 40, 1.0, 1.0,
                                     sc[:39], sh)


def test_routes_are_decided_by_distribution_and_dtype(monkeypatch):
    calls = []
    for fn in ("rft_rowwise_apply", "rowwise_apply", "columnwise_apply"):
        real = getattr(cuda_dense, fn)

        def spy(*a, _fn=fn, _real=real, **kw):
            calls.append(_fn)
            return _real(*a, **kw)

        monkeypatch.setattr(cuda_dense, fn, spy)
    N, m, S = 300, 5, 24
    A = _operand(N, m, rowwise=True, seed=3)
    sk.GaussianRFT(N, S, Context(1)).apply(A, sk.ROWWISE, device="cpu")
    sk.GaussianRFT(N, S, Context(1)).apply(A.T, sk.COLUMNWISE, device="cpu")
    sk.LaplacianRFT(N, S, Context(1)).apply(A, sk.ROWWISE, device="cpu")
    assert calls == ["rft_rowwise_apply", "columnwise_apply", "rowwise_apply"]
    calls.clear()
    # float64 and StandardLevy frequencies take no kernel's route
    sk.GaussianRFT(N, S, Context(1)).apply(torch.from_numpy(A).double(),
                                           sk.ROWWISE, device="cpu")
    sk.ExpSemigroupRLT(N, S, Context(1)).apply(np.abs(A), sk.ROWWISE,
                                               device="cpu")
    assert calls == []


def test_float64_apply_matches_float32():
    T = sk.GaussianRFT(300, 24, Context(6), sigma=8.0)
    A = _operand(300, 7, rowwise=True, seed=5)
    z32 = T.apply(A, sk.ROWWISE, device="cpu")
    z64 = T.apply(A.astype(np.float64), sk.ROWWISE, device="cpu")
    assert z64.dtype == torch.float64
    _close(z64, z32.double())


@pytest.mark.parametrize("name", ["gaussian", "laplacian", "expsemigroup"])
def test_reference_json_loads_to_same_transform(name):
    jT, T = _pair(name, 700, 48, seed=9)
    assert T.to_dict() == jT.to_dict()
    U = interop.transform_from_reference(jT.to_json())
    assert type(U) is type(T) and U.to_dict() == jT.to_dict()
    np.testing.assert_array_equal(U.shifts().numpy(), T.shifts().numpy())


def test_matern_raises():
    """MaternRFT raised while the Gamma sampler was missing; now it
    constructs, and the reference's JSON carries across to the same
    transform (its scales are held in test_torch_matern.py)."""
    T = sk.MaternRFT(64, 16, Context(0), nu=1.5, l=2.0)
    ref = jsk.MaternRFT(64, 16, JContext(0), nu=1.5, l=2.0).to_json()
    assert json.loads(ref)["sketch_type"] == "MaternRFT"
    got = interop.transform_from_reference(ref)
    assert type(got) is sk.MaternRFT
    assert got.to_dict() == T.to_dict() == json.loads(ref)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    T = sk.GaussianRFT(64, 8, Context(0))
    with pytest.raises(errors.UnsupportedError):
        T.apply(_operand(64, 3, rowwise=True), sk.ROWWISE)
    assert not any(cuda_dense.launches.values())
