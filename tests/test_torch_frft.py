"""The port's Fastfood features (FastGaussianRFT) against the JAX package,
on the CPU.

On a CPU tensor the Fastfood kernel's wrapper runs its plain version, the
torch chain, so these tests hold it and the port's routes to:

- the streams: ``_B`` (Rademacher), ``_perms`` (jax.random.permutation)
  and ``shifts`` (Uniform) bit-equal; ``_G`` (Normal) within ROADMAP C2,
  max |Δ| ≤ 1e-5;
- ``FastGaussianRFT.apply`` of the JAX package, ``fut="wht"`` and
  ``"dct"``, both orientations, max |Δ| ≤ 1e-4·max|ref|;
- the JAX package's Pallas kernel in interpret mode, f32 regime,
  ``variant="fused"`` and ``"split"``, at NB = 512, 1024 and 2048 with 1
  and 3 blocks and a d that is not a power of two, max |Δ| ≤
  1e-4·max|ref|.

They also pin Π's direction (``out[j] = in[perm[j]]``), scal computed in
float64, the block-major order and truncation, the routes, and the
serialized form.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import pallas_fastfood as jpf
from libskylark_tpu_torch import interop
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_fastfood, frft

ORACLE = 1e-4  # relative to max |reference|
C2 = 1e-5


def _operand(m, d, seed=0):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)


def _close(got, want, tol=ORACLE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _pair(N, S, seed, fut="wht"):
    sigma = math.sqrt(N)
    return (jsk.FastGaussianRFT(N, S, JContext(seed), sigma=sigma, fut=fut),
            sk.FastGaussianRFT(N, S, Context(seed), sigma=sigma, fut=fut))


@pytest.fixture(autouse=True)
def _zero_counters():
    yield
    for k in cuda_fastfood.launches:
        cuda_fastfood.launches[k] = 0


@pytest.mark.parametrize("N,S,fut", [(512, 512, "wht"), (1000, 3000, "wht"),
                                     (300, 700, "dct")])
def test_streams_match_reference(N, S, fut):
    jT, T = _pair(N, S, seed=5, fut=fut)
    assert (T._NB, T._numblks) == (jT._NB, jT._numblks)
    np.testing.assert_array_equal(T._B(torch.float32).numpy(),
                                  np.asarray(jT._B(jnp.float32)))
    np.testing.assert_array_equal(T._perms().numpy(),
                                  np.asarray(jT._perms()))
    np.testing.assert_array_equal(T.shifts().numpy(),
                                  np.asarray(jT.shifts()))
    np.testing.assert_array_equal(T._Sm(torch.float32).numpy(),
                                  np.asarray(jT._Sm(jnp.float32)))
    G = T._G(torch.float32).numpy()
    assert np.abs(G - np.asarray(jT._G(jnp.float32))).max() <= C2


@pytest.mark.parametrize("fut", ["wht", "dct"])
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("N,S", [(512, 512), (1000, 3000), (700, 300)])
def test_apply_matches_reference(fut, rowwise, N, S):
    jT, T = _pair(N, S, seed=6, fut=fut)
    A = _operand(37, N, seed=1)
    if not rowwise:
        A = np.ascontiguousarray(A.T)
    jdim = jsk.ROWWISE if rowwise else jsk.COLUMNWISE
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    want = jT.apply(jnp.asarray(A), jdim)
    got = T.apply(A, dim, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want)
    assert not any(cuda_fastfood.launches.values())


@pytest.mark.parametrize("variant", ["fused", "split"])
@pytest.mark.parametrize("NB", [512, 1024, 2048])
@pytest.mark.parametrize("nb", [1, 3])
def test_plain_version_matches_interpreted_pallas_kernel(variant, NB, nb):
    N = NB - 24                       # not a power of two: zero padding
    S = (nb - 1) * NB + NB // 2 + 7   # the last block truncated
    jT, T = _pair(N, S, seed=7)
    assert (T._NB, T._numblks) == (NB, nb)
    A = _operand(19, N, seed=2)
    want = jpf.features_rows(jT, jnp.asarray(A), interpret=True,
                             precision="f32", variant=variant)
    assert want is not None
    got = cuda_fastfood.features_rows(T, torch.from_numpy(A), variant)
    _close(got, want)
    torch.testing.assert_close(cuda_fastfood.fastfood_plain(
        T, torch.from_numpy(A)), got, rtol=0, atol=0)
    assert not any(cuda_fastfood.launches.values())


def test_permutation_direction_is_pinned():
    # Π gathers out[j] = in[perm[j]]; the inverse permutation gives other
    # features, far outside the oracle
    jT, T = _pair(512, 512, seed=8)
    A = torch.from_numpy(_operand(9, 512, seed=3))
    want = np.asarray(jT.apply(jnp.asarray(A.numpy()), jsk.ROWWISE))
    _close(T.apply(A, sk.ROWWISE, device="cpu"), want)
    perms = T._perms()
    inverse = torch.argsort(perms, dim=1)
    assert not torch.equal(perms, inverse)
    wrong = frft._chain_rows(A, T._B(torch.float32), T._G(torch.float32),
                             T._Sm(torch.float32), inverse, T.shifts(),
                             T.scale, T.scal, T._NB, T._numblks,
                             T._fut_apply)
    assert np.abs(wrong.numpy() - want).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("NB", [512, 1024, 2048, 4096])
def test_scal_is_the_float64_product(NB):
    T = sk.FastGaussianRFT(NB, 8, Context(0))
    assert T.scal == math.sqrt(NB) * (1.0 / math.sqrt(NB))
    _, _, gdiag, smdiag, _ = cuda_fastfood.kernel_streams(T)
    torch.testing.assert_close(gdiag, T.scal * T._G(torch.float32),
                               rtol=0, atol=0)
    torch.testing.assert_close(smdiag.reshape(-1),
                               T.scal * T._Sm(torch.float32), rtol=0, atol=0)


def test_kernel_streams_pad_shifts_past_s():
    T = sk.FastGaussianRFT(1000, 2500, Context(3))
    bdiag, perms, _, _, sh = cuda_fastfood.kernel_streams(T)
    assert bdiag.shape == perms.shape == sh.shape == (3, 1024)
    assert perms.dtype == torch.int64
    torch.testing.assert_close(sh.reshape(-1)[:2500], T.shifts(),
                               rtol=0, atol=0)
    assert not sh.reshape(-1)[2500:].any()


def test_block_geometry_is_the_reference_rule():
    for N, S, fut in [(1, 1, "wht"), (512, 512, "wht"), (513, 100, "wht"),
                      (1000, 3000, "wht"), (300, 700, "dct")]:
        assert frft.block_geometry(N, S, fut) == jsk.frft.block_geometry(
            N, S, fut)


def test_routes_and_dispatch_rule(monkeypatch):
    calls = []
    real = cuda_fastfood.features_rows
    monkeypatch.setattr(cuda_fastfood, "features_rows",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    A = _operand(4, 300, seed=4)
    sk.FastGaussianRFT(300, 64, Context(1)).apply(A, sk.ROWWISE,
                                                  device="cpu")
    sk.FastGaussianRFT(300, 64, Context(1)).apply(A.T, sk.COLUMNWISE,
                                                  device="cpu")
    assert calls == [1, 1]
    sk.FastGaussianRFT(300, 64, Context(1), fut="dct").apply(
        A, sk.ROWWISE, device="cpu")
    sk.FastGaussianRFT(300, 64, Context(1)).apply(
        A.astype(np.float64), sk.ROWWISE, device="cpu")
    assert calls == [1, 1]
    big = sk.FastGaussianRFT(cuda_fastfood.MAX_NB + 1, 8, Context(0))
    assert big._NB == 2 * cuda_fastfood.MAX_NB
    assert not big._kernel_serves(torch.zeros(1, big._N))
    assert cuda_fastfood.supported(2, torch.float32)
    assert not cuda_fastfood.supported(1536, torch.float32)
    with pytest.raises(errors.UnsupportedError):
        cuda_fastfood.features_rows(big, torch.zeros(1, big._N))
    T = sk.FastGaussianRFT(300, 64, Context(1))
    with pytest.raises(errors.InvalidParametersError):
        cuda_fastfood.features_rows(T, torch.from_numpy(A), variant="fast")
    # the launch on given streams takes CUDA tensors only
    with pytest.raises(errors.UnsupportedError):
        cuda_fastfood.apply_streams(torch.from_numpy(A),
                                    cuda_fastfood.kernel_streams(T),
                                    T.scale, 64)


def test_columnwise_is_rowwise_transposed():
    T = sk.FastGaussianRFT(700, 900, Context(2), sigma=20.0)
    A = _operand(11, 700, seed=5)
    torch.testing.assert_close(
        T.apply(A.T, sk.COLUMNWISE, device="cpu"),
        T.apply(A, sk.ROWWISE, device="cpu").T, rtol=0, atol=0)


@pytest.mark.parametrize("fut", ["wht", "dct"])
def test_reference_json_loads_to_same_transform(fut):
    jT, T = _pair(700, 300, seed=9, fut=fut)
    assert T.to_dict() == jT.to_dict()
    U = interop.transform_from_reference(jT.to_json())
    assert type(U) is sk.FastGaussianRFT and U.to_dict() == jT.to_dict()
    np.testing.assert_array_equal(U._perms().numpy(), T._perms().numpy())


def test_fast_matern_raises():
    """FastMaternRFT raised while the Gamma sampler was missing; now it
    constructs, and the reference's JSON carries across to the same
    transform (its features are held in test_torch_matern.py)."""
    T = sk.FastMaternRFT(64, 16, Context(0), nu=1.5)
    ref = jsk.FastMaternRFT(64, 16, JContext(0), nu=1.5).to_json()
    got = interop.transform_from_reference(ref)
    assert type(got) is sk.FastMaternRFT
    assert got.to_dict() == T.to_dict() == json.loads(ref)
