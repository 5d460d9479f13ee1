"""The port's JLT/CT applies against the JAX package, on the CPU.

On a CPU tensor the fused kernel's wrapper runs its plain version, so
these tests hold that plain version (and the port's plain paths) to:

- ``JLT.apply``/``CT.apply`` of the JAX package (its XLA path);
- the JAX package's Pallas kernel in interpret mode, f32 regime;

both at the reference's oracle, max |Δ| ≤ 1e-4 · max |reference|, in both
orientations, at BLOCK_COLS-aligned and ragged shapes. They also pin the
serialized form, the launch counters, and the device policy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import pallas_dense as jpd
from libskylark_tpu_torch import interop
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_dense
from libskylark_tpu_torch.sketch import params as sketch_params

ORACLE = 1e-4  # relative to max |reference|

FAMILIES = {"JLT": (jsk.JLT, sk.JLT), "CT": (jsk.CT, sk.CT)}
# (N, m, s): aligned, and ragged in every extent
SHAPES = [(512, 48, 64), (700, 37, 48)]


def _operand(n, m, rowwise, seed=0):
    A = np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)
    return np.ascontiguousarray(A.T) if rowwise else A


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ORACLE * np.abs(want).max()


def _pair(family, n, s, seed):
    jcls, cls = FAMILIES[family]
    return jcls(n, s, JContext(seed)), cls(n, s, Context(seed))


@pytest.fixture(autouse=True)
def _fresh_knobs():
    yield
    sketch_params.set_blocksize(0)
    for k in cuda_dense.launches:
        cuda_dense.launches[k] = 0


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("n,m,s", SHAPES)
def test_apply_matches_reference(family, rowwise, n, m, s):
    jT, T = _pair(family, n, s, seed=3)
    A = _operand(n, m, rowwise)
    jdim = jsk.ROWWISE if rowwise else jsk.COLUMNWISE
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    want = jT.apply(jnp.asarray(A, jnp.float32), jdim)
    got = T.apply(A, dim, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("n,m,s", SHAPES)
def test_plain_version_matches_interpreted_pallas_kernel(family, rowwise, n,
                                                         m, s):
    jT, T = _pair(family, n, s, seed=4)
    A = _operand(n, m, rowwise, seed=1)
    fn = jpd.rowwise_apply if rowwise else jpd.columnwise_apply
    want = fn(jT.allocation.key, jT.dist, jnp.asarray(A, jnp.float32), s,
              jT.scale, precision="f32", interpret=True)
    assert want is not None
    wrapper = (cuda_dense.rowwise_apply if rowwise
               else cuda_dense.columnwise_apply)
    got = wrapper(T.allocation.key, T.dist, torch.from_numpy(A), s, T.scale)
    _close(got, want)
    assert cuda_dense.launches == {"dense_rowwise": 0,
                                   "dense_columnwise": 0,
                                   "dense_rowwise_cos": 0,
                                   "dense_batched_rowwise": 0,
                                   "dense_batched_columnwise": 0,
                                   "dense_partial_rowwise": 0,
                                   "dense_partial_columnwise": 0}


@pytest.mark.parametrize("rowwise", [True, False])
def test_blocked_path_matches_unblocked(rowwise):
    # float64 is not the kernel's type, so it takes the plain paths
    n, m, s = 700, 9, 32
    A = torch.from_numpy(_operand(n, m, rowwise, seed=2)).double()
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    whole = sk.JLT(n, s, Context(5)).apply(A, dim, device="cpu")
    sketch_params.set_blocksize(256)
    blocked = sk.JLT(n, s, Context(5)).apply(A, dim, device="cpu")
    assert blocked.dtype == torch.float64
    torch.testing.assert_close(blocked, whole, rtol=1e-12, atol=1e-12)


def test_blocked_float64_matches_reference_operator():
    n, s = 700, 32
    A = _operand(n, 5, rowwise=False, seed=6).astype(np.float64)
    jT, T = _pair("JLT", n, s, seed=8)
    sketch_params.set_blocksize(512)
    got = T.apply(A, sk.COLUMNWISE, device="cpu")
    want = np.asarray(jT.s_panel(0, n)).astype(np.float64) @ A
    _close(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_json_loads_to_same_operator(family):
    jT, _ = _pair(family, 700, 48, seed=9)
    if family == "CT":
        jT = jsk.CT(700, 48, JContext(9), C=2.5)
    T = interop.transform_from_reference(jT.to_json())
    assert type(T) is FAMILIES[family][1]
    assert T.to_dict() == jT.to_dict()
    want = np.asarray(jT.s_panel(0, 700))
    got = T.s_panel(0, 700).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert sk.deserialize_sketch(T.to_dict()).to_dict() == jT.to_dict()


def test_port_to_dict_equals_reference_field_for_field():
    jctx, ctx = JContext(12), Context(12)
    for jcls, cls in FAMILIES.values():
        assert cls(300, 20, ctx).to_dict() == jcls(300, 20, jctx).to_dict()
    assert ctx.to_dict() == jctx.to_dict()
    assert interop.context_from_reference(jctx.to_json()).counter == 2


def test_wrong_stream_format_is_refused():
    d = sk.JLT(64, 8, Context(0)).to_dict()
    d["stream_format"] = 1
    with pytest.raises(errors.SketchError):
        sk.deserialize_sketch(d)


def test_cpu_tensor_leaves_launch_counters_at_zero():
    T = sk.JLT(512, 16, Context(1))
    T.apply(_operand(512, 4, rowwise=False), sk.COLUMNWISE, device="cpu")
    T.apply(_operand(512, 4, rowwise=True), sk.ROWWISE, device="cpu")
    assert cuda_dense.launches == {"dense_rowwise": 0,
                                   "dense_columnwise": 0,
                                   "dense_rowwise_cos": 0,
                                   "dense_batched_rowwise": 0,
                                   "dense_batched_columnwise": 0,
                                   "dense_partial_rowwise": 0,
                                   "dense_partial_columnwise": 0}


def test_dispatch_rule_is_the_reference_rule():
    f32, f64 = torch.float32, torch.float64
    for (jdist, dist) in [(jsk.JLT.dist, sk.JLT.dist),
                          (jsk.CT.dist, sk.CT.dist)]:
        assert cuda_dense.supported(dist, f32) == jpd.supported(jdist,
                                                                jnp.float32)
        assert not cuda_dense.supported(dist, f64)
    assert cuda_dense.supported(randgen.Rademacher(), f32)
    assert not cuda_dense.supported(randgen.Normal(0.0, 2.0), f32)
    assert not cuda_dense.supported(randgen.Uniform(), f32)


def test_unported_precision_regimes_raise():
    # every regime the reference names now runs (bf16 and bf16gen2 too);
    # a regime it does not name still raises, at the setter and the wrapper
    A = torch.from_numpy(_operand(256, 4, rowwise=True))
    key = Context(0).allocate().key
    for p in ("bf16", "bf16gen2"):
        got = cuda_dense.rowwise_apply(key, randgen.Normal(), A, 8, 1.0,
                                       precision=p)
        assert got.shape == (4, 8) and bool(torch.isfinite(got).all())
        sketch_params.set_kernel_precision(p)
        assert sketch_params.get_kernel_precision() == p
        sketch_params.set_kernel_precision("bf16x3")
    for p in ("tf32", "fp8"):
        with pytest.raises(errors.InvalidParametersError):
            cuda_dense.rowwise_apply(key, randgen.Normal(), A, 8, 1.0,
                                     precision=p)
        with pytest.raises(errors.InvalidParametersError):
            sketch_params.set_kernel_precision(p)
    assert sketch_params.get_kernel_precision() == "bf16x3"


def test_unknown_precision_regime_is_refused():
    with pytest.raises(errors.InvalidParametersError):
        sketch_params.set_kernel_precision("tf32")
    with pytest.raises(errors.InvalidParametersError):
        cuda_dense.columnwise_apply(Context(0).allocate().key,
                                    randgen.Normal(), torch.zeros(256, 4),
                                    8, 1.0, precision="tf32")
    sketch_params.set_kernel_precision("f32")
    assert sketch_params.get_kernel_precision() == "f32"
    sketch_params.set_kernel_precision("bf16x3")


@pytest.mark.parametrize("rowwise", [True, False])
def test_pinned_operator_does_not_bypass_the_kernel(rowwise, monkeypatch):
    # A pinned S must not route a kernel-served apply past the kernel:
    # with the wrapper stubbed out, the apply still reaches it.
    name = "rowwise_apply" if rowwise else "columnwise_apply"
    calls = []
    real = getattr(cuda_dense, name)

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return real(*args, **kw)

    monkeypatch.setattr(cuda_dense, name, spy)
    n, m, s = 512, 6, 16
    T = sk.JLT(n, s, Context(13)).materialize(torch.float32, "cpu")
    A = torch.from_numpy(_operand(n, m, rowwise, seed=3))
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    got = T.apply(A, dim, device="cpu")
    assert calls == [tuple(A.shape)]
    want = sk.JLT(n, s, Context(13)).apply(A, dim, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("rowwise", [True, False])
def test_pinned_operator_serves_the_plain_path(rowwise):
    # float64 is not the kernel's type: a pinned operator serves it
    n, m, s = 700, 5, 24
    A = torch.from_numpy(_operand(n, m, rowwise, seed=4)).double()
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    T = sk.JLT(n, s, Context(14)).materialize(torch.float64, "cpu")
    T._op_cache.zero_()  # a pinned operator that is read gives zeros
    assert not T.apply(A, dim, device="cpu").any()
    assert sk.JLT(n, s, Context(14)).apply(A, dim, device="cpu").any()


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    T = sk.JLT(64, 8, Context(0))
    A = _operand(64, 3, rowwise=False)
    with pytest.raises(errors.UnsupportedError):
        T.apply(A, sk.COLUMNWISE, device="cuda")
    with pytest.raises(errors.UnsupportedError):
        T.apply(A, sk.COLUMNWISE)  # the package default is "cuda"
    assert cuda_dense.launches == {"dense_rowwise": 0,
                                   "dense_columnwise": 0,
                                   "dense_rowwise_cos": 0,
                                   "dense_batched_rowwise": 0,
                                   "dense_batched_columnwise": 0,
                                   "dense_partial_rowwise": 0,
                                   "dense_partial_columnwise": 0}
