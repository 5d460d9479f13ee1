"""The port's RFUT/FJLT and panel-free SRHT against the JAX package, on the
CPU.

On a CPU tensor the SRHT kernel's wrapper runs its plain version, so
these tests hold that plain version and the port's plain chain to the
reference's XLA twins (``FJLT.apply``, ``fjlt.srht_serve_apply``), never
to the Pallas kernel's interpret output, whose stream replay follows an
older layout (ROADMAP C1). Bounds:

- ``diagonal()``/``sample_indices()``: bit-equal;
- applies, all three mixers, both orientations: max |Δ| ≤ 1e-4 · max |ref|;
- SRHT on dyadic data (integer operands, n and s even powers of two):
  bit-equal, as every step is exact; on Gaussian data ≤ 1e-4 as above;
- ``operator_panel``/``fold_rows``: bit-equal on dyadic data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.sketch import fjlt as jfjlt
from libskylark_tpu_torch import interop
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_fwht, fjlt

ORACLE = 1e-4


def _operand(n, m, rowwise, integer=False, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        A = rng.integers(-8, 9, (n, m)).astype(np.float32)
    else:
        A = rng.standard_normal((n, m)).astype(np.float32)
    return np.ascontiguousarray(A.T) if rowwise else A


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ORACLE * np.abs(want).max()


def _dims(rowwise):
    return ((jsk.ROWWISE, sk.ROWWISE) if rowwise
            else (jsk.COLUMNWISE, sk.COLUMNWISE))


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    for k in cuda_fwht.launches:
        cuda_fwht.launches[k] = 0


@pytest.mark.parametrize("fut,n,s", [("dct", 1000, 64), ("wht", 4096, 300)])
def test_streams_bit_equal(fut, n, s):
    jT = jsk.FJLT(n, s, JContext(7), fut=fut)
    T = sk.FJLT(n, s, Context(7), fut=fut)
    np.testing.assert_array_equal(T.diagonal().numpy(),
                                  np.asarray(jT.diagonal()))
    np.testing.assert_array_equal(T.sample_indices().numpy(),
                                  np.asarray(jT.sample_indices()))


@pytest.mark.parametrize("fut", ["dct", "dht", "wht"])
@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("n,s", [(512, 100), (4096, 256)])
def test_fjlt_apply_matches_reference(fut, rowwise, n, s):
    jT = jsk.FJLT(n, s, JContext(3), fut=fut)
    T = sk.FJLT(n, s, Context(3), fut=fut)
    A = _operand(n, 5, rowwise)
    jdim, dim = _dims(rowwise)
    got = T.apply(A, dim, device="cpu")
    assert got.dtype == torch.float32
    _close(got, jT.apply(jnp.asarray(A), jdim))


@pytest.mark.parametrize("fut", ["dct", "dht"])
def test_fjlt_ragged_extent_matches_reference(fut):
    jT = jsk.FJLT(1000, 64, JContext(4), fut=fut)
    T = sk.FJLT(1000, 64, Context(4), fut=fut)
    for rowwise in (False, True):
        A = _operand(1000, 3, rowwise, seed=1)
        jdim, dim = _dims(rowwise)
        _close(T.apply(A, dim, device="cpu"), jT.apply(jnp.asarray(A), jdim))


@pytest.mark.parametrize("fut", ["dct", "dht", "wht"])
@pytest.mark.parametrize("rowwise", [False, True])
def test_rfut_apply_matches_reference(fut, rowwise):
    jT = jsk.RFUT(256, JContext(5), fut=fut)
    T = sk.RFUT(256, Context(5), fut=fut)
    A = _operand(256, 4, rowwise)
    jdim, dim = _dims(rowwise)
    _close(T.apply(A, dim, device="cpu"), jT.apply(jnp.asarray(A), jdim))


@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("integer,n,s", [(True, 4096, 256),
                                         (False, 8192, 1024),
                                         (False, 128, 7)])
def test_srht_matches_reference_serve_apply(rowwise, integer, n, s):
    T = sk.FJLT(n, s, Context(9), fut="wht")
    jkey = jax.random.key_data(jsk.FJLT(n, s, JContext(9), fut="wht")
                               .allocation.key)
    A = _operand(n, 6, rowwise, integer=integer, seed=2)
    want = np.asarray(jfjlt.srht_serve_apply(jkey, jnp.asarray(A), s_dim=s,
                                             rowwise=rowwise))
    for got in (fjlt.srht_serve_apply(T.allocation.key, torch.from_numpy(A),
                                      s_dim=s, rowwise=rowwise),
                cuda_fwht.srht_apply_plain(T.allocation.key,
                                           torch.from_numpy(A), s, rowwise),
                T.apply(A, sk.ROWWISE if rowwise else sk.COLUMNWISE,
                        device="cpu")):
        if integer:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _close(got, want)
    assert cuda_fwht.launches == {"fwht_rowwise": 0, "fwht_columnwise": 0}


def test_srht_kernel_route_rule():
    assert cuda_fwht.supported(128, 2048, torch.float32)
    assert not cuda_fwht.supported(64, 8, torch.float32)
    assert not cuda_fwht.supported(4096, 2049, torch.float32)
    assert not cuda_fwht.supported(1000, 8, torch.float32)
    assert not cuda_fwht.supported(4096, 8, torch.float64)
    assert sk.FJLT(4096, 64, Context(0), fut="wht")._kernel_serves(
        torch.ones(4096, 1))
    assert not sk.FJLT(4096, 64, Context(0))._kernel_serves(
        torch.ones(4096, 1))


def test_srht_off_the_kernel_route_matches_reference():
    # s > 2048 takes the plain chain
    n, s = 4096, 2100
    jT = jsk.FJLT(n, s, JContext(6), fut="wht")
    T = sk.FJLT(n, s, Context(6), fut="wht")
    A = _operand(n, 3, False, integer=True)
    np.testing.assert_array_equal(
        T.apply(A, sk.COLUMNWISE, device="cpu").numpy(),
        np.asarray(jT.apply(jnp.asarray(A), jsk.COLUMNWISE)))


def test_srht_serve_rejects_non_power_of_two():
    with pytest.raises(errors.InvalidParametersError):
        fjlt.srht_serve_apply(Context(0).allocate().key, torch.ones(100, 2),
                              s_dim=8, rowwise=False)
    with pytest.raises(errors.UnsupportedError):
        cuda_fwht.srht_apply(Context(0).allocate().key, torch.ones(100, 2),
                             8, False)


@pytest.mark.parametrize("lo,hi", [(0, 1024), (100, 900), (3, 4)])
def test_operator_panel_and_fold_rows_match_reference(lo, hi):
    n, s = 1024, 64
    jT = jsk.FJLT(n, s, JContext(8), fut="wht")
    T = sk.FJLT(n, s, Context(8), fut="wht")
    panel = T.operator_panel(lo, hi)
    np.testing.assert_array_equal(panel, np.asarray(jT.operator_panel(lo,
                                                                      hi)))
    X = np.random.default_rng(5).integers(-4, 5, (hi - lo, 3)).astype(
        np.float32)
    folded = T.fold_rows(torch.from_numpy(X), lo, hi).numpy()
    np.testing.assert_array_equal(
        folded, np.asarray(jT.fold_rows(jnp.asarray(X), lo, hi)))
    np.testing.assert_array_equal(folded, panel @ X)
    diag = T.diagonal().numpy()
    np.testing.assert_array_equal(
        T.fold_rows(torch.from_numpy(X), lo, hi, diagonal=diag).numpy(),
        folded)


def test_operator_panel_is_the_apply():
    n, s = 1024, 64
    T = sk.FJLT(n, s, Context(2), fut="wht")
    A = _operand(n, 4, False, integer=True)
    np.testing.assert_array_equal(T.operator_panel(0, n) @ A,
                                  T.apply(A, sk.COLUMNWISE,
                                          device="cpu").numpy())


def test_closed_forms_need_the_wht_mixer():
    T = sk.FJLT(1024, 8, Context(0))
    with pytest.raises(errors.UnsupportedError):
        T.operator_panel(0, 4)
    with pytest.raises(errors.UnsupportedError):
        T.fold_rows(torch.ones(4, 1), 0, 4)


@pytest.mark.parametrize("cls,args,fut", [("FJLT", (512, 64), "wht"),
                                          ("FJLT", (500, 64), "dht"),
                                          ("RFUT", (256,), "dct")])
def test_reference_json_loads_as_the_same_operator(cls, args, fut):
    jT = getattr(jsk, cls)(*args, JContext(11, 4), fut=fut)
    T = interop.transform_from_reference(jT.to_json())
    assert type(T).__name__ == cls and T._fut_name == fut
    assert T.to_dict()["creation_context"] == jT.to_dict()["creation_context"]
    A = _operand(args[0], 3, False, seed=6)
    _close(T.apply(A, sk.COLUMNWISE, device="cpu"),
           jT.apply(jnp.asarray(A), jsk.COLUMNWISE))
    back = jsk.deserialize_sketch(T.to_json())
    _close(back.apply(jnp.asarray(A), jsk.COLUMNWISE),
           T.apply(A, sk.COLUMNWISE, device="cpu"))
