"""The port's dense-block operator format against the JAX package.

``dense_block``/``dense_panel`` build the same virtual matrix from the
same Threefry bits. Integer-only maps are bit-equal (Rademacher, Uniform);
Normal differs only where the two erfinv implementations round their
log1p differently (max |Δ| ≤ 1e-5); Cauchy only where the two tan
implementations round differently (relative ≤ 1e-5). StandardLevy, which
has no bit transform, keeps the legacy format (jax.random's normal over
each block's flat index, then 1/max(z², tiny)): relative ≤ 1e-5.
``permutation`` is bit-equal to ``jax.random.permutation``, on both sides
of the change from one sort round to two (n = 1625, 1626).
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from libskylark_tpu.base import randgen as jrandgen
from libskylark_tpu.base.context import Allocation as JAllocation
from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import Allocation

NORMAL_ABS_TOL = 1e-5
CAUCHY_REL_TOL = 1e-5

DISTS = {
    "normal": (jrandgen.Normal(), randgen.Normal()),
    "cauchy": (jrandgen.Cauchy(), randgen.Cauchy()),
    "rademacher": (jrandgen.Rademacher(), randgen.Rademacher()),
    "uniform": (jrandgen.Uniform(-2.0, 3.0), randgen.Uniform(-2.0, 3.0)),
    "standard_levy": (jrandgen.StandardLevy(), randgen.StandardLevy()),
}


def _assert_close(name, got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    if name in ("rademacher", "uniform"):
        np.testing.assert_array_equal(got, want)
    elif name == "normal":
        assert np.abs(got - want).max() <= NORMAL_ABS_TOL
    else:
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert rel.max() <= CAUCHY_REL_TOL


@pytest.mark.parametrize("name", list(DISTS))
@pytest.mark.parametrize("rows,block_id", [(16, 0), (48, 3), (5, 2**31 + 1)])
def test_dense_block_matches_reference(name, rows, block_id):
    jdist, dist = DISTS[name]
    want = np.asarray(jrandgen.dense_block(
        JAllocation(42, 3).key, jdist, rows, block_id, 256, jnp.float32))
    got = randgen.dense_block(Allocation(42, 3).key, dist, rows, block_id,
                              256).numpy()
    _assert_close(name, got, want)


@pytest.mark.parametrize("name", list(DISTS))
@pytest.mark.parametrize("lo,hi", [(0, 700), (100, 333), (300, 301),
                                   (256, 1024)])
def test_dense_panel_ragged_matches_reference(name, lo, hi):
    jdist, dist = DISTS[name]
    want = np.asarray(jrandgen.dense_panel(
        JAllocation(7, 1, (2,)).key, jdist, 24, lo, hi, 256, jnp.float32))
    got = randgen.dense_panel(Allocation(7, 1, (2,)).key, dist, 24, lo, hi,
                              256).numpy()
    _assert_close(name, got, want)


def test_panel_is_a_slice_of_the_whole():
    key = Allocation(1, 0).key
    whole = randgen.dense_panel(key, randgen.Normal(), 8, 0, 1024, 256)
    part = randgen.dense_panel(key, randgen.Normal(), 8, 300, 900, 256)
    torch.testing.assert_close(part, whole[:, 300:900], rtol=0, atol=0)


def test_normal_is_standard():
    x = randgen.dense_panel(Allocation(3, 0).key, randgen.Normal(), 64, 0,
                            4096, 256).double()
    assert abs(float(x.mean())) < 0.01
    assert abs(float(x.std()) - 1.0) < 0.01


def test_distribution_dict_round_trip_and_unported():
    """Every distribution round-trips; Gamma, once the unported one, now
    does too (its sampler: test_torch_gamma.py); a name neither package
    defines raises."""
    for _, dist in DISTS.values():
        assert randgen.Distribution.from_dict(dist.to_dict()) == dist
    assert (DISTS["cauchy"][0].to_dict()
            == DISTS["cauchy"][1].to_dict())
    assert (randgen.Distribution.from_dict({"distribution": "gamma"})
            == randgen.Gamma())
    with pytest.raises(errors.NotImplementedYetError):
        randgen.Distribution.from_dict({"distribution": "poisson"})


@pytest.mark.parametrize("n", [1, 2, 127, 1625, 1626, 4096, 5000])
def test_permutation_matches_reference(n):
    want = np.asarray(jr.permutation(JAllocation(5, 2).key, n))
    got = randgen.permutation(Allocation(5, 2).key, n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))


def test_permutation_under_a_folded_key_matches_reference():
    # Fastfood's per-block keys: fold_in(subkey(3), i)
    jkey = jr.fold_in(JAllocation(9, 4, (3,)).key, 2)
    key = Allocation(9, 4, (3,)).key
    from libskylark_tpu_torch.base.context import fold_in

    np.testing.assert_array_equal(
        randgen.permutation(fold_in(key, 2), 777).numpy(),
        np.asarray(jr.permutation(jkey, 777)))


def test_standard_levy_stream_matches_reference():
    want = np.asarray(jrandgen.stream_slice(
        JAllocation(4, 1).key, jrandgen.StandardLevy(), 100, 9000))
    got = randgen.stream_slice(Allocation(4, 1).key, randgen.StandardLevy(),
                               100, 9000).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (np.abs(got - want) / np.abs(want)).max() <= CAUCHY_REL_TOL
    assert got.min() > 0
