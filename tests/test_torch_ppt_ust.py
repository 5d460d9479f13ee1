"""The port's TensorSketch (PPT) and uniform sampling (UST) against the JAX
package, on the CPU; and the two pieces of the transform protocol they
need, ``Allocation.child`` and the ``_build`` hook.

- sub-allocation keys (``child``) bit-equal to the reference's;
- PPT ``.apply`` both orientations, q = 1, 2, 3: max |Δ| ≤ 1e-4·max|ref|
  (its CWTs are bit-equal, the FFT products round in another order);
  its q CWTs take the CountSketch kernel's route (the plain version on a
  CPU tensor);
- UST indices, with and without replacement, bit-equal, and the apply
  is an exact column or row selection.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from libskylark_tpu import sketch as jsk
from libskylark_tpu.base.context import Allocation as JAllocation
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import interop
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Allocation, Context
from libskylark_tpu_torch.sketch import cuda_hash
from libskylark_tpu_torch.sketch.transform import SketchTransform

ORACLE = 1e-4


def _operand(m, n, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ORACLE * np.abs(want).max()


@pytest.mark.parametrize("path", [(), (3,), (0, 7)])
def test_child_key_matches_reference(path):
    a, ja = Allocation(11, 4, path), JAllocation(11, 4, path)
    for tag in (0, 5):
        assert a.child(tag) == Allocation(11, 4, path + (tag,))
        np.testing.assert_array_equal(
            a.child(tag).key, np.asarray(jr.key_data(ja.child(tag).key)))


def test_build_hook_runs_after_allocation():
    seen = []

    class Probe(SketchTransform):
        def _build(self):
            seen.append((self._N, self._S, self._alloc))

    Probe(8, 4, Context(2))
    assert seen == [(8, 4, Allocation(2, 0))]


@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("rowwise", [True, False])
def test_ppt_matches_reference(q, rowwise):
    N, S, m = 64, 96, 20
    jT = jsk.PPT(N, S, JContext(2), q=q, c=0.5, gamma=0.25)
    T = sk.PPT(N, S, Context(2), q=q, c=0.5, gamma=0.25)
    A = _operand(m, N)
    if not rowwise:
        A = np.ascontiguousarray(A.T)
    jdim = jsk.ROWWISE if rowwise else jsk.COLUMNWISE
    dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
    got = T.apply(A, dim, device="cpu")
    assert got.dtype == torch.float32
    _close(got, jT.apply(jnp.asarray(A), jdim))
    assert [c.allocation for c in T._cwts] == [
        Allocation(2, 0, (i,)) for i in range(q)]


def test_ppt_cwts_take_the_countsketch_route(monkeypatch):
    calls = []
    real = cuda_hash.cwt_apply
    monkeypatch.setattr(cuda_hash, "cwt_apply",
                        lambda *a, **kw: calls.append(a[3]) or real(*a, **kw))
    sk.PPT(40, 32, Context(0), q=3).apply(_operand(4, 40), sk.ROWWISE,
                                          device="cpu")
    assert calls == [False, False, False]  # columnwise, once per CWT
    assert cuda_hash.launches == {"hash_rowwise": 0, "hash_columnwise": 0,
                                  "hash_batched": 0, "hash_offset": 0,
                                  "hash_accumulate": 0}


def test_ppt_parameters_and_json():
    for bad in ({"q": 0}, {"c": -1.0}, {"gamma": -0.5}):
        with pytest.raises(errors.InvalidParametersError):
            sk.PPT(8, 4, Context(0), **bad)
    jT = jsk.PPT(50, 30, JContext(4), q=2, c=2.0, gamma=0.1)
    T = interop.transform_from_reference(jT.to_json())
    assert type(T) is sk.PPT and T.to_dict() == jT.to_dict()


@pytest.mark.parametrize("replace", [True, False])
@pytest.mark.parametrize("N,S", [(64, 30), (5000, 700), (9, 9)])
def test_ust_matches_reference(replace, N, S):
    jT = jsk.UST(N, S, JContext(3), replace=replace)
    T = sk.UST(N, S, Context(3), replace=replace)
    idx = T.sample_indices()
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jT.sample_indices()))
    if not replace:
        assert len(set(idx.tolist())) == S
    A = _operand(6, N)
    np.testing.assert_array_equal(T.apply(A, sk.ROWWISE, device="cpu").numpy(),
                                  A[:, idx.numpy()])
    np.testing.assert_array_equal(
        T.apply(A.T, sk.COLUMNWISE, device="cpu").numpy(),
        np.asarray(jT.apply(jnp.asarray(A.T), jsk.COLUMNWISE)))
    assert T.to_dict() == jT.to_dict()
