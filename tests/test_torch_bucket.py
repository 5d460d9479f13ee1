"""The port's shape classes (libskylark_tpu_torch/engine/bucket.py) against
the JAX package's engine/bucket.py, on the CPU: every function equal to
the reference's on a grid of extents, nnz counts and ``max_batch`` values
(integer results exactly; stacked buffers bit for bit)."""

import numpy as np
import pytest
import torch

from libskylark_tpu.engine import bucket as ref
from libskylark_tpu_torch.engine import bucket

EXTENTS = [0, 1, 2, 7, 8, 9, 15, 16, 17, 100, 1000, 1023, 1024, 1025,
           47236]
FLOORS = [1, 8, 64]
MAX_BATCH = [1, 2, 3, 4, 6, 8, 12, 16]


def test_pad_floor():
    assert bucket.PAD_FLOOR == ref.PAD_FLOOR == 8


@pytest.mark.parametrize("floor", FLOORS)
def test_pow2_pad(floor):
    for n in EXTENTS:
        assert bucket.pow2_pad(n, floor) == ref.pow2_pad(n, floor)


@pytest.mark.parametrize("axes", [(), (0,), (1,), (0, 1)])
def test_pad_shape(axes):
    for shape in [(1, 1), (9, 300), (1537, 8192), (8192, 65), (3, 47236)]:
        assert bucket.pad_shape(shape, axes) == ref.pad_shape(shape, axes)
        assert bucket.pad_shape(shape, axes, 1) == ref.pad_shape(shape, axes,
                                                                 1)


@pytest.mark.parametrize("floor", FLOORS)
def test_nnz_class(floor):
    for nnz in EXTENTS + [309_621, 524_288, 524_289]:
        assert bucket.nnz_class(nnz, floor) == ref.nnz_class(nnz, floor)


@pytest.mark.parametrize("max_batch", MAX_BATCH)
def test_capacity_class_and_ladder(max_batch):
    for multiple in (1, 2, 4):
        for k in range(0, 20):
            assert (bucket.capacity_class(k, max_batch, multiple)
                    == ref.capacity_class(k, max_batch, multiple))
        assert (bucket.capacity_ladder(max_batch, multiple)
                == ref.capacity_ladder(max_batch, multiple))


@pytest.mark.parametrize("capacity", [3, 4, 8])
def test_stack_pad_replicates_the_last_request(capacity):
    rng = np.random.default_rng(capacity)
    arrays = [rng.standard_normal((int(rng.integers(1, 9)), 5)).astype(
        np.float32) for _ in range(3)]
    got = bucket.stack_pad(arrays, (8, 5), capacity, np.float32)
    want = ref.stack_pad(arrays, (8, 5), capacity, np.float32)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # filler lanes replicate the last real request, never zeros
    for i in range(3, capacity):
        assert np.array_equal(got[i], got[2])


@pytest.mark.parametrize("on_host", [True, False])
def test_stack_pad_tensor_equals_the_host_stack(on_host):
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((4, int(rng.integers(1, 6)))).astype(
        np.float32) for _ in range(3)]
    ops = arrays if on_host else [torch.from_numpy(a) * 1 for a in arrays]
    got = bucket.stack_pad_tensor(ops, (4, 8), 4, torch.float32, "cpu")
    want = ref.stack_pad(arrays, (4, 8), 4, np.float32)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_element_accounting():
    shapes = [(3, 5), (8, 1), (1, 1)]
    assert bucket.real_elements(shapes) == ref.real_elements(shapes)
    for shape, cap in [((8, 8), 4), ((2048, 8192), 8), ((524288,), 3)]:
        assert (bucket.padded_elements(shape, cap)
                == ref.padded_elements(shape, cap))
