"""The port's streaming CountSketch (io/streaming.py) and B2's
accumulate mode (``cuda_hash.cwt_apply(..., out=acc)``) against the JAX
package, on the CPU.

- ``StreamingCWT.sketch`` is ``torch.equal`` to the reference's streamed
  sketch and to the port's one-shot ``CWT.apply`` of the concatenated
  rows, at batch sizes that are and are not multiples of B2's 1024-row
  tile, with and without prefetch, with dummy-coded labels; a pass
  checkpointed part way and resumed by a fresh ``StreamingCWT`` is
  ``torch.equal`` to it; the resume refuses a different stream, changed
  batching, a truncated stream and another digest scheme;
- ``stream_sketch_libsvm`` over a libsvm file equals the one-shot sketch
  of the file;
- B2-accumulate's plain version (the scatter into a clone of the carried
  accumulator) is ``torch.equal`` to the reference's carried scatter
  ``SX.at[h].add(v[:, None] * X)`` at row offsets inside and across
  tiles, with buckets the batch leaves empty keeping their value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from libskylark_tpu import io as rio
from libskylark_tpu import sketch as rsk
from libskylark_tpu.base.context import Context as RContext
from libskylark_tpu_torch import io as pio
from libskylark_tpu_torch import sketch as psk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.io.chunked import iter_array_batches
from libskylark_tpu_torch.sketch import cuda_hash
from libskylark_tpu_torch.utility.checkpoint import TrainCheckpointer

N, D, S = 2600, 6, 96


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)).astype(np.float32)
    Y = rng.integers(0, 4, n).astype(np.float32)
    return X, Y


def _port(n=N, seed=3):
    return pio.StreamingCWT(n, S, Context(seed), device="cpu")


@pytest.mark.parametrize("batch,classes,depth", [
    (1024, 0, 0), (700, 0, 2), (1, 4, 0), (2600, 2, 1), (333, 4, 2)])
def test_stream_equals_reference_and_one_shot(batch, classes, depth):
    X, Y = _data()
    n = N if batch != 1 else 40
    X, Y = X[:n], Y[:n]
    SX, SY = _port(n).sketch(iter_array_batches(X, batch, Y),
                             num_classes=classes, prefetch_depth=depth)
    RX, RY = rio.StreamingCWT(n, S, RContext(3)).sketch(
        iter_array_batches(X, batch, Y), num_classes=classes,
        prefetch_depth=0)
    np.testing.assert_array_equal(SX.numpy(), np.asarray(RX))
    np.testing.assert_array_equal(SY.numpy(), np.asarray(RY))
    one = psk.CWT(n, S, Context(3)).apply(torch.from_numpy(X), device="cpu")
    assert torch.equal(SX, one)


def test_checkpoint_resume_is_uninterrupted(tmp_path):
    X, Y = _data()
    batches = list(iter_array_batches(X, 500, Y))
    want = _port().sketch(batches)
    d = str(tmp_path)
    part = _port().sketch(batches[:3], checkpoint=d, checkpoint_every=2)
    assert TrainCheckpointer(d).all_steps() == [1000, 1500]
    assert part[0].shape == want[0].shape
    got = _port().sketch(iter(batches), checkpoint=d, checkpoint_every=2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    def untouched():
        raise AssertionError("a finished stream is not read again")
        yield

    again = _port().sketch(untouched(), checkpoint=d)
    assert torch.equal(again[0], want[0])


def test_resume_refusals(tmp_path):
    X, Y = _data()
    batches = list(iter_array_batches(X, 500, Y))
    d = str(tmp_path / "a")
    _port().sketch(batches[:3], checkpoint=d, checkpoint_every=2)
    X2 = X.copy()
    X2[0, 0] += 1.0
    with pytest.raises(errors.InvalidParametersError, match="first batch"):
        _port().sketch(iter_array_batches(X2, 500, Y), checkpoint=d)
    regrouped = [(X[a:b], Y[a:b]) for a, b in ((0, 500), (500, 1200),
                                               (1200, 1900), (1900, N))]
    with pytest.raises(errors.InvalidParametersError, match="straddles"):
        _port().sketch(regrouped, checkpoint=d)
    with pytest.raises(errors.InvalidParametersError, match="ended"):
        _port().sketch(batches[:2], checkpoint=d)
    with pytest.raises(errors.InvalidParametersError, match="different"):
        _port(seed=4).sketch(batches, checkpoint=d)
    c = TrainCheckpointer(str(tmp_path / "b"))
    c.save(500, {"SX": np.zeros((S, D), np.float32),
                 "SY": np.zeros((S, 1), np.float32)},
           {"digest_scheme": 1, "rows": 500})
    c.close()
    with pytest.raises(errors.InvalidParametersError, match="scheme"):
        _port().sketch(batches, checkpoint=str(tmp_path / "b"))
    with pytest.raises(ValueError, match="longer"):
        _port(n=1000).sketch(batches)


def test_stream_sketch_libsvm_equals_the_one_shot(tmp_path):
    p = tmp_path / "d.libsvm"
    p.write_text("".join(W.io_libsvm_lines(n=300, d=40)))
    SX, SY = pio.stream_sketch_libsvm(str(p), 32, Context(5), batch_rows=64,
                                      device="cpu")
    X, Y = rio.read_libsvm(str(p))
    T = psk.CWT(X.shape[0], 32, Context(5))
    assert torch.equal(SX, T.apply(torch.from_numpy(X), device="cpu"))
    assert torch.equal(SY, T.apply(torch.from_numpy(Y)[:, None],
                                   device="cpu")[:, 0])
    RX, RY = rio.stream_sketch_libsvm(str(p), 32, RContext(5),
                                      batch_rows=64)
    np.testing.assert_array_equal(SX.numpy(), np.asarray(RX))
    with pytest.raises(errors.InvalidParametersError):
        pio.stream_sketch_libsvm(iter([]), 32, Context(5), device="cpu")


@pytest.mark.parametrize("lo,rows,cols", [(0, 700, 5), (1000, 48, 1),
                                          (1500, 1100, 3), (4090, 12, 2)])
def test_accumulate_plain_equals_the_reference_carried_scatter(lo, rows,
                                                                cols):
    """The accumulate mode's plain version against the reference's carried
    scatter, on an accumulator that already holds earlier rows' sums;
    the launch counter stays 0 on the CPU."""
    n, s = 5000, 256
    rng = np.random.default_rng(lo)
    prior = rng.standard_normal((s, cols)).astype(np.float32)
    B = rng.standard_normal((rows, cols)).astype(np.float32)
    rt = rsk.CWT(n, s, RContext(8))
    h = jnp.asarray(np.asarray(rt.bucket_indices())[lo:lo + rows])
    v = jnp.asarray(np.asarray(rt.values(jnp.float32))[lo:lo + rows])
    want = np.asarray(jnp.asarray(prior).at[h].add(v[:, None]
                                                   * jnp.asarray(B)))
    key = psk.CWT(n, s, Context(8)).kernel_key()
    before = dict(cuda_hash.launches)
    acc = torch.from_numpy(prior.copy())
    out = cuda_hash.cwt_apply(key, torch.from_numpy(B), s, False, n0=lo,
                              out=acc)
    assert out is acc
    np.testing.assert_array_equal(acc.numpy(), want)
    plain = cuda_hash.accumulate_plain(key, torch.from_numpy(B), s,
                                       torch.from_numpy(prior), lo)
    assert torch.equal(plain, acc)
    hit = np.zeros(s, bool)
    hit[np.asarray(h)] = True
    np.testing.assert_array_equal(acc.numpy()[~hit], prior[~hit])
    assert cuda_hash.launches == before


def test_accumulate_refusals():
    key = psk.CWT(64, 8, Context(1)).kernel_key()
    A = torch.ones(4, 3)
    with pytest.raises(errors.InvalidParametersError, match="columnwise"):
        cuda_hash.cwt_apply(key, A, 8, True, out=torch.zeros(3, 8))
    with pytest.raises(errors.InvalidParametersError, match="out must"):
        cuda_hash.cwt_apply(key, A, 8, False, out=torch.zeros(8, 4))
    with pytest.raises(errors.InvalidParametersError, match="out must"):
        cuda_hash.cwt_apply(key, A, 8, False,
                            out=torch.zeros(8, 3, dtype=torch.float64))
