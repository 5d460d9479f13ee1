"""The port's parallel layer against the JAX package's (ROADMAP A5's
explicit half).

The port runs SPMD: one gloo group of CPU processes is spawned once for
the file (``torch_dist_worker.run_group``, about 5 s), runs every case on
process meshes of p ∈ {1, 2, 4, 5} ranks and a 2 × 2 grid, and hands its
results back; the reference runs the same cases here, on meshes of the
same shapes over the 8 virtual CPU devices (tests/conftest.py). Limits:
≤ 1e-4·max|reference| (the reference's oracle), CT's Cauchy draws entry
by entry, 1e-4·(|A|·|S|ᵀ) (ROADMAP C2).
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from libskylark_tpu import parallel as rpar, sketch as rsk
from libskylark_tpu.base.context import Context as RContext
from libskylark_tpu.parallel import shard_apply as rsa
from libskylark_tpu.sketch import pallas_dense as rpd
from libskylark_tpu_torch import Context, sketch as sk
from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.parallel import multihost, shard_apply
from libskylark_tpu_torch.sketch import cuda_dense

TOL = 1e-4


@pytest.fixture(scope="module")
def ranks():
    return W.run_group("parallel")


def _value(ranks, key, p):
    """Rank 0's result, after checking every rank of the p-rank mesh
    returned the same array (the result is whole on every rank)."""
    got = ranks[0][key]
    for r in range(1, p):
        np.testing.assert_array_equal(ranks[r][key], got, err_msg=key)
    return got


def _ref_transform(name):
    fam, N, S, _, _, ctx, _ = W.SHARD_CASES[name]
    if fam == "JLT":
        return rsk.JLT(N, S, RContext(seed=ctx))
    return rsk.CT(N, S, RContext(seed=ctx), C=1.0)


def _limit(name, T, A, want):
    """CT: entry by entry TOL·(|A|·|S|ᵀ) (C2); else TOL·max|want|."""
    fam, N, _, _, _, _, cw = W.SHARD_CASES[name]
    if fam != "CT":
        return TOL * np.abs(want).max()
    S = np.abs(np.asarray(T.s_panel(0, N), np.float64))
    Aa = np.abs(A.astype(np.float64))
    return TOL * (S @ Aa if cw else Aa @ S.T)


@pytest.mark.parametrize("p", W.SHARD_P)
@pytest.mark.parametrize("name", sorted(W.SHARD_CASES))
def test_shard_apply_matches_the_reference(ranks, devices, name, p):
    """Every route of the port's shard_apply (the s_block loop, the
    kernel's route, a DTensor operand, a replicated DTensor) against the
    reference's shard_apply on a mesh of the same p."""
    cw = W.SHARD_CASES[name][6]
    A = W.shard_operand(name)
    T = _ref_transform(name)
    fn = rsa.columnwise if cw else rsa.rowwise
    want = np.asarray(fn(T, A, rpar.make_mesh(devices=devices[:p])))
    limit = _limit(name, T, A, want)
    for route in ("", "/kernel_route", "/dtensor", "/replicated"):
        got = _value(ranks, f"{name}/p{p}{route}", p)
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= limit), (route, np.abs(
            got - want).max())


@pytest.mark.parametrize("dist", ["normal", "cauchy", "rademacher"])
@pytest.mark.parametrize("seq_axis", [0, 1])
def test_plain_partial_matches_the_interpreted_kernel(dist, seq_axis):
    """cuda_dense.fused_partial's plain version at block0 > 0 against
    pallas_dense.fused_partial in interpret mode on the matching slice of
    the block-key table (the reference's tests/test_base.py:258)."""
    from libskylark_tpu.base import randgen as rrg

    N, S, m, block0, nb = 512, 32, 8, 3, 2
    dists = {"normal": (randgen.Normal(), rrg.Normal()),
             "cauchy": (randgen.Cauchy(), rrg.Cauchy()),
             "rademacher": (randgen.Rademacher(), rrg.Rademacher())}
    pdist, rdist = dists[dist]
    T = rsk.JLT(256 * (block0 + nb), S, RContext(seed=21))
    keys = rpd._block_keys(T._alloc.key, 256 * (block0 + nb))
    A = W.normal((nb * 256, m) if seq_axis == 0 else (m, nb * 256), 9)
    want = np.asarray(rpd.fused_partial(keys[block0:], rdist, A, S,
                                        seq_axis=seq_axis, interpret=True))
    key = Context(seed=21).allocate().key
    got = cuda_dense.fused_partial(key, pdist, torch.from_numpy(A), S,
                                   seq_axis, block0).numpy()
    assert got.shape == want.shape
    if dist == "cauchy":
        Sv = np.abs(np.asarray(T.s_panel(256 * block0, 256 * (block0 + nb)),
                               np.float64)) / T.scale
        Aa = np.abs(A.astype(np.float64))
        limit = TOL * (Sv @ Aa if seq_axis == 0 else Aa @ Sv.T)
    else:
        limit = TOL * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit), np.abs(got - want).max()


@pytest.mark.parametrize("p", W.SHARD_P)
def test_emulated_ranks_sum_to_the_one_shot_apply(p):
    """p ranks emulated in one process: each rank's scaled partial at its
    own block0, summed in rank order, against the one-shot apply (both
    the package regime's plain versions) and the reference's apply."""
    N, S, m = 2048, 64, 16
    A = W.normal((N, m), 5)
    T = sk.JLT(N, S, Context(seed=17))
    bps = -(-N // (p * 256))
    total = sum(T.scale * cuda_dense.fused_partial(
        T._alloc.key, T.dist,
        torch.from_numpy(A[r * bps * 256:(r + 1) * bps * 256]), S, 0,
        r * bps) for r in range(p) if r * bps * 256 < N)
    one = T.apply(A, sk.COLUMNWISE, device="cpu").numpy()
    want = np.asarray(rsk.JLT(N, S, RContext(seed=17)).apply(
        A, rsk.COLUMNWISE))
    assert np.abs(total.numpy() - one).max() <= TOL * np.abs(one).max()
    assert np.abs(total.numpy() - want).max() <= TOL * np.abs(want).max()


def test_the_rejections(ranks):
    assert str(ranks[0]["reject/non_dense"]) == "UnsupportedError"
    assert str(ranks[0]["reject/length"]) == "SketchError"


def test_the_kernel_route_rule():
    """A CUDA shard takes the kernel whenever it serves the transform,
    and use_pallas=False there raises; a CPU shard takes it only when
    use_pallas asks; a transform the kernel does not serve takes the
    s_block loop on either device."""
    route = shard_apply._kernel_route
    with pytest.raises(errors.InvalidParametersError):
        route("cuda", False, True)
    assert route("cuda", None, True) and route("cuda", True, True)
    assert not route("cuda", None, False)
    assert not route("cpu", None, True) and route("cpu", True, True)
    assert not route("cpu", True, False) and not route("cpu", False, True)


def _ref_shard(arr, device):
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == device)


def test_mesh_helpers_place_as_the_reference(ranks, devices):
    """Each rank's local piece under every placement helper is the
    reference's shard on the device at the same mesh coordinate, and
    to_host gives the whole value back."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    for prefix, shape, n in (("mesh", (2,), 2), ("grid", (2, 2), 4)):
        mesh = rpar.make_mesh(shape, devices=devices[:n])
        for h in ("row_sharded", "col_sharded", "grid2d", "replicated"):
            arr = rpar.distribute(x, getattr(rpar, h)(mesh))
            for r in range(n):
                np.testing.assert_array_equal(
                    ranks[r][f"{prefix}/{h}/local"],
                    _ref_shard(arr, mesh.devices.flat[r]))
                np.testing.assert_array_equal(
                    ranks[r][f"{prefix}/{h}/host"], x)
    mesh = rpar.make_mesh((2,), devices=devices[:2])
    v = rpar.distribute(np.arange(8, dtype=np.float32),
                        rpar.vec_sharded(mesh))
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["mesh/vec_sharded/local"],
                                      _ref_shard(v, devices[r]))
    for r in range(4):
        assert tuple(ranks[r]["grid/coordinate"]) == divmod(r, 2)


def test_without_a_group_queries_and_meshes():
    """No process group: the host queries answer as one process, and a
    mesh cannot be built."""
    from libskylark_tpu_torch import parallel as par

    assert multihost.process_count() == 1
    assert multihost.process_index() == 0 and multihost.is_root()
    with pytest.raises(errors.CommunicationError):
        par.make_mesh()


def test_unreachable_coordinator_raises_within_the_timeout():
    """A worker with an explicit nonzero id probes the coordinator and
    raises CommunicationError with the address in its trace, within the
    timeout, never a raw RuntimeError."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    address = f"127.0.0.1:{port}"  # nothing listens once the socket closes
    t0 = time.monotonic()
    with pytest.raises(errors.CommunicationError) as info:
        multihost.initialize_distributed(address, 2, 1, connect_timeout=1.0)
    assert time.monotonic() - t0 < 5.0
    assert any(address in entry for entry in info.value.trace)
    with pytest.raises(errors.CommunicationError):
        multihost.initialize_distributed("no-port", 2, 1,
                                         connect_timeout=1.0)
