"""MaternRFT, FastMaternRFT and the Matern kernel of the port against the
JAX package, on the CPU.

Both packages draw the same transform from the same Context seed. A
feature column whose scale came from a flipped Gamma sample (see
test_torch_gamma.py) is unrelated between the packages, its scale more
than 1e-2 relative from the reference's: such columns are excluded from
the comparison and counted (at most one here). Every other scale agrees
within 1e-5 relative. Bounds on the features of those columns, relative
to max|features|:
- MaternRFT in the "f32" regime (the reference's CPU arithmetic) within
  1e-5, in the default "bf16x3" within 1e-4 (ROADMAP C9); FastMaternRFT
  within 1e-5 (no B1 regime: the torch chain);
- the scales √(2ν/χ²(2ν)) are heavy-tailed (t frequencies with 2ν
  degrees of freedom) and multiply the phase, so each entry is held
  within that bound times max|features| plus its phase's limit times
  cos's Lipschitz factor: outscale · sc_j · bound · (the sum of the
  magnitudes of the phase's terms) — ROADMAP C5's rule;
- a reference HilbertModel on a Matern kernel, carried across: its
  decision values within 1e-5 · max in "f32", 1e-4 in "bf16x3".
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu import sketch as jsk
from libskylark_tpu.algorithms import prox as jprox
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import engine, interop, ml, sketch as sk
from libskylark_tpu_torch.algorithms import prox
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import cuda_fastfood, frft
from libskylark_tpu_torch.sketch import params as sketch_params

N, S, M = 40, 256, 60
GAMMA_REL = 1e-5
FLIP_REL = 1e-2
TOL = {"f32": 1e-5, "bf16x3": 1e-4}


@pytest.fixture(params=sorted(TOL))
def regime(request):
    before = sketch_params.get_pallas_precision()
    sketch_params.set_pallas_precision(request.param)
    yield request.param
    sketch_params.set_pallas_precision(before)


def _X(m=M, n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _unflipped(got, want):
    """Columns whose scale is not a flip (within 1e-2 relative), and the
    count of the flips; the unflipped scales must agree within 1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.abs(want)
    ok = rel <= FLIP_REL
    assert (rel[ok] <= GAMMA_REL).all(), rel[ok].max()
    return ok, int((~ok).sum())


def _held(got, want, keep, limit):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return bool((d[:, keep] <= limit[:, keep]).all())


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_rft_matches_reference(nu, regime):
    X = _X()
    jT = jsk.MaternRFT(N, S, JContext(5), nu=nu, l=3.0)
    T = sk.MaternRFT(N, S, Context(5), nu=nu, l=3.0)
    want = np.asarray(jT.apply(jnp.asarray(X), jsk.ROWWISE))
    got = T.apply(torch.from_numpy(X), sk.ROWWISE, device="cpu").numpy()
    sc = T.row_scales().numpy()
    keep, flipped = _unflipped(sc, np.asarray(jT.row_scales()))
    assert flipped <= 1
    W = np.abs(T.w_panel(0, N).numpy().astype(np.float64))
    limit = TOL[regime] * (np.abs(want).max() + T.outscale * sc[None, :]
                           * (np.abs(X.astype(np.float64)) @ W.T))
    assert _held(got, want, keep, limit)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_fast_matern_rft_matches_reference(nu):
    X = _X()
    jT = jsk.FastMaternRFT(N, S, JContext(6), nu=nu, l=3.0)
    T = sk.FastMaternRFT(N, S, Context(6), nu=nu, l=3.0)
    want = np.asarray(jT.apply(jnp.asarray(X), jsk.ROWWISE))
    got = T.apply(torch.from_numpy(X), sk.ROWWISE, device="cpu").numpy()
    sm = T._Sm(torch.float32).numpy()
    keep, flipped = _unflipped(sm, np.asarray(jT._Sm(jnp.float32)))
    assert flipped <= 1
    keep = keep[:S]
    # the phase's terms: the last WHT's ±scal·G_k·W_π(k), W = H(B ⊙ x),
    # times scal·Sm_j
    bdiag, perms, gdiag, smdiag, _ = cuda_fastfood.kernel_streams(T)
    nb, NB = bdiag.shape
    Xp = torch.nn.functional.pad(torch.from_numpy(X), (0, NB - N))
    W = frft.fut_apply_policy(T._fut, "wht",
                              bdiag[:, None, :] * Xp[None]).abs()
    W = torch.gather(W, 2, perms[:, None, :].expand(nb, M, NB))
    R = (W.double() * gdiag.double().abs()[:, None, :]).sum(2)
    terms = (R[:, :, None] * smdiag.double().abs()[:, None, :]).permute(
        1, 0, 2).reshape(M, nb * NB)[:, :S].numpy()
    limit = 1e-5 * (np.abs(want).max() + T.scale * terms)
    assert _held(got, want, keep, limit)


@pytest.mark.parametrize("nu", [0.5, 2.5])
def test_matern_serve_streams_are_the_transform_streams(nu):
    T = sk.FastMaternRFT(N, S, Context(7), nu=nu, l=2.0)
    kind, param = T._sm_spec()
    assert kind == "matern" and param == (nu, 2.0)
    streams = frft.serve_streams(T.allocation.key, torch.float32, NB=T._NB,
                                 nb=T._numblks, s_dim=S, sm_kind=kind,
                                 sm_param=param, device="cpu")
    assert torch.equal(streams[2][0], T._Sm(torch.float32))
    # and the reference's serve streams
    import jax

    jkey = jax.random.wrap_key_data(jnp.asarray(T.allocation.key))
    want = np.asarray(jsk.frft.serve_streams(
        jkey, jnp.float32, NB=T._NB, nb=T._numblks, s_dim=S, sm_kind=kind,
        sm_param=param)[2])
    _, flipped = _unflipped(streams[2][0].numpy(), want)
    assert flipped <= 1


def test_fast_matern_serves_through_the_executor():
    T = sk.FastMaternRFT(N, S, Context(8), nu=1.5, l=3.0)
    X = torch.from_numpy(_X(37))
    ex = engine.MicrobatchExecutor(max_batch=4, linger_us=1000,
                                   device="cpu")
    try:
        fut = ex.submit_fastfood(T, X)
        ex.flush()
        got = fut.result(timeout=60)
    finally:
        ex.shutdown()
    want = T.apply(X, sk.ROWWISE, device="cpu")
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("tag", ["regular", "fast"])
def test_matern_kernel_maps_carry_across(tag):
    jk = jml.Matern(N, nu=1.5, l=2.5)
    k = interop.kernel_from_reference(jk.to_json())
    T = k.create_rft(S, Context(9), tag)
    jT = jk.create_rft(S, JContext(9), tag)
    got = interop.transform_from_reference(jT.to_json())
    assert type(got) is type(T) and got.to_dict() == T.to_dict()


def test_approximate_kernel_rlsc_accepts_matern():
    X = _X(120)
    y = (X[:, 0] > 0).astype(np.int64)
    jk, k = jml.Matern(N, nu=2.5, l=4.0), ml.Matern(N, nu=2.5, l=4.0)
    before = sketch_params.get_pallas_precision()
    sketch_params.set_pallas_precision("f32")
    try:
        jS, jW, _ = jml.approximate_kernel_rlsc(jk, jnp.asarray(X), y, 1.0,
                                                128, JContext(10))
        S_, W, _ = ml.approximate_kernel_rlsc(k, X, y, 1.0, 128,
                                              Context(10), device="cpu")
    finally:
        sketch_params.set_pallas_precision(before)
    assert S_.to_dict()["sketch_type"] == "MaternRFT"
    want = np.asarray(jW)
    assert np.abs(W.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("nu", [1.5, 2.5])
def test_matern_hilbert_model_carries_across(nu, regime, tmp_path):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((200, 12)).astype(np.float32)
    labels = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    solver = jml.BlockADMMSolver.from_kernel(
        JContext(11), jprox.HingeLoss(), jprox.L2Regularizer(), 0.01, 128,
        jml.Matern(12, nu=nu, l=3.0), num_partitions=2)
    solver.maxiter = 2
    want = solver.train(X, labels)
    path = os.path.join(tmp_path, "model.json")
    want.save(path, header="a Matern model")
    got = interop.hilbert_model_from_reference(path, device="cpu")
    assert [m.to_dict()["sketch_type"] for m in got.maps] == ["MaternRFT"] * 2
    wl, wdv = want.predict(X)
    gl, gdv = got.predict(torch.from_numpy(X))
    wdv = np.asarray(wdv)
    assert np.abs(gdv.numpy() - wdv).max() <= TOL[regime] * np.abs(wdv).max()
    assert np.array_equal(gl.numpy(), np.asarray(wl))
