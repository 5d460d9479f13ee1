"""The port's prox operators and BlockADMMSolver against the JAX package,
on the CPU.

Both packages get the same float32 data (numpy, seeded: 240 rows of 12
features in 3 planted classes, and a regression target) and the same
Context seed, so they draw the same feature maps. Bounds:
- each loss's and regularizer's ``prox`` bit-equal to the reference's
  where its arithmetic is exact (one rounding per entry: LAD, hinge, L1,
  empty), within 1e-6 relative elsewhere (squared, L2: a division by
  1 + λ), LogisticLoss's 30 Newton steps within 1e-5; ``evaluate``
  (a sum in another order) within 1e-6 relative;
- ``BlockADMMSolver`` after 5 iterations: ``coef`` within the reference's
  own ``rtol = 1e-4, atol = 1e-5`` (its
  ``test_cache_transforms_same_result``).
The models it trains are carried across in ``test_torch_ml_model.py``.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu.algorithms import prox as jprox
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import ml
from libskylark_tpu_torch.algorithms import prox
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.telemetry import metrics as telemetry_metrics
from libskylark_tpu_torch.utility import timer

N, D, CLASSES = 240, 12, 3
ITERS = 5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((CLASSES, D))
    labels = rng.integers(0, CLASSES, N)
    X = (centers[labels] + rng.standard_normal((N, D))).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.3 * X[:, 1]).astype(np.float32)
    return X, labels, y


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- losses and regularizers --

LOSSES = ["squared", "lad", "hinge", "logistic"]
EXACT_PROX = {"lad", "hinge", "l1", "none"}
PROX_TOL = {"squared": 1e-6, "l2": 1e-6, "logistic": 1e-5}


def _loss_operands(name, k, seed=1):
    rng = np.random.default_rng(seed)
    X = (2.0 * rng.standard_normal((k, 64))).astype(np.float32)
    if name in ("squared", "lad") and k == 1:
        T = rng.standard_normal(64).astype(np.float32)
    elif k == 1:
        T = rng.choice([-1.0, 1.0], 64).astype(np.float32)
    else:
        T = rng.integers(0, k, 64).astype(np.int32)
    return X, T


# the logistic loss is multiclass: k ≥ 2 labels only
@pytest.mark.parametrize("name,k", [(name, k) for name in LOSSES
                                    for k in (1, 3)
                                    if (name, k) != ("logistic", 1)])
@pytest.mark.parametrize("lam", [0.3, 2.0])
def test_loss_matches_reference(name, k, lam):
    X, T = _loss_operands(name, k)
    jl, pl = jprox.LOSSES[name](), prox.LOSSES[name]()
    want = jl.prox(jnp.asarray(X), lam, jnp.asarray(T))
    got = pl.prox(torch.from_numpy(X), lam, torch.from_numpy(T))
    if name in EXACT_PROX:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert _rel(got, want) <= PROX_TOL[name]
    assert _rel(pl.evaluate(torch.from_numpy(X), torch.from_numpy(T)),
                jl.evaluate(jnp.asarray(X), jnp.asarray(T))) <= 1e-6


@pytest.mark.parametrize("name", ["none", "l2", "l1"])
@pytest.mark.parametrize("lam", [0.05, 1.5])
def test_regularizer_matches_reference(name, lam):
    rng = np.random.default_rng(2)
    W = rng.standard_normal((40, 3)).astype(np.float32)
    mu = (0.5 * rng.standard_normal((40, 3))).astype(np.float32)
    jr, pr = jprox.REGULARIZERS[name](), prox.REGULARIZERS[name]()
    want = jr.prox(jnp.asarray(W), lam, jnp.asarray(mu))
    got = pr.prox(torch.from_numpy(W), lam, torch.from_numpy(mu))
    if name in EXACT_PROX:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert _rel(got, want) <= PROX_TOL[name]
    we = float(jr.evaluate(jnp.asarray(W)))
    ge = float(pr.evaluate(torch.from_numpy(W)))
    assert abs(ge - we) <= 1e-6 * max(abs(we), 1e-30)


def test_logistic_prox_newton_count():
    X, T = _loss_operands("logistic", 4, seed=3)
    for iters in (1, 7):
        want = jprox.LogisticLoss(iters).prox(jnp.asarray(X), 0.5,
                                              jnp.asarray(T))
        got = prox.LogisticLoss(iters).prox(torch.from_numpy(X), 0.5,
                                            torch.from_numpy(T))
        assert _rel(got, want) <= 1e-5


# -- BlockADMMSolver --

def _solver(pkg, ctx, case):
    """(solver, train kwargs) of one case for ``pkg`` (the reference's or
    the port's modules)."""
    mlm, pm, C = pkg
    loss, reg, lam, feats, parts, kind = case
    if kind == "linear":
        s = mlm.BlockADMMSolver(pm.LOSSES[loss](), pm.REGULARIZERS[reg](),
                                lam, D, parts)
    else:
        s = mlm.BlockADMMSolver.from_kernel(
            C(ctx), pm.LOSSES[loss](), pm.REGULARIZERS[reg](), lam, feats,
            mlm.Gaussian(D, 3.0), num_partitions=parts)
    s.maxiter, s.tol = ITERS, 0.0
    s.cache_transforms = kind == "cached"
    return s


# (loss, regularizer, λ, features, partitions, kind): bench_admm's
# hinge/L2 at 4 partitions, its cache_transforms twin, and each other
# loss and regularizer once; "linear" blocks are column slices of X
CASES = {
    "hinge_l2": ("hinge", "l2", 0.01, 128, 4, "kernel"),
    "hinge_l2_cached": ("hinge", "l2", 0.01, 128, 4, "cached"),
    "squared_l1_regression": ("squared", "l1", 0.05, 96, 2, "kernel"),
    "logistic_l2": ("logistic", "l2", 0.01, 96, 3, "kernel"),
    "lad_none_linear_regression": ("lad", "none", 0.1, D, 3, "linear"),
}
REFERENCE = (jml, jprox, JContext)
PORT = (ml, prox, Context)


def _train(pkg, name, iters=ITERS, **kw):
    X, labels, y = _data()
    s = _solver(pkg, 31, CASES[name])
    s.maxiter = iters
    regression = "regression" in name
    target = y if regression else labels
    if pkg is PORT:
        kw["device"] = "cpu"
    return s.train(X, target, regression=regression, **kw)


@pytest.fixture(scope="module")
def reference_models():
    return {name: _train(REFERENCE, name) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_admm_matches_reference(reference_models, name):
    want = reference_models[name]
    got = _train(PORT, name)
    assert got.num_outputs == want.num_outputs
    assert got.coef.device == torch.device("cpu")
    np.testing.assert_allclose(_np(got.coef), _np(want.coef),
                               rtol=1e-4, atol=1e-5)
    assert [m.to_dict() for m in got.maps] == [
        {**m.to_dict(), "skylark_version": mp.to_dict()["skylark_version"]}
        for m, mp in zip(want.maps, got.maps)]


def test_cache_transforms_same_result(reference_models):
    got = _train(PORT, "hinge_l2_cached")
    plain = _train(PORT, "hinge_l2")
    np.testing.assert_allclose(_np(got.coef), _np(plain.coef),
                               rtol=1e-4, atol=1e-5)


def test_verbose_objective_and_tolerance_match_reference():
    """The objective and validation accuracy printed per iteration, and
    tol's early stop (reldel read on the host only when tol > 0)."""
    X, labels, _ = _data()
    Xv, lv, _ = _data(seed=5)
    runs = []
    for pkg in (REFERENCE, PORT):
        s = _solver(pkg, 32, CASES["hinge_l2"])
        s.maxiter, s.tol = 60, 1e-2
        out = io.StringIO()
        kw = {"device": "cpu"} if pkg is PORT else {}
        with contextlib.redirect_stdout(out):
            s.train(X, labels, Xv=Xv, Yv=lv, verbose=True, **kw)
        runs.append([ln.split() for ln in out.getvalue().splitlines()])
    want, got = runs
    assert 1 < len(got) == len(want) < 60
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[4] == w[4] == "accuracy"
        assert abs(float(g[3]) - float(w[3])) <= 1e-4 * abs(float(w[3]))
        assert abs(float(g[5]) - float(w[5])) <= 100.0 / len(lv)


def test_train_refuses_what_is_not_ported(tmp_path):
    X, labels, _ = _data()
    s = _solver(PORT, 33, CASES["hinge_l2"])
    with pytest.raises(NotImplementedError, match="A7"):
        s.train(X, labels, checkpoint=str(tmp_path), device="cpu")
    with pytest.raises(errors.NotImplementedYetError, match="A7"):
        s.train(X, labels, checkpoint=str(tmp_path), device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        s.train(X, labels - 1, device="cpu")
    with pytest.raises(errors.InvalidParametersError):
        ml.BlockADMMSolver(prox.HingeLoss(), prox.L2Regularizer(), 0.1, 10,
                           feature_maps=s.feature_maps)


def test_telemetry_and_timers_when_enabled(monkeypatch):
    X, labels, _ = _data()
    counter = telemetry_metrics.counter("ml.admm.iterations")
    gauge = telemetry_metrics.gauge("ml.admm.objective")
    s = _solver(PORT, 34, CASES["hinge_l2"])
    s.maxiter = 3
    before = counter.value() or 0
    s.train(X, labels, device="cpu")
    assert (counter.value() or 0) == before  # off by default
    monkeypatch.setattr(telemetry_metrics, "_ENABLED", True)
    monkeypatch.setattr(timer, "_ENABLED", True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        s.train(X, labels, device="cpu")
    assert counter.value() == before + 3
    assert np.isfinite(gauge.value())
    report = out.getvalue()
    assert "== phase timings [admm] ==" in report
    for phase in ("ITERATIONS", "TRANSFORM", "FACTORIZATION"):
        assert phase in report


def test_partition_matches_reference():
    for nf, parts in ((128, 4), (10, 3), (7, 7), (5, 1)):
        assert ml.admm._partition(nf, parts) == jml.admm._partition(nf, parts)
