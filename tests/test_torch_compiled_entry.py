"""The solver entry points that run through the executable cache
(engine/compiled.py), on the CPU, where the executable is the body
itself: chip_smoke.py's compiled phase rehearsed entry by entry at a
small size (the compiled route torch.equal to the body called directly,
a second seed or input a hit equal to the body, the first result
unchanged, the entry point's Context counter the eager route's, one miss
per key), and the entry points the phase does not hold to the JAX
package held to it here, with the tolerances of tests/test_torch_nla.py
(solutions and factors relative ≤ 1e-4).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu_torch as P
from libskylark_tpu import sketch as jsk
from libskylark_tpu.algorithms import regression as jregression
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu_torch import algorithms, engine, sketch as sk
from libskylark_tpu_torch.base.context import Context

SIZE = {"svd_n": 256, "svd_r": 64, "rank": 8, "q": 2, "ls_rows": 1024,
        "ls_cols": 32, "ls_s": 128, "n": 600, "test": 100, "d": 40,
        "classes": 3, "latent": 4, "center": 1.0, "noise": 1.0, "s": 128,
        "exact_rows": 300, "poly_s": 64, "pinned_rows": 512, "reps": 2}
ENTRIES = ("svd", "symmetric_svd", "solve_jlt", "solve_cwt",
           "solve_fjlt_wht", "solve_ust", "solve_pinned",
           "precond_blendenpik", "precond_lsrn", "approximate_krr",
           "approximate_krr_poly", "kernel_ridge", "krr_predict")
REL = 1e-4


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def cases(chip_smoke):
    return chip_smoke.compiled_cases(torch, P, SIZE, "cpu")


@pytest.mark.parametrize("name", ENTRIES)
def test_compiled_entry_is_its_body(chip_smoke, cases, name):
    row = chip_smoke.compiled_entry(torch, P, name, cases[name], False,
                                    SIZE["reps"])
    assert row["pool_bytes"] == 0 and not row["replay_launches"]
    engine.reset()


def test_compiled_phase_covers_every_entry(chip_smoke):
    out = chip_smoke.compiled_phase(torch, P, np, size=SIZE, device="cpu")
    assert sorted(out["entries"]) == sorted(ENTRIES)
    assert set(chip_smoke.COMPILED_KERNELS) <= set(ENTRIES)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _ls(seed=8, m=1024, n=12):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = (A @ rng.standard_normal(n)
         + 0.1 * rng.standard_normal(m)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("family,kw", [("CWT", {}), ("FJLT", {"fut": "wht"}),
                                       ("FJLT", {}), ("UST", {})])
def test_solve_l2_sketched_matches_reference(family, kw):
    A, b = _ls()
    want = jregression.solve_l2_sketched(
        jnp.asarray(A), jnp.asarray(b),
        getattr(jsk, family)(1024, 256, JContext(4), **kw))
    engine.reset()
    T = getattr(sk, family)(1024, 256, Context(4), **kw)
    got = algorithms.solve_l2_sketched(A, b, T, device="cpu")
    again = algorithms.solve_l2_sketched(
        A, b, getattr(sk, family)(1024, 256, Context(5), **kw), device="cpu")
    assert engine.stats().misses == 1 and engine.stats().hits == 1
    assert not torch.equal(got, again)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("method", ["blendenpik", "lsrn"])
def test_precond_builds_match_reference(method):
    A, _ = _ls(9, 2048, 16)
    jp, p = jregression.AcceleratedParams(), algorithms.AcceleratedParams()
    build = {"blendenpik": (jregression.build_blendenpik_precond,
                            algorithms.build_blendenpik_precond),
             "lsrn": (jregression.build_lsrn_precond,
                      algorithms.build_lsrn_precond)}[method]
    _, want = build[0](jnp.asarray(A), JContext(6), jp)
    engine.reset()
    ctx = Context(6)
    _, got = build[1](A, ctx, p, device="cpu")
    assert ctx.counter == 1
    assert [e["name"] for e in engine.cache().snapshot()] == [
        "ls_accel_precond"]
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("method", ["blendenpik", "simplified_blendenpik",
                                    "lsrn"])
def test_accelerated_solves_match_reference(method):
    A, b = _ls(10, 2048, 16)
    want, _ = jregression.solve_l2_accelerated(
        jnp.asarray(A), jnp.asarray(b), JContext(7), method=method)
    got, iters = algorithms.solve_l2_accelerated(A, b, Context(7),
                                                 method=method, device="cpu")
    assert iters > 0
    assert _rel(got, want) <= REL


def _columnwise(A, T):
    return T.apply(A, sk.COLUMNWISE, device=A.device)


def _rowwise(A, T):
    return T.apply(A, sk.ROWWISE, device=A.device)


@pytest.mark.parametrize("make,body,dtype", [
    (lambda c: sk.JLT(256, 32, c), _columnwise, torch.float32),
    (lambda c: sk.JLT(256, 32, c), _columnwise, torch.float64),
    (lambda c: sk.CT(256, 32, c), _rowwise, torch.float64),
    (lambda c: sk.CWT(256, 32, c), _columnwise, torch.float32),
    (lambda c: sk.MMT(256, 32, c), _columnwise, torch.float32),
    (lambda c: sk.FJLT(256, 32, c), _columnwise, torch.float32),
    (lambda c: sk.FJLT(256, 32, c, fut="wht"), _columnwise, torch.float32),
    (lambda c: sk.GaussianRFT(256, 32, c, sigma=8.0), _rowwise,
     torch.float32),
    (lambda c: sk.GaussianRFT(256, 32, c, sigma=8.0), _rowwise,
     torch.float64),
    (lambda c: sk.LaplacianRFT(256, 32, c, sigma=8.0), _rowwise,
     torch.float32),
    (lambda c: sk.FastGaussianRFT(256, 32, c, sigma=8.0), _rowwise,
     torch.float32),
    (lambda c: sk.UST(256, 32, c), _columnwise, torch.float32),
    (lambda c: sk.UST(256, 32, c, replace=False), _rowwise, torch.float32),
    (lambda c: sk.PPT(256, 32, c, q=3, c=1.0, gamma=0.5), _rowwise,
     torch.float32),
    (lambda c: sk.WZT(256, 32, c, p=1.5), _columnwise, torch.float32),
    (lambda c: sk.MaternRFT(256, 32, c, nu=1.5, l=8.0), _rowwise,
     torch.float32),
    (lambda c: sk.FastMaternRFT(256, 32, c, nu=1.5, l=8.0), _rowwise,
     torch.float32),
    (lambda c: sk.JLT(256, 32, c).materialize(torch.float64, "cpu"),
     _columnwise, torch.float64),
    (lambda c: sk.GaussianRFT(256, 32, c, sigma=8.0).materialize(
        torch.float64, "cpu"), _rowwise, torch.float64),
])
def test_seed_binding_hoists_every_per_seed_value(make, body, dtype):
    """A body run under a SeedBinding whose slots were refilled from a
    second transform gives that transform's result, not the first's: no
    per-seed value of the routes a capture takes stays baked in (a
    captured graph replays exactly what the binding serves)."""
    from libskylark_tpu_torch.sketch.transform import SeedBinding

    A = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, 256))).to(dtype)
    T1, T2 = make(Context(11)), make(Context(12))
    binding = SeedBinding((A, T1), "cpu")
    with binding.active():
        first = body(A, T1)
    assert binding.slots
    with binding.active(replay=True):
        assert torch.equal(body(A, T1), first)
    binding.refill((A, T2))
    with binding.active(replay=True):
        second = body(A, T1)
    assert torch.equal(second, body(A, T2))
    assert not torch.equal(second, first)


def test_seed_binding_hoists_the_quasi_random_operator():
    """QRFT's W and shifts are seed-free host arrays: under a binding they
    too are made outside the body (no host-to-device copy inside a
    capture), and a replay serves them unchanged."""
    from libskylark_tpu_torch.sketch.transform import SeedBinding

    A = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 256))).float()
    T = sk.GaussianQRFT(256, 32, Context(11), sigma=8.0)
    binding = SeedBinding((A, T), "cpu")
    with binding.active():
        first = _rowwise(A, T)
    assert len(binding.slots) >= 2
    with binding.active(replay=True):
        assert torch.equal(_rowwise(A, T), first)
    assert torch.equal(first, _rowwise(A, T))
