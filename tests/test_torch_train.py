"""Training jobs of the port (libskylark_tpu_torch/train/) against the
JAX package's train/ on the CPU.

- the state codec and the operand sidecar are the reference's bytes,
  both ways;
- each slice engine after k = 5 iterations against the reference engine
  on the same numpy operands (LSQR and CG within 1e-4 relative, ADMM-KRR
  within 1e-4, randomized Gauss–Seidel's block order bit-equal and its
  values within 1e-4), with equal iteration counts;
- sliced = straight and replay, ``torch.equal`` (the arrays' bytes);
- a resume after the registry is abandoned without a close equals the
  uninterrupted run;
- the executor: a job's result equals the direct run; budget exhaustion
  at the exact iterations; interactive traffic preempts slices; a
  DEGRADED executor sheds submits; the retry budget; TTL pinning;
- the env knobs and the metric names.
"""

from __future__ import annotations

import os
import time
import zipfile

import numpy as np
import pytest
import torch

from libskylark_tpu.sessions.registry import SessionRegistry as RRegistry
from libskylark_tpu.train import slices as rslices
from libskylark_tpu.train import state as rtstate
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.engine.serve import (MicrobatchExecutor,
                                               ServeOverloadedError,
                                               serve_stats)
from libskylark_tpu_torch.sessions.registry import SessionRegistry
from libskylark_tpu_torch.sessions.state import SessionSpec
from libskylark_tpu_torch.train import (TrainJobSpec, decode_state,
                                        encode_state, make_engine,
                                        step_bytes, train_stats)
from libskylark_tpu_torch.train import state as tstate


@pytest.fixture()
def sdir(tmp_path, monkeypatch):
    d = str(tmp_path / "sessions")
    monkeypatch.setenv("SKYLARK_SESSION_DIR", d)
    return d


def _lsqr_ops(seed=0, m=96, n=12, t=2):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    return {"A": A, "B": (A @ rng.standard_normal((n, t))
                          + 0.1 * rng.standard_normal((m, t))
                          ).astype(np.float32)}


def _cg_ops(seed=0, n=16):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((48, n))
    M = (A.T @ A + n * np.eye(n)).astype(np.float32)
    return {"A": M, "B": rng.standard_normal((n, 2)).astype(np.float32)}


def _krr_ops(seed=0, m=64, d=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, d)).astype(np.float32)
    Y = (X[:, 0] > 0).astype(np.float32) + (X[:, 1] > 0)
    return {"X": X, "Y": Y}


_ENGINES = [
    ("lsqr", {"tolerance": 1e-7}, _lsqr_ops),
    ("lsqr", {"tolerance": 1e-7, "precond": "blendenpik", "seed": 5},
     _lsqr_ops),
    ("cg", {"tolerance": 1e-7}, _cg_ops),
    ("rand_gs", {"block_size": 4, "seed": 2, "tolerance": 1e-9}, _cg_ops),
    ("admm_krr", {"num_features": 32, "num_partitions": 2, "lam": 1e-2,
                  "sigma": 2.0, "regression": False, "num_targets": 3,
                  "seed": 3}, _krr_ops),
]
_IDS = ["lsqr", "lsqr-blendenpik", "cg", "rand_gs", "admm_krr"]


def _engine(solver, hyper, ops):
    return make_engine(solver, hyper, ops, device="cpu")


def _equal_states(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        torch.equal(torch.from_numpy(np.array(a[k])),
                    torch.from_numpy(np.array(b[k]))) for k in a)


# -- the codec ----------------------------------------------------------


def test_codec_is_the_reference_bytes_both_ways():
    eng = _engine("lsqr", {}, _lsqr_ops())
    state = eng.step(eng.init(), 3)
    b = encode_state(state)
    assert b == rslices.encode_state(state)
    back = rslices.decode_state(b)
    assert set(back) == set(state)
    for k in state:
        assert back[k].shape == state[k].shape
        assert back[k].dtype == state[k].dtype
        np.testing.assert_array_equal(back[k], state[k])
    # a 0-d counter stays 0-d through either package
    s0 = {"it": np.int32(4), "X": np.arange(6.0).reshape(2, 3).T,
          "done": np.array([True, False])}
    rb = rslices.encode_state(s0)
    assert encode_state(s0) == rb
    out = decode_state(rb)
    assert out["it"].shape == () and out["it"].dtype == np.int32
    np.testing.assert_array_equal(out["X"], s0["X"])
    assert encode_state(out) == rb


def test_unknown_solver_refuses():
    with pytest.raises(errors.InvalidParametersError):
        _engine("sgd", {}, _lsqr_ops())
    with pytest.raises(errors.InvalidParametersError, match="operands"):
        _engine("lsqr", {}, {"X": np.zeros((2, 2))})


# -- engines against the reference ---------------------------------------


@pytest.mark.parametrize("solver,hyper,ops", _ENGINES, ids=_IDS)
def test_engine_matches_the_reference(solver, hyper, ops):
    operands = ops()
    ref = rslices.make_engine(solver, hyper, operands)
    eng = _engine(solver, hyper, operands)
    r0, p0 = ref.init(), eng.init()
    assert set(p0) == set(r0)
    for k in r0:
        assert p0[k].shape == np.asarray(r0[k]).shape, k
        assert p0[k].dtype == np.asarray(r0[k]).dtype, k
    r5, p5 = ref.step(r0, 5), eng.step(p0, 5)
    assert eng.info(p5)["iterations"] == ref.info(r5)["iterations"] == 5
    for k in r5:
        want = np.asarray(r5[k])
        if want.dtype.kind != "f" or k in ("reldel", "objective", "res"):
            continue
        scale = max(float(np.max(np.abs(want))), 1e-30)
        err = float(np.max(np.abs(p5[k] - want))) / scale
        assert err <= 1e-4, (k, err)
    np.testing.assert_allclose(eng.info(p5)["residual"],
                               ref.info(r5)["residual"], rtol=1e-4)
    got, want = eng.result(p5), ref.result(r5)
    key = "coef" if solver == "admm_krr" else "X"
    assert isinstance(got[key], torch.Tensor)
    assert got[key].device == torch.device("cpu")
    w = np.asarray(want[key])
    assert float(np.max(np.abs(got[key].numpy() - w))) <= \
        1e-4 * float(np.max(np.abs(w)))


def test_rand_gs_block_order_is_the_reference():
    import jax
    import jax.random as jr

    from libskylark_tpu.base.context import Context as RContext
    from libskylark_tpu_torch.base.context import Context, fold_in

    eng = _engine("rand_gs", {"block_size": 4, "seed": 2}, _cg_ops())
    key = Context(seed=2).allocate().key
    rkey = RContext(seed=2).allocate().key
    for i in range(5):
        want = np.asarray(jr.permutation(jr.fold_in(rkey, i),
                                         eng._sys.nblocks))
        got = eng._sys.order(fold_in(key, i)).numpy()
        np.testing.assert_array_equal(got, want)
    del jax


# -- determinism ---------------------------------------------------------


@pytest.mark.parametrize("solver,hyper,ops", _ENGINES, ids=_IDS)
def test_sliced_equals_straight_and_replay(solver, hyper, ops):
    eng = _engine(solver, hyper, ops())
    s0 = eng.init()
    straight = eng.step(s0, 6)
    sliced = eng.step(eng.step(eng.step(s0, 2), 1), 3)
    assert _equal_states(sliced, straight)
    b0 = encode_state(s0)
    assert step_bytes(eng, b0, 4) == step_bytes(eng, b0, 4)
    # a fresh engine over the same operands: no per-instance salt
    assert encode_state(_engine(solver, hyper, ops()).step(s0, 6)) == \
        encode_state(straight)


# -- sessions: resume, sidecar, budget -----------------------------------


def _open_train(reg, sid, spec, ops):
    tstate.save_operands(reg.directory, sid, ops, {})
    reg.open(SessionSpec(kind="train", n=spec.budget_iters, s_dim=1,
                         d=1, extra=spec.to_dict()), session_id=sid)


@pytest.mark.parametrize("solver,hyper,ops", [_ENGINES[0], _ENGINES[4]],
                         ids=["lsqr", "admm_krr"])
def test_resume_of_an_abandoned_registry_equals_the_straight_run(
        solver, hyper, ops, sdir):
    operands = ops()
    spec = TrainJobSpec(solver=solver, hyper=hyper, budget_iters=16)
    sid = f"train-{solver}"
    reg = SessionRegistry(directory=sdir, device="cpu")
    _open_train(reg, sid, spec, operands)
    for i in range(3):
        reg.append(sid, np.asarray([[2]], np.int64), seq=i + 1)
    reg.checkpoint(sid)
    reg.append(sid, np.asarray([[2]], np.int64), seq=4)
    # abandoned without a close; a peer adopts the session from disk
    peer = SessionRegistry(directory=sdir, device="cpu")
    desc = peer.describe(sid)
    assert desc["seq"] == 4 and desc["rows"] == 8
    peer.append(sid, np.asarray([[3]], np.int64), seq=5)
    got = peer.finalize(sid)
    eng = _engine(solver, hyper, operands)
    want = eng.result(eng.step(eng.init(), 11))
    key = "coef" if solver == "admm_krr" else "X"
    assert torch.equal(got[key], want[key])
    assert got["iterations"] == want["iterations"] and got["rows"] == 11
    with pytest.raises(errors.SessionEvictedError):
        reg.append(sid, np.asarray([[2]], np.int64), seq=5)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_operand_sidecar_is_the_reference_bytes(tmp_path):
    ops = _lsqr_ops()
    digests = {"A": "a" * 8, "B": "b" * 8}
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    tstate.save_operands(str(tmp_path / "p"), "j", {
        "A": torch.from_numpy(ops["A"]), "B": ops["B"]}, digests)
    rtstate.save_operands(str(tmp_path / "r"), "j", ops, digests)
    base = "j" + tstate.OPERANDS_SUFFIX
    assert _members(tmp_path / "p" / (base + ".npz")) == \
        _members(tmp_path / "r" / (base + ".npz"))
    assert (tmp_path / "p" / (base + ".json")).read_bytes() == \
        (tmp_path / "r" / (base + ".json")).read_bytes()
    got = rtstate.load_operands(str(tmp_path / "p"), "j")
    np.testing.assert_array_equal(got["A"], ops["A"])
    tstate.remove_operands(str(tmp_path / "p"), "j")
    assert not os.listdir(tmp_path / "p")


def test_a_reference_train_session_resumes_in_the_port(sdir):
    """The reference opens and journals a job; the port adopts it from
    the same directory and continues to the straight run's bytes."""
    operands = _lsqr_ops(seed=4)
    hyper = {"tolerance": 1e-7}
    spec = TrainJobSpec(solver="lsqr", hyper=hyper, budget_iters=16)
    rreg = RRegistry(directory=sdir)
    rtstate.save_operands(sdir, "xj", operands, {})
    from libskylark_tpu.sessions.state import SessionSpec as RSpec

    rreg.open(RSpec(kind="train", n=16, s_dim=1, d=1,
                    extra=spec.to_dict()), session_id="xj")
    rreg.append("xj", np.asarray([[2]], np.int64), seq=1)
    rreg.checkpoint("xj")
    rreg.append("xj", np.asarray([[1]], np.int64), seq=2)
    peer = SessionRegistry(directory=sdir, device="cpu")
    assert peer.describe("xj")["rows"] == 3
    ref = rslices.make_engine("lsqr", hyper, operands)
    want = ref.step(ref.init(), 3)
    got = peer._resolve("xj").state.arrays()
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        if w.dtype.kind == "f":
            assert float(np.max(np.abs(got[k] - w))) <= \
                1e-4 * max(float(np.max(np.abs(w))), 1e-30)


def test_operand_sidecar_required_and_budget_refused(sdir):
    spec = TrainJobSpec(solver="lsqr", budget_iters=4)
    reg = SessionRegistry(directory=sdir, device="cpu")
    with pytest.raises(errors.SessionEvictedError, match="operand sidecar"):
        reg.open(SessionSpec(kind="train", n=4, s_dim=1, d=1,
                             extra=spec.to_dict()), session_id="no-ops")
    _open_train(reg, "edge", spec, _lsqr_ops())
    reg.append("edge", np.asarray([[3]], np.int64), seq=1)
    with pytest.raises(errors.InvalidParametersError, match="budget"):
        reg.append("edge", np.asarray([[2]], np.int64), seq=2)
    assert reg.describe("edge")["rows"] == 3
    path = tstate.operands_path(sdir, "edge") + ".npz"
    assert os.path.exists(path)
    reg.evict("edge", reason="test")
    assert not os.path.exists(path)


def test_a_pinned_train_session_survives_its_ttl(sdir, monkeypatch):
    from libskylark_tpu_torch.sessions import registry as reg_mod

    spec = TrainJobSpec(solver="lsqr", budget_iters=16)
    reg = SessionRegistry(directory=sdir, device="cpu")
    tstate.save_operands(sdir, "pinned", _lsqr_ops(), {})
    reg.open(SessionSpec(kind="train", n=16, s_dim=1, d=1, ttl_s=10.0,
                         extra=spec.to_dict()), session_id="pinned")
    reg.pin("pinned")
    reg.pin("pinned")
    t0 = time.monotonic()
    monkeypatch.setattr(reg_mod.time, "monotonic", lambda: t0 + 3600.0)
    assert reg.describe("pinned")["pins"] == 2
    reg.append("pinned", np.asarray([[2]], np.int64), seq=1)
    for _ in range(3):           # an extra unpin stays at zero
        reg.unpin("pinned")
    assert reg.describe("pinned")["pins"] == 0
    monkeypatch.setattr(reg_mod.time, "monotonic", lambda: t0 + 7200.0)
    with pytest.raises(errors.SessionEvictedError):
        reg.append("pinned", np.asarray([[2]], np.int64), seq=2)


# -- the executor ----------------------------------------------------------


def _direct(solver, hyper, ops, k):
    eng = _engine(solver, hyper, ops)
    st = eng.init()
    while not eng.info(st)["converged"]:
        st = eng.step(st, k)
    return eng.result(st)


def test_a_job_equals_the_direct_run(sdir):
    ops = _lsqr_ops(seed=7)
    with MicrobatchExecutor(name="t-job", device="cpu") as ex:
        h = ex.submit_train_job(
            TrainJobSpec(solver="lsqr", hyper={"tolerance": 1e-6},
                         budget_iters=64, slice_iters=4,
                         checkpoint_every=2), operands=ops)
        out = h.result(timeout=120)
        s = ex.stats()["train"]
        assert serve_stats()["train"]["jobs_submitted"] >= 1
    assert out["converged"]
    want = _direct("lsqr", {"tolerance": 1e-6}, ops, 4)
    assert torch.equal(out["X"], want["X"])
    assert out["X"].device == torch.device("cpu")
    assert s["jobs_submitted"] == 1 and s["completed"] == 1
    assert s["slices_run"] == -(-want["iterations"] // 4)
    assert train_stats()["jobs_submitted"] >= 1
    with pytest.raises(errors.SessionEvictedError):
        ex.train_job_status(h.job_id)


def test_budget_exhaustion_reports_exact_iterations(sdir):
    with MicrobatchExecutor(name="t-budget", device="cpu") as ex:
        h = ex.submit_train_job(
            TrainJobSpec(solver="lsqr", budget_iters=5, slice_iters=2,
                         hyper={"tolerance": 1e-30}),
            operands=_lsqr_ops())
        with pytest.raises(errors.TrainBudgetExhaustedError) as ei:
            h.result(timeout=120)
        s = ex.stats()["train"]
    assert ei.value.iterations == 5 and ei.value.slices == 3
    assert ei.value.residual is not None
    assert s["budget_exhausted"] == 1 and s["slices_run"] == 3


def test_interactive_traffic_preempts_slices(sdir):
    """An interactive request pending in its bucket displaces the job:
    the flusher defers its slices (``preemptions``), serves the request,
    then runs the job, whose result still equals the direct run."""
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.base.context import Context

    ops = _lsqr_ops(seed=11)
    rng = np.random.default_rng(0)
    T = sk.JLT(16, 4, Context(seed=1))
    with MicrobatchExecutor(name="t-preempt", device="cpu",
                            linger_us=2_000_000) as ex:
        f = ex.submit_sketch(T, rng.standard_normal((16, 6)).astype(
            np.float32), qos_class="interactive")
        h = ex.submit_train_job(
            TrainJobSpec(solver="lsqr", budget_iters=64, slice_iters=2,
                         hyper={"tolerance": 1e-6}), operands=ops)
        f.result(timeout=30)
        out = h.result(timeout=120)
        s = ex.stats()["train"]
    assert s["preemptions"] >= 1 and s["completed"] == 1
    assert torch.equal(out["X"], _direct("lsqr", {"tolerance": 1e-6},
                                         ops, 2)["X"])


def test_a_degraded_executor_sheds_train_submits(sdir):
    with MicrobatchExecutor(name="t-shed", device="cpu") as ex:
        ex._is_degraded = lambda: True
        with pytest.raises(ServeOverloadedError):
            ex.submit_train_job(TrainJobSpec(solver="lsqr", budget_iters=8),
                                operands=_lsqr_ops())
        assert ex.stats()["train"] is None
        assert ex._counts["train_shed"] == 1


def test_the_retry_budget_bounds_failures(sdir, monkeypatch):
    with MicrobatchExecutor(name="t-retry", device="cpu") as ex:
        mgr = ex.train_jobs
        calls = {"n": 0}

        def flaky_append(*a, **kw):
            calls["n"] += 1
            raise RuntimeError("synthetic slice failure")

        monkeypatch.setattr(ex.sessions, "append", flaky_append)
        h = ex.submit_train_job(
            TrainJobSpec(solver="lsqr", budget_iters=16, retry_budget=2),
            operands=_lsqr_ops())
        with pytest.raises(RuntimeError, match="synthetic"):
            h.result(timeout=120)
        s = mgr.stats()
    assert calls["n"] == 3 and s["retries"] == 2 and s["failed"] == 1


def test_a_drain_releases_and_a_peer_resumes_bit_equal(sdir):
    """A drained executor checkpoints and releases its job (the future
    breaks with CommunicationError); a peer resumes it from disk and
    finishes with the uninterrupted run's result, under the job's
    original deadline."""
    ops = _lsqr_ops(seed=3)
    hyper = {"tolerance": 1e-6}
    ex = MicrobatchExecutor(name="t-drain", device="cpu")
    h = ex.submit_train_job(
        TrainJobSpec(solver="lsqr", hyper=hyper, budget_iters=64,
                     slice_iters=1, checkpoint_every=100), operands=ops)
    ex.drain(timeout=30)
    with pytest.raises(errors.CommunicationError):
        h.result(timeout=30)
    assert os.path.exists(tstate.operands_path(sdir, h.job_id) + ".npz")
    with MicrobatchExecutor(name="t-peer", device="cpu") as peer:
        h2 = peer.resume_train_job(h.job_id)
        assert peer.train_job_status(h.job_id)["job_id"] == h.job_id
        out = h2.result(timeout=120)
        assert peer.stats()["train"]["resumes"] == 1
    assert torch.equal(out["X"], _direct("lsqr", hyper, ops, 1)["X"])


# -- knobs and names -----------------------------------------------------


def test_train_knobs_and_metric_names(monkeypatch):
    from libskylark_tpu_torch.base import env
    from libskylark_tpu_torch.telemetry.names import METRICS

    for var in ("SKYLARK_TRAIN_SLICE_ITERS", "SKYLARK_TRAIN_RETRY_BUDGET",
                "SKYLARK_TRAIN_CKPT_EVERY", "SKYLARK_TRAIN_DEADLINE_S"):
        assert var in env.REGISTRY and var in env.propagated_names(), var
        assert "ROADMAP" not in env.REGISTRY[var].doc
    monkeypatch.setenv("SKYLARK_TRAIN_SLICE_ITERS", "5")
    monkeypatch.setenv("SKYLARK_TRAIN_DEADLINE_S", "123.0")
    monkeypatch.setenv("SKYLARK_TRAIN_CKPT_EVERY", "3")
    monkeypatch.setenv("SKYLARK_TRAIN_RETRY_BUDGET", "7")
    spec = TrainJobSpec(solver="lsqr", budget_iters=8)
    assert (spec.eff_slice_iters, spec.eff_deadline_s,
            spec.eff_checkpoint_every, spec.eff_retry_budget) == \
        (5, 123.0, 3, 7)
    spec = TrainJobSpec(solver="lsqr", budget_iters=8, slice_iters=3,
                        deadline_s=9.0)
    assert spec.eff_slice_iters == 3 and spec.eff_deadline_s == 9.0
    assert TrainJobSpec.from_dict(spec.to_dict()) == spec
    with pytest.raises(errors.InvalidParametersError):
        TrainJobSpec(solver="lsqr", budget_iters=0).validate()
    for name, kind in (("train.jobs_submitted", "counter"),
                       ("train.slices_run", "counter"),
                       ("train.preemptions", "counter"),
                       ("train.resumes", "counter"),
                       ("train.budget_exhausted", "counter"),
                       ("train.progress", "gauge"),
                       ("train.residual", "gauge")):
        assert METRICS.get(name) == kind, name
