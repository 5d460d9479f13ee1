"""The port's checkpoints (utility/checkpoint.py) against the JAX
package's, on the CPU, and BlockADMMSolver's stop and resume.

- ``save_sync`` snapshots load in the other package, and both packages
  write the same npz members, byte for byte, for the same arrays and
  metadata;
- ``sample_digest`` gives the reference's hex, under the byte budget
  (every byte) and above it (the same strided rows), for numpy arrays
  and tensors of several dtypes;
- ``TrainCheckpointer`` keeps the reference's API: steps, ``keep``,
  metadata, restore into a target, the async save's host copy made
  before it returns, the ``checkpoint.save`` fault site under
  ``save_sync``'s retry;
- ADMM stopped at iteration j and resumed is ``torch.equal`` to the
  uninterrupted run; a rerun of another run, past ``maxiter``, or of a
  converged run under another ``tol`` refuses.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from libskylark_tpu.utility import checkpoint as rck
from libskylark_tpu_torch import ml
from libskylark_tpu_torch.algorithms import prox
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience.policy import RetryPolicy
from libskylark_tpu_torch.utility import checkpoint as ck


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"SX": rng.standard_normal((7, 5)).astype(np.float32),
            "G": rng.standard_normal((4, 4)),
            "idx": rng.integers(0, 9, 6).astype(np.int32)}


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_save_sync_round_trips_across_packages(tmp_path):
    arrays, meta = _arrays(), {"seq": 4, "rows": 96, "spec": {"kind": "cwt"}}
    ck.save_sync(str(tmp_path / "p"), arrays, meta)
    rck.save_sync(str(tmp_path / "r"), arrays, meta)
    assert _members(tmp_path / "p.npz") == _members(tmp_path / "r.npz")
    assert ((tmp_path / "p.json").read_bytes()
            == (tmp_path / "r.json").read_bytes())
    for load, src in ((rck.load_sync, "p"), (ck.load_sync, "r")):
        got, gmeta = load(str(tmp_path / src))
        assert gmeta == meta
        assert set(got) == set(arrays)
        for k in arrays:
            assert got[k].dtype == arrays[k].dtype
            np.testing.assert_array_equal(got[k], arrays[k])
    # tensors are written as their bytes
    ck.save_sync(str(tmp_path / "t"),
                 {k: torch.from_numpy(v) for k, v in arrays.items()}, meta)
    assert _members(tmp_path / "t.npz") == _members(tmp_path / "r.npz")
    assert ck.load_sync(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="reserved"):
        ck.save_sync(str(tmp_path / "x"), {"__meta__": np.zeros(1)})


@pytest.mark.parametrize("case", ["small", "sampled", "rows", "tensor",
                                  "float64", "int", "scalar", "empty"])
def test_sample_digest_matches_the_reference(case):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((300, 17)).astype(np.float32)
    kw = {}
    if case == "sampled":
        kw = {"byte_budget": 17 * 4 * 40}    # 40 of 300 rows
    elif case == "rows":
        kw = {"rows": 9}
    elif case == "tensor":
        kw = {"byte_budget": 17 * 4 * 33}
    elif case == "float64":
        a = rng.standard_normal((50, 3))
    elif case == "int":
        a = rng.integers(-1000, 1000, (40, 2))
    elif case == "scalar":
        a = np.float32(2.5)
    elif case == "empty":
        a = np.zeros((0, 4), np.float32)
    want = rck.sample_digest(a, **kw)
    got = ck.sample_digest(torch.from_numpy(np.asarray(a))
                           if case in ("tensor", "float64", "int")
                           else a, **kw)
    assert got == want
    if case == "sampled":
        b = a.copy()
        b[1] += 1.0                    # row 1 is not sampled
        assert ck.sample_digest(b, **kw) == got
        b[0] += 1.0
        assert ck.sample_digest(b, **kw) != got


def test_train_checkpointer_steps_keep_and_restore(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "it": torch.tensor(3, dtype=torch.int64),
             "parts": [np.ones(2, np.float32), (torch.zeros(1),)]}
    with ck.TrainCheckpointer(str(tmp_path), keep=2) as c:
        assert c.latest_step() is None
        with pytest.raises(errors.InvalidParametersError):
            c.restore()
        for step in (1, 2, 5):
            c.save(step, state, {"step": step})
        assert c.all_steps() == [2, 5] and c.latest_step() == 5
        step, meta = c.metadata()
        assert (step, meta) == (5, {"step": 5})
        step, raw, meta = c.restore(2)
        assert step == 2 and isinstance(raw["w"], np.ndarray)
        np.testing.assert_array_equal(raw["w"], state["w"].numpy())
        assert isinstance(raw["parts"][1], tuple)
        target = {"w": torch.zeros(2, 3, dtype=torch.float64),
                  "it": torch.zeros((), dtype=torch.int64),
                  "parts": [torch.zeros(2), (torch.zeros(1),)]}
        _, got, _ = c.restore(target=target)
        assert got["w"].dtype == torch.float64
        assert torch.equal(got["w"], state["w"].double())
        assert int(got["it"]) == 3
    assert sorted(os.listdir(tmp_path)) == ["2", "5"]


def test_async_save_copies_to_host_before_it_returns(tmp_path):
    w = torch.ones(1000)
    c = ck.TrainCheckpointer(str(tmp_path))
    c.save(1, [w])
    w.add_(1.0)                        # after save returned
    c.save(2, [w])
    c.close()
    assert np.all(c.restore(1)[1][0] == 1.0)
    assert np.all(c.restore(2)[1][0] == 2.0)
    c2 = ck.as_checkpointer(str(tmp_path))
    assert ck.as_checkpointer(c2) is c2 and c2.all_steps() == [1, 2]


def test_save_sync_retries_the_fault_site(tmp_path):
    c = ck.TrainCheckpointer(str(tmp_path), async_save=False)
    fast = RetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0,
                       sleep=lambda s: None, retry_on=(errors.IOError_,))
    plan = {"faults": [{"site": "checkpoint.save", "error": "IOError_",
                        "on_hit": 1}]}
    with faults.fault_plan(plan):
        c.save_sync(7, {"x": torch.ones(3)}, {"why": "preempted"},
                    retry=fast)
    assert c.all_steps() == [7] and c.metadata()[1] == {"why": "preempted"}
    plan = {"faults": [{"site": "checkpoint.save", "error": "IOError_"}]}
    with faults.fault_plan(plan), pytest.raises(errors.IOError_):
        ck.save_sync(str(tmp_path / "s"), {"x": np.ones(2)})
    assert not (tmp_path / "s.npz").exists()


def test_device_state_casts_floats_only():
    got = ck.device_state({"w": np.ones(3), "i": np.arange(3),
                           "n": [np.zeros(2, np.float32)], "k": "tag"},
                          dtype=torch.float32, device="cpu")
    assert got["w"].dtype == torch.float32
    assert got["i"].dtype == torch.int64
    assert got["n"][0].dtype == torch.float32 and got["k"] == "tag"


# -- BlockADMMSolver: stop and resume ------------------------------------


def _admm_data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((160, 8)).astype(np.float32)
    return torch.from_numpy(X), torch.from_numpy(rng.integers(0, 3, 160))


def _admm(maxiter, lam=0.01, tol=0.0):
    s = ml.BlockADMMSolver.from_kernel(
        Context(2), prox.LogisticLoss(), prox.L2Regularizer(), lam, 48,
        ml.Gaussian(8, 3.0), num_partitions=3)
    s.maxiter, s.tol = maxiter, tol
    return s


@pytest.mark.parametrize("stop,every", [(4, 2), (5, 3)])
def test_admm_stop_and_resume_is_uninterrupted(tmp_path, stop, every):
    X, Y = _admm_data()
    want = _admm(9).train(X, Y, device="cpu").coef
    d = str(tmp_path)
    _admm(stop).train(X, Y, device="cpu", checkpoint=d,
                      checkpoint_every=every)
    assert ck.TrainCheckpointer(d).latest_step() == stop
    got = _admm(9).train(X, Y, device="cpu", checkpoint=d,
                         checkpoint_every=every)
    assert torch.equal(got.coef, want)
    # a finished run's rerun returns its model without iterating
    again = _admm(9).train(X, Y, device="cpu", checkpoint=d)
    assert torch.equal(again.coef, want)


def test_admm_resume_refusals(tmp_path):
    X, Y = _admm_data()
    d = str(tmp_path)
    _admm(6).train(X, Y, device="cpu", checkpoint=d)
    with pytest.raises(errors.InvalidParametersError, match="different"):
        _admm(9, lam=0.02).train(X, Y, device="cpu", checkpoint=d)
    X2 = X.clone()
    X2[0, 0] += 1.0
    with pytest.raises(errors.InvalidParametersError, match="different"):
        _admm(9).train(X2, Y, device="cpu", checkpoint=d)
    with pytest.raises(errors.InvalidParametersError, match="maxiter"):
        _admm(5).train(X, Y, device="cpu", checkpoint=d)
    conv = str(tmp_path / "conv")
    _admm(40, tol=0.5).train(X, Y, device="cpu", checkpoint=conv)
    with pytest.raises(errors.InvalidParametersError, match="tol"):
        _admm(40, tol=0.1).train(X, Y, device="cpu", checkpoint=conv)
    c = ck.TrainCheckpointer(str(tmp_path / "old"))
    c.save(1, [torch.zeros(1)], {"identity_scheme": 3})
    c.close()
    with pytest.raises(errors.InvalidParametersError, match="older build"):
        _admm(9).train(X, Y, device="cpu", checkpoint=str(tmp_path / "old"))
