"""The port's resilience layer (``resilience/policy.py``, ``faults.py``,
``health.py``, ``preemption.py``) against the JAX package's, on the CPU:
``RetryPolicy`` draws the same delays under one seed and retries the same
way, a fault plan fires the same list for the same sequence of checks, the
health hub counts and fans transitions as the reference's, and SIGTERM
drains every live executor. Exact throughout; no real sleep.
"""

import os
import signal
import warnings

import pytest

from libskylark_tpu.base import errors as jerrors
from libskylark_tpu.resilience import faults as jfaults
from libskylark_tpu.resilience import health as jhealth
from libskylark_tpu.resilience import policy as jpolicy
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.engine import serve
from libskylark_tpu_torch.resilience import (faults, health, policy,
                                             preemption)


@pytest.mark.parametrize("jitter", ["decorrelated", "full", "none"])
@pytest.mark.parametrize("seed", [0, 7, 2**40])
def test_retry_delays_equal_the_reference(jitter, seed):
    kw = dict(base_delay=0.05, max_delay=2.0, multiplier=3.0,
              jitter=jitter, seed=seed)
    got, want = policy.RetryPolicy(**kw).delays(), \
        jpolicy.RetryPolicy(**kw).delays()
    assert [next(got) for _ in range(12)] == [next(want) for _ in range(12)]


def _retry_run(pol_mod, err_mod, fail_times, exc_name, deadline=None):
    slept, calls, retried = [], [], []

    def fn(timeout=None):
        calls.append(timeout)
        if len(calls) <= fail_times:
            raise getattr(err_mod, exc_name)("flaky")
        return "ok"

    p = pol_mod.RetryPolicy(max_attempts=4, seed=3, sleep=slept.append,
                            attempt_timeout=5.0, timeout_arg="timeout")
    try:
        out = p.call(fn, deadline=deadline,
                     on_retry=lambda a, e, d: retried.append((a, d)))
    except BaseException as e:  # noqa: BLE001 — compared by name
        out = (type(e).__name__, getattr(e, "trace", None))
    return out, slept, calls, retried


@pytest.mark.parametrize("fail_times,exc", [(0, "IOError_"), (2, "IOError_"),
                                            (9, "CommunicationError"),
                                            (1, "InvalidParametersError")])
def test_retry_call_equals_the_reference(fail_times, exc):
    assert (_retry_run(policy, errors, fail_times, exc)
            == _retry_run(jpolicy, jerrors, fail_times, exc))


def test_deadlines_equal_the_reference():
    for mod in (policy, jpolicy):
        assert mod.Deadline.coerce(None) is None
        d = mod.Deadline.coerce(0.0)
        assert d.expired and mod.Deadline.coerce(d) is d
        with pytest.raises(mod.DeadlineExceededError):
            d.check("step")
        assert mod.Deadline.after(None).remaining() == float("inf")
        assert not mod.Deadline(60).expired
        assert not mod.RetryPolicy().retryable(mod.DeadlineExceededError())
        assert _retry_run(mod, errors if mod is policy else jerrors, 9,
                          "IOError_", deadline=0.0)[0][0] == \
            "DeadlineExceededError"
    assert [c.__name__ for c in policy.TRANSIENT_ERRORS] == [
        c.__name__ for c in jpolicy.TRANSIENT_ERRORS]


PLAN = {"seed": 11, "faults": [
    {"site": "serve.flush", "error": "SketchError", "tag": "poison"},
    {"site": "serve.flush", "error": "IOError_", "every": 5, "after": 2},
    {"site": "qos.admit", "error": "AllocationError", "prob": 0.3,
     "times": 4},
    {"site": "qos.admit", "error": "ValueError", "on_hit": 7},
    {"site": "serve.flush", "stall_s": 0.0, "on_hit": 3}]}


def _fire(mod, tag_mod):
    raised = []
    with mod.fault_plan(PLAN) as plan:
        for i in range(60):
            site = "serve.flush" if i % 3 else "qos.admit"
            tags = ("poison",) if i % 11 == 0 else ()
            try:
                with tag_mod.tag("t%d" % (i % 2)):
                    mod.check(site, tags=tags, detail=str(i))
                raised.append(None)
            except Exception as e:  # noqa: BLE001 — compared by name
                raised.append(type(e).__name__)
        fired = mod.fired()
        plan.reset()
        after_reset = (mod.fired(), [s.hits for s in plan.specs])
    return raised, fired, after_reset, mod.fired()


def test_a_plan_fires_the_same_list_as_the_reference():
    got, want = _fire(faults, faults), _fire(jfaults, jfaults)
    assert got == want
    assert any(got[0]) and got[1]


def test_the_env_plan_and_bad_plans(monkeypatch):
    import json

    monkeypatch.setenv("SKYLARK_FAULT_PLAN", json.dumps(
        {"faults": [{"site": "qos.admit", "on_hit": 2}]}))
    faults.reset()
    faults.check("qos.admit")
    with pytest.raises(errors.IOError_):
        faults.check("qos.admit")
    assert faults.fired() == [("qos.admit", 2, "IOError_")]
    faults.reset()
    monkeypatch.delenv("SKYLARK_FAULT_PLAN")
    assert faults.active_plan() is None and faults.fired() == []
    for bad in ({"faults": [{"error": "IOError_"}]},
                {"faults": [{"site": "x", "error": "NoSuchError"}]},
                {"faults": [{"site": "x", "stall_s": 1, "crash": True}]},
                {"faults": [{"site": "x", "bogus": 1}]}):
        with pytest.raises(errors.InvalidParametersError):
            faults.FaultPlan(bad)


def _hub(mod):
    seen = []
    seq0 = mod.transition_seq()
    unsub = mod.subscribe(lambda s, o, n: seen.append((s, o, n)))

    def broken(s, o, n):
        raise RuntimeError("subscriber")

    unsub2 = mod.subscribe(broken)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mod.publish("src", "SERVING", "DEGRADED")
        mod.publish("src", "DEGRADED", "SERVING")
    unsub()
    unsub2()
    unsub()
    mod.publish("src", "SERVING", "DRAINING")
    return seen, mod.transition_seq() - seq0, len(w)


def test_the_health_hub_equals_the_reference():
    assert _hub(health) == _hub(jhealth)


def test_sigterm_drains_every_live_executor():
    ex = serve.MicrobatchExecutor(device="cpu", linger_us=60_000_000)
    saved = []
    try:
        import numpy as np

        from libskylark_tpu_torch import sketch as sk
        from libskylark_tpu_torch.base.context import Context

        T = sk.JLT(32, 8, Context(1))
        fut = ex.submit_sketch(T, np.ones((3, 32), np.float32), sk.ROWWISE)
        preemption.install_preemption_handler(drain_timeout=30.0)
        unregister = preemption.on_preemption(lambda: saved.append(1))
        os.kill(os.getpid(), signal.SIGTERM)
        assert preemption.wait_for_preemption_teardown(timeout=30)
        unregister()
        assert preemption.preemption_requested()
        assert fut.result(timeout=30).shape == (3, 8)
        assert ex.state == serve.STOPPED and saved == [1]
        with pytest.raises(serve.ServeOverloadedError):
            ex.submit_sketch(T, np.ones((3, 32), np.float32), sk.ROWWISE)
    finally:
        preemption.uninstall_preemption_handler()
        ex.shutdown()
    assert not preemption.preemption_requested()
