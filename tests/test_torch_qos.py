"""The port's QoS layer (``qos/tenants.py``, ``scheduler.py``,
``controller.py``) against the JAX package's, on the CPU: token buckets
admit and refuse the same arrivals under one manual clock, the registry
resolves and charges alike, the deficit scheduler picks the same classes
over hypothesis ready-sets, and the adaptive controller makes the same
target moves from the same synthetic observations. Exact throughout.
"""

import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

from libskylark_tpu import qos as jqos
from libskylark_tpu.base import errors as jerrors
from libskylark_tpu.qos import controller as jcontroller
from libskylark_tpu_torch import qos
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.qos import controller

ARRIVALS = [0.0, 0.0, 0.0, 0.01, 0.02, 0.5, 0.5, 0.49, 1.0, 1.0, 1.0, 1.0,
            1.7, 3.0, 3.0, 3.0, 3.0, 3.0, 9.0]


@pytest.mark.parametrize("rate,burst", [(2.0, None), (1.0, 3.0),
                                        (10.0, 0.5), (0.25, 1.0)])
def test_token_bucket_admits_as_the_reference(rate, burst):
    got, want = qos.TokenBucket(rate, burst), jqos.TokenBucket(rate, burst)
    assert [got.try_acquire(t) for t in ARRIVALS] == [
        want.try_acquire(t) for t in ARRIVALS]
    assert got.available() == want.available()
    for mod, err in ((qos, errors), (jqos, jerrors)):
        with pytest.raises(err.InvalidParametersError):
            mod.TokenBucket(0.0)


def _registry(mod, err):
    reg = mod.TenantRegistry()
    reg.register("ui", "interactive")
    reg.register("bulk", "BEST_EFFORT ", rate=1.0, burst=2.0)
    reg.register("typo", "no-such-class")
    out = [reg.resolve(None), reg.resolve("ui"), reg.resolve("nobody"),
           reg.accounting_name("nobody"), reg.accounting_name("ui"),
           reg.names()]
    for t in (0.0, 0.1, 0.2, 1.3, 1.4):
        try:
            out.append(reg.admit("bulk", now=t))
        except err.TenantQuotaError as e:
            out.append((e.tenant, round(e.retry_after_s, 9), e.code))
    reg.unregister("typo")
    out.append(reg.stats())
    return out


def test_registry_resolves_and_charges_as_the_reference():
    assert _registry(qos, errors) == _registry(jqos, jerrors)


@pytest.mark.parametrize("envs", [{}, {
    "SKYLARK_QOS_DEFAULT_CLASS": "interactive",
    "SKYLARK_QOS_SHED_BEST_EFFORT": "0.05",
    "SKYLARK_QOS_SLO_STANDARD_MS": "12.5",
    "SKYLARK_CACHE_QUOTA_STANDARD": "2.0",
    "SKYLARK_QOS_RATE_DEFAULT": "-1"}])
def test_class_policies_equal_the_reference(envs, monkeypatch):
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    for c in (*jqos.CLASSES, None, "bogus"):
        assert (dataclasses.asdict(qos.class_policy(c))
                == dataclasses.asdict(jqos.class_policy(c)))
        assert qos.coerce_class(c) == jqos.coerce_class(c)
    for c in jqos.CLASSES:
        assert qos.shed_fraction(c) == jqos.shed_fraction(c)
        assert qos.slo_seconds(c) == jqos.slo_seconds(c)
        assert (qos.tenants.cache_quota_fraction(c)
                == jqos.tenants.cache_quota_fraction(c))
    assert qos.default_class() == jqos.default_class()
    assert qos.TenantRegistry().register("x").bucket is None
    assert qos.CLASSES == jqos.CLASSES
    assert qos.DEFAULT_WEIGHTS == jqos.DEFAULT_WEIGHTS
    assert qos.tenants.PRESSURE_FRACTIONS == jqos.tenants.PRESSURE_FRACTIONS


CLASSES = ("interactive", "standard", "best_effort")
_backlog = st.fixed_dictionaries({c: st.integers(0, 20) for c in CLASSES})
_costs = st.fixed_dictionaries({c: st.integers(1, 9) for c in CLASSES})


@settings(max_examples=60, deadline=None)
@given(steps=st.lists(st.tuples(_backlog, _costs, st.booleans()),
                      min_size=1, max_size=40),
       quantum=st.integers(1, 8),
       weights=st.one_of(st.none(), st.fixed_dictionaries(
           {c: st.integers(0, 9) for c in CLASSES})))
def test_deficit_scheduler_orders_as_the_reference(steps, quantum, weights):
    got = qos.DeficitScheduler(weights, quantum=quantum)
    want = jqos.DeficitScheduler(weights, quantum=quantum)
    for backlog, costs, bypass in steps:
        a = got.next_class(backlog, costs.get)
        b = want.next_class(backlog, costs.get)
        assert a == b
        if a is not None:
            got.charge(a, min(costs[a], backlog[a]))
            want.charge(b, min(costs[b], backlog[b]))
        if bypass:
            got.note_bypass("standard", 2)
            want.note_bypass("standard", 2)
    assert got.stats() == want.stats()


def test_drain_order_equals_the_reference():
    for classes in (CLASSES, ("standard", "interactive"), ("x", "best_effort"),
                    ()):
        assert qos.drain_order(classes) == jqos.drain_order(classes)


class _FakeExecutor:
    """What the controller reads and moves, fed scripted observations."""

    def __init__(self, script):
        self.name, self.linger, self.max_batch = "fake", 0.002, 8
        self.script = list(script)
        self.targets, self.moves, self.resets = {}, [], []

    def qos_bucket_obs(self):
        return self.script.pop(0) if self.script else {}

    def bucket_targets(self, statics):
        return self.targets.get(statics, (self.linger, self.max_batch))

    def set_bucket_targets(self, statics, *, linger_s=None, batch_cap=None):
        self.targets[statics] = (linger_s, batch_cap)
        self.moves.append((statics, linger_s, batch_cap))

    def qos_reset_bucket_obs(self, statics):
        self.resets.append(statics)


def _obs(n, p99, waste, classes=("standard",), caps=(1, 2, 4, 8)):
    return {"n": n, "p99": p99, "padding_waste": waste,
            "classes": frozenset(classes), "caps": frozenset(caps)}


SLOW, FAST = ("sketch_apply", 1), ("solve_l2_sketched", 2)
SCRIPT = [
    {SLOW: _obs(4, 0.9, 0.1), FAST: _obs(4, 0.001, 0.6)},
    {SLOW: _obs(8, 0.8, 0.1), FAST: _obs(8, 0.001, 0.6)},
    {SLOW: _obs(10, 0.8, 0.1), FAST: _obs(12, 0.001, 0.6)},
    {SLOW: _obs(14, 0.8, 0.1), FAST: _obs(16, 0.001, 0.6)},
    {SLOW: _obs(18, 0.8, 0.1), FAST: _obs(20, 0.2, 0.6)},
    {SLOW: _obs(22, None, 0.1), FAST: _obs(24, 0.001, 0.6,
                                           ("interactive",))},
    {SLOW: _obs(26, 0.01, 0.9), FAST: _obs(28, 0.001, 0.6,
                                           ("interactive",))},
    {SLOW: _obs(30, 0.01, 0.9), FAST: _obs(32, 0.9, 0.0)},
]


@pytest.mark.parametrize("frozen", [False, True])
def test_controller_moves_as_the_reference(frozen, monkeypatch):
    monkeypatch.setenv("SKYLARK_QOS_ADAPT", "0" if frozen else "1")
    runs = []
    for mod in (controller, jcontroller):
        ex = _FakeExecutor(SCRIPT)
        c = mod.AdaptiveController(ex, interval_s=1.0, start=False)
        changes = [c.tick() for _ in range(len(SCRIPT))]
        runs.append((changes, ex.moves, ex.resets, c.stats()))
        c.close()
    assert runs[0] == runs[1]
    assert any(runs[0][0]) != frozen
    assert controller.HYSTERESIS_TICKS == jcontroller.HYSTERESIS_TICKS
    assert controller.LINGER_CEILING_FACTOR == \
        jcontroller.LINGER_CEILING_FACTOR
