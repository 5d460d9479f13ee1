"""The port's environment registry, named locks and metrics registry
(``base/env.py``, ``base/locks.py``, ``telemetry/metrics.py``) against the
JAX package's, on the CPU. Exact: the same declarations, the same parsed
values for a table of strings, the same lock-order violation, the same
snapshot after the same operations.
"""

import threading

import pytest

from libskylark_tpu.base import env as jenv
from libskylark_tpu.base import locks as jlocks
from libskylark_tpu.telemetry import metrics as jmetrics
from libskylark_tpu_torch.base import env, locks
from libskylark_tpu_torch.telemetry import metrics

RAW = ("", "0", "1", "2", "-3", "0.5", "1e3", "abc", "off", "OFF ", "no",
       "false", "true", "on", " pallas ", "XLA", "process", "auto",
       "interactive", "Best_Effort", "/tmp/x", "{}", "4096")


def test_every_variable_is_declared_as_the_reference_declares_it():
    assert list(env.REGISTRY) == list(jenv.REGISTRY)
    for name, want in jenv.REGISTRY.items():
        got = env.REGISTRY[name]
        assert (got.default, got.kind, got.propagate) == (
            want.default, want.kind, want.propagate), name
        assert (got.parser is None) == (want.parser is None), name
        assert got.doc, name
    assert env.propagated_names() == jenv.propagated_names()
    assert env.QOS_CLASSES == jenv.QOS_CLASSES
    assert env.OFF_WORDS == jenv.OFF_WORDS


@pytest.mark.parametrize("raw", RAW)
def test_parsers_agree_on_a_table_of_strings(raw, monkeypatch):
    for name in jenv.REGISTRY:
        monkeypatch.setenv(name, raw)
    for name, want in jenv.REGISTRY.items():
        assert env.lookup(name).get() == want.get(), (name, raw)
        assert env.lookup(name).raw() == raw
    assert env.snapshot_propagated() == jenv.snapshot_propagated()


def test_unset_variables_read_their_defaults(monkeypatch):
    for name in jenv.REGISTRY:
        monkeypatch.delenv(name, raising=False)
    for name, want in jenv.REGISTRY.items():
        assert env.lookup(name).get() == want.get() == want.default
        assert not env.lookup(name).is_set()
    with pytest.raises(KeyError):
        env.lookup("SKYLARK_NOT_DECLARED")
    with pytest.raises(ValueError):
        env.declare("SKYLARK_TELEMETRY")


def _inversion(mod):
    """Take two named locks in one order, then the other, under the
    witness; the report and whether check_witness raised."""
    mod.reset_witness()
    mod.enable_witness(True)
    try:
        a, b, r = (mod.make_lock("t.a"), mod.make_lock("t.b"),
                   mod.make_rlock("t.r"))
        with a:
            with b:
                pass
        with r:
            with r:
                with a:
                    pass
        t = threading.Thread(target=lambda: [b.acquire(), a.acquire(),
                                             a.release(), b.release()])
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        rep = mod.witness_report()
        try:
            mod.check_witness()
            raised = None
        except mod.LockOrderError as e:
            raised = str(e).splitlines()[0]
    finally:
        mod.enable_witness(False)
        mod.reset_witness()
    edges = rep["edges"]
    viol = [(v["edge"], v["held"]) for v in rep["violations"]]
    return rep["acquisitions"], edges, viol, raised


def test_the_witness_raises_on_the_same_inversion():
    got, want = _inversion(locks), _inversion(jlocks)
    assert got == want
    assert got[3] is not None and got[2] == [(("t.b", "t.a"), ["t.b"])]


def test_locks_are_plain_without_the_witness():
    locks.enable_witness(False)
    try:
        assert type(locks.make_lock("x")) is type(threading.Lock())
        assert not isinstance(locks.make_rlock("x"), locks.WitnessLock)
    finally:
        locks._FORCED = None


def _metrics_script(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("cache.hits", "hits")
    g = reg.gauge("qos.queue_depth", "depth")
    h = reg.histogram("qos.request_latency", "latency",
                      buckets=(0.01, 0.1, 1.0))
    for i in range(5):
        c.inc(**{"class": "interactive"})
        c.inc(2, **{"class": "standard"})
        g.set(float(i), replica="ex-0")
        g.add(1.5, replica="ex-1")
        h.observe(0.003 * i ** 3, **{"class": "standard"})
    c.inc_always(7)
    reg.register_collector("blk", lambda: {"x": 1})
    reg.register_collector("bad", lambda: 1 / 0)
    life = mod.LifetimeCounter("t.life", kinds=("a", "b"))
    life.inc("a", 3)
    life.inc("c")
    snap = reg.snapshot()
    snap["collectors"]["bad"] = {"error": snap["collectors"]["bad"][
        "error"].split("(")[0]}
    before_reset = (c.value(**{"class": "standard"}),
                    g.value(replica="ex-1"))
    reg.reset()
    return snap, life.snapshot(), before_reset, reg.snapshot()


def test_snapshot_is_equal_after_the_same_operations():
    was, jwas = metrics.enabled(), jmetrics.enabled()
    metrics.set_enabled(True)
    jmetrics.set_enabled(True)
    try:
        assert _metrics_script(metrics) == _metrics_script(jmetrics)
        metrics.set_enabled(False)
        jmetrics.set_enabled(False)
        assert _metrics_script(metrics) == _metrics_script(jmetrics)
    finally:
        metrics.set_enabled(was)
        jmetrics.set_enabled(jwas)


def test_telemetry_and_timers_read_the_registry(monkeypatch):
    from libskylark_tpu_torch.utility import timer

    saved, tsaved = metrics._ENABLED, timer._ENABLED
    try:
        for raw, on in (("1", True), ("0", False), ("", False)):
            monkeypatch.setenv("SKYLARK_TELEMETRY", raw)
            monkeypatch.delenv("SKYLARK_TELEMETRY_DIR", raising=False)
            metrics._ENABLED = None
            assert metrics.enabled() is on
            monkeypatch.setenv("SKYLARK_TPU_PROFILE", raw)
            timer._ENABLED = None
            assert timer.timers_enabled() is on
        monkeypatch.setenv("SKYLARK_TELEMETRY_DIR", "/nonexistent")
        metrics._ENABLED = None
        assert metrics.enabled()
    finally:
        metrics._ENABLED, timer._ENABLED = saved, tsaved
