"""The port's request tracing (``telemetry/trace.py``) against the JAX
package's, on the CPU: the same span program makes the same span tree
(names, parents, attributes, events, status, request ids), a span is a
``torch.profiler`` range enclosing the work inside it, and a disabled span
is the shared no-op.
"""

import threading

import pytest
import torch

from libskylark_tpu import telemetry as jtel
from libskylark_tpu.telemetry import trace as jtrace
from libskylark_tpu_torch import telemetry as tel
from libskylark_tpu_torch.telemetry import trace


def _program(mod, trace_mod):
    """Nested spans, an event, an error, a forced span and a cross-thread
    handoff; returns the finished spans in finishing order."""
    seen = []
    unregister = mod.add_sink(seen.append)
    try:
        with mod.span("serve.submit", attrs={"endpoint": "sketch_apply"},
                      request_id="req-1") as root:
            root.set_attr("k", 3)
            ctx = mod.get_context()
            with mod.span("inner") as inner:
                inner.add_event("resilience.retry", {"attempt": 1})
                mod.add_event("plain", None)
            with pytest.raises(ValueError):
                with mod.span("failing"):
                    raise ValueError("x")

        def other():
            with mod.attach(ctx):
                with mod.span("serve.flush", attrs={"cohort": 2}):
                    pass
            with mod.span("orphan", parent=ctx, request_id="req-2"):
                pass

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with mod.attach(None):
            pass
    finally:
        unregister()
    return seen


def _tree(spans):
    ids = {s.span_id: i for i, s in enumerate(spans)}
    traces = {s.trace_id for s in spans}
    out = []
    for s in spans:
        d = s.to_dict()
        out.append((d["name"], ids.get(d["parent_id"]), d.get("attrs"),
                    [(e["name"], e["attrs"]) for e in d.get("events", [])],
                    d["status"], d.get("request_id"), "error" in d,
                    d["duration_s"] >= 0))
    return out, len(traces)


def test_span_trees_equal_the_reference():
    was, jwas = tel.enabled(), jtel.enabled()
    tel.set_enabled(True)
    jtel.set_enabled(True)
    try:
        got = _tree(_program(tel, trace))
        want = _tree(_program(jtel, jtrace))
    finally:
        tel.set_enabled(was)
        jtel.set_enabled(jwas)
    assert got == want
    assert got[1] == 1
    assert [t[0] for t in got[0]] == ["inner", "failing", "serve.submit",
                                      "serve.flush", "orphan"]


def test_a_disabled_span_is_the_shared_noop():
    was = tel.enabled()
    tel.set_enabled(False)
    try:
        cm = tel.span("x")
        assert cm is trace._NOOP
        with cm as sp:
            assert sp is None
        assert tel.current_span() is None and tel.get_context() is None
        with tel.span("forced", force=True) as sp:
            assert sp is not None and tel.current_span() is sp
    finally:
        tel.set_enabled(was)


def test_request_ids_and_the_finished_ring():
    rid = tel.new_request_id()
    assert rid.startswith("req-") and rid != tel.new_request_id()
    jrid = jtel.new_request_id()
    assert len(rid.split("-")) == len(jrid.split("-"))
    tel.clear_finished()
    with tel.span("a", force=True):
        pass
    assert [s.name for s in tel.finished_spans()] == ["a"]
    assert len(tel.finished_spans(1)) == 1


def test_a_span_is_a_profiler_range_around_its_work():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.span("serve.flush", force=True):
            y = x @ x
    events = list(prof.events())
    rng = [e for e in events if e.name == "serve.flush"]
    assert len(rng) == 1
    lo, hi = rng[0].time_range.start, rng[0].time_range.end
    mm = [e for e in events if e.name == "aten::mm"]
    assert mm and all(lo <= e.time_range.start and e.time_range.end <= hi
                      for e in mm)
    assert y.shape == (64, 64)
