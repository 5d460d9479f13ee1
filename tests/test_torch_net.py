"""The port's network front door (``libskylark_tpu_torch/net/``) against
the JAX package's, on the CPU.

Oracles:

- *byte identity*: ``encode_frame`` of the same header and values is the
  reference's bytes (ndarrays of f32, f64, i32, i64, numpy scalars,
  ``Dimension``, a CSR ``SparseMatrix``, a JLT and a Gaussian kernel, an
  ``OperandRef``, a ``ShardPlan``, a ``TrainJobSpec``, nested containers,
  and CPU tensors, a transposed one among them, against the same array in
  numpy), and each package's frame decodes in the other to an equal value;
  a request frame is the reference's too, transport digest included;
- *frame integrity*: a torn frame, a flipped payload byte, bad magic or
  trailing bytes is a ``WireProtocolError``; a clean EOF is ``PeerClosed``;
- *transport propagation, disconnect, drain, spans and stats*: the
  reference's ``tests/test_net.py`` classes that need no fleet, against a
  stub router that records ``submit`` kwargs and settles futures on
  demand;
- *across packages*: a reference ``NetClient`` served by a port
  ``NetServer``;
- *end to end*: a port ``NetServer`` over a port ``MicrobatchExecutor`` on
  the CPU serves ``sketch_apply`` and ``dist_sketch`` ``torch.equal`` to
  the same requests submitted in-process.

Every socket binds 127.0.0.1 on port 0; no sleep is longer than 50 ms and
every wait ends within 5 s. The retry-coalescing tests of the reference
need ``fleet.Router`` and come with the fleet slice (ROADMAP A).
"""

from __future__ import annotations

import io
import struct
import threading
import time
import zlib
from concurrent.futures import Future

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu import Context as RContext
from libskylark_tpu import sketch as rsk
from libskylark_tpu.base.sparse import SparseMatrix as RSparse
from libskylark_tpu.dist.plan import ShardPlan as RPlan
from libskylark_tpu.engine import resultcache as rrc
from libskylark_tpu.ml import kernels as rkern
from libskylark_tpu.net import client as rclient
from libskylark_tpu.net import wire as rwire
from libskylark_tpu.train.jobs import TrainJobSpec as RSpec
from libskylark_tpu_torch import net, telemetry
from libskylark_tpu_torch import sketch as psk
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import SparseMatrix
from libskylark_tpu_torch.dist import plan as dp
from libskylark_tpu_torch.engine import resultcache as prc
from libskylark_tpu_torch.engine.serve import (MicrobatchExecutor,
                                               ServeOverloadedError,
                                               serve_stats)
from libskylark_tpu_torch.ml import kernels as pkern
from libskylark_tpu_torch.net import wire
from libskylark_tpu_torch.telemetry import trace as trace_mod
from libskylark_tpu_torch.train.jobs import TrainJobSpec

WAIT = 5.0


def _until(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


# -- byte identity ---------------------------------------------------------

_RNG = np.random.default_rng(0)
_A = _RNG.standard_normal((6, 4))
_CSR = sp.random(40, 30, density=0.1, random_state=0, format="csr",
                 dtype=np.float32)
_PLAN = dict(kind="cwt", n=64, s_dim=16, d=8, seed=5, targets=1,
             shard_rows=16)
_SPEC = dict(solver="lsqr", hyper={"tol": 1e-6}, slice_iters=4,
             budget_iters=40)


def _pairs():
    """name -> (reference value, port value): one logical value each."""
    f32 = _A.astype(np.float32)
    return {
        "f32": (f32, f32),
        "f64": (_A, _A),
        "f32_fortran": (np.asfortranarray(f32), np.asfortranarray(f32)),
        "i32": (np.arange(7, dtype=np.int32),) * 2,
        "i64": (np.arange(7, dtype=np.int64),) * 2,
        "empty": (np.zeros((0, 3), np.float32),) * 2,
        "np_scalar": (np.float32(2.5), np.float32(2.5)),
        "np_int": (np.int64(-3), np.int64(-3)),
        "dimension": (rsk.ROWWISE, psk.ROWWISE),
        "csr": (RSparse.from_csr(_CSR.data, _CSR.indices, _CSR.indptr,
                                 _CSR.shape),
                SparseMatrix.from_csr(_CSR.data, _CSR.indices, _CSR.indptr,
                                      _CSR.shape)),
        "jlt": (rsk.JLT(64, 16, RContext(seed=3)),
                psk.JLT(64, 16, Context(seed=3))),
        "gaussian_kernel": (rkern.Gaussian(10, sigma=2.0),
                            pkern.Gaussian(10, sigma=2.0)),
        "operand_ref": (rrc.OperandRef("ab" * 16), prc.OperandRef("ab" * 16)),
        "shard_plan": (RPlan(**_PLAN), dp.ShardPlan(**_PLAN)),
        "train_spec": (RSpec(**_SPEC), TrainJobSpec(**_SPEC)),
        "nested": ({"a": [1, 2.5, "x", None, True],
                    "b": (np.arange(3), {"c": np.float64(1.5)})},) * 2,
        "tensor": (f32, torch.from_numpy(f32)),
        "tensor_transposed": (np.ascontiguousarray(f32.T),
                              torch.from_numpy(f32).T),
        "tensor_f64_slice": (np.ascontiguousarray(_A[::2, 1:]),
                             torch.from_numpy(_A)[::2, 1:]),
    }


def _frame(w, value):
    bodies: list = []
    spec = w.encode_value(value, bodies)
    return w.encode_frame({"t": "res", "value": spec, "nb": len(bodies)},
                          tuple(bodies))


def _decode(w, frame):
    header, bodies = w.read_frame(io.BytesIO(frame).read)
    return w.decode_value(header["value"], bodies)


def _same(a, b):
    """Two decoded values hold the same thing (arrays bit for bit; the
    registry objects by their ``to_dict``; a CSR by its parts)."""
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if hasattr(a, "csr_parts"):
        return a.shape == b.shape and all(
            np.array_equal(x, y) for x, y in zip(a.csr_parts(),
                                                 b.csr_parts()))
    if hasattr(a, "to_dict"):
        return a.to_dict() == b.to_dict()
    if hasattr(a, "value") and hasattr(b, "value"):        # Dimension
        return a.value == b.value
    if isinstance(a, (np.ndarray, np.generic)):
        a2, b2 = np.asarray(a), np.asarray(b)
        return a2.dtype == b2.dtype and np.array_equal(a2, b2)
    return a == b


@pytest.mark.parametrize("name", sorted(_pairs()))
def test_frames_are_the_reference_bytes_and_cross_decode(name):
    ref, port = _pairs()[name]
    fr, fp = _frame(rwire, ref), _frame(wire, port)
    assert fp == fr
    # each package decodes the other's frame to the same value
    assert _same(_decode(wire, fr), _decode(rwire, fr))
    assert _same(_decode(rwire, fp), _decode(wire, fp))


def test_request_frames_are_the_reference_bytes():
    f32 = _A.astype(np.float32)
    kw_r = {"A": f32, "transform": rsk.JLT(6, 3, RContext(seed=1)),
            "dimension": rsk.COLUMNWISE}
    kw_p = {"A": torch.from_numpy(f32),
            "transform": psk.JLT(6, 3, Context(seed=1)),
            "dimension": psk.COLUMNWISE}
    extra = dict(seq=7, tenant="team-a", qos_class="interactive",
                 deadline_s=2.5, timeout=9.0,
                 trace={"request_id": "req-1", "trace_id": "t",
                        "span_id": "s"})
    fr = rwire.pack_request("sketch_apply", kw_r, **extra)
    fp = wire.pack_request("sketch_apply", kw_p, **extra)
    assert fp == fr
    verb, kwargs = wire.unpack_request(*wire.read_frame(io.BytesIO(fr).read))
    assert verb == "sketch_apply" and np.array_equal(kwargs["A"], f32)
    assert kwargs["transform"].to_dict() == kw_p["transform"].to_dict()
    # the goaway and error frames too
    assert wire.pack_goaway(3.0) == rwire.pack_goaway(3.0)
    assert (wire.pack_error(4, errors.WireProtocolError("x"))
            == rwire.pack_error(4, rwire._errors.WireProtocolError("x")))


def test_a_cuda_only_dtype_is_refused_at_encode():
    with pytest.raises(errors.WireProtocolError):
        wire.encode_value(torch.zeros(2, dtype=torch.bfloat16), [])
    with pytest.raises(errors.WireProtocolError):
        wire.encode_value(object(), [])
    with pytest.raises(errors.WireProtocolError):
        wire.encode_value({1: "non-str key"}, [])


# -- frame integrity -------------------------------------------------------

def _ping_frame():
    return wire.pack_request("ping", {"A": np.arange(4)}, seq=1)


@pytest.mark.parametrize("kind", ["torn", "crc", "magic", "trailing"])
def test_a_corrupt_frame_is_a_protocol_error(kind):
    frame = _ping_frame()
    if kind == "torn":
        bad, match = frame[:-3], "mid-frame"
    elif kind == "crc":
        bad = bytearray(frame)
        bad[-1] ^= 0xFF
        bad, match = bytes(bad), "CRC"
    elif kind == "magic":
        bad, match = b"XXXX" + frame[4:], "magic"
    else:
        payload = frame[12:] + b"junk"
        bad = (wire.MAGIC + struct.pack("<II", len(payload),
                                        zlib.crc32(payload)) + payload)
        match = "trailing"
    with pytest.raises(errors.WireProtocolError, match=match):
        wire.read_frame(io.BytesIO(bad).read)


def test_clean_eof_is_peer_closed_and_errors_keep_retry_fields():
    with pytest.raises(wire.PeerClosed):
        wire.read_frame(io.BytesIO(b"").read)
    exc = errors.TenantQuotaError("over quota", tenant="team-a",
                                  retry_after_s=1.25)
    h, _ = wire.read_frame(io.BytesIO(wire.pack_error(4, exc)).read)
    back = wire.unpack_error(h)
    assert isinstance(back, errors.TenantQuotaError)
    assert back.tenant == "team-a" and back.retry_after_s == 1.25
    over = ServeOverloadedError("shed")
    over.retry_after_s = 0.5
    h2, _ = wire.read_frame(io.BytesIO(wire.pack_error(5, over)).read)
    back2 = wire.unpack_error(h2)
    assert isinstance(back2, ServeOverloadedError)
    assert back2.retry_after_s == 0.5


# -- the server and client over a stub router ------------------------------

class _StubRouter:
    """Records ``submit`` kwargs and settles through controllable futures
    (the reference's ``tests/test_net.py`` stub)."""

    def __init__(self):
        self.calls: list = []
        self.raise_exc = None
        self.hold = False
        self.held: list = []

    def submit(self, endpoint, /, **kwargs):
        self.calls.append((endpoint, kwargs))
        if self.raise_exc is not None:
            raise self.raise_exc
        fut: Future = Future()
        if self.hold:
            self.held.append(fut)
        else:
            fut.set_result(torch.arange(3, dtype=torch.float32))
        return fut

    def stats(self):
        return {"stub": True}


@pytest.fixture()
def served():
    stub = _StubRouter()
    srv = net.NetServer(stub, host="127.0.0.1", port=0)
    c = net.NetClient(srv.address, retry_budget=1, retry_backoff_s=0.01,
                      seed=0)
    yield stub, srv, c
    c.close()
    srv.close()


def test_tenant_qos_deadline_cross_the_wire(served):
    stub, srv, c = served
    out = c.submit("sketch_apply", tenant="team-a", qos_class="interactive",
                   deadline=30.0, timeout=12.0,
                   A=np.ones(2)).result(timeout=WAIT)
    assert np.array_equal(out, np.arange(3, dtype=np.float32))
    endpoint, kw = stub.calls[0]
    assert endpoint == "sketch_apply"
    assert kw["tenant"] == "team-a" and kw["qos_class"] == "interactive"
    assert 25.0 < kw["deadline"] <= 30.0 and kw["timeout"] == 12.0
    assert str(kw["request_id"]).startswith("req-")
    assert np.array_equal(kw["A"], np.ones(2))


@pytest.mark.parametrize("kind", ["quota", "overload", "unknown_verb"])
def test_structured_errors_survive_the_wire(served, kind):
    stub, srv, c = served
    if kind == "quota":
        stub.raise_exc = errors.TenantQuotaError(
            "bucket empty", tenant="team-b", retry_after_s=2.5)
        with pytest.raises(errors.TenantQuotaError) as ei:
            c.submit("sketch_apply", A=np.ones(2)).result(timeout=WAIT)
        assert ei.value.retry_after_s == 2.5 and ei.value.tenant == "team-b"
        assert srv.stats()["by_code"].get("115") == 1
    elif kind == "overload":
        exc = ServeOverloadedError("queue full")
        exc.retry_after_s = 0.75
        stub.raise_exc = exc
        with pytest.raises(ServeOverloadedError) as ei:
            c.submit("sketch_apply", A=np.ones(2)).result(timeout=WAIT)
        assert ei.value.retry_after_s == 0.75
    else:
        with pytest.raises(errors.WireProtocolError, match="unknown verb"):
            c.submit("no.such.verb").result(timeout=WAIT)
    # the connection survives a structured error
    assert c.ping(timeout=WAIT) == "pong"


def test_disconnect_mid_request_detaches(served):
    stub, srv, c = served
    stub.hold = True
    fut = c.submit("sketch_apply", A=np.ones(2))
    assert _until(lambda: stub.held), "request never reached the stub"
    c.close()                   # vanish with the request inflight
    with pytest.raises(errors.CommunicationError):
        fut.result(timeout=WAIT)
    # the server notices the dead peer before the future settles: the
    # detach-mid-request window
    assert _until(lambda: srv.stats()["disconnected_inflight"] == 1)
    assert _until(lambda: srv.stats()["connections_live"] == 0)
    # settling the orphaned future must not poison the server
    stub.held[0].set_result(torch.zeros(1))
    stub.hold = False
    c2 = net.NetClient(srv.address)
    try:
        assert c2.ping(timeout=WAIT) == "pong"
    finally:
        c2.close()


def test_goaway_drain_settles_inflight(served):
    """The drain's GOAWAY goes out before the held request settles, so the
    client sees it ahead of its result: settled only once the server
    counts the GOAWAY sent, the test does not depend on thread timing."""
    stub, srv, c = served
    stub.hold = True
    fut = c.submit("sketch_apply", A=np.ones(2))
    assert _until(lambda: stub.held)
    drained: list = []
    t = threading.Thread(target=lambda: drained.append(srv.drain(
        timeout=WAIT)))
    t.start()
    assert _until(lambda: srv.stats()["goaways_sent"] == 1)
    stub.held[0].set_result(torch.full((2,), 7.0))
    t.join(timeout=WAIT)
    assert drained == [True]
    assert np.array_equal(fut.result(timeout=WAIT),
                          np.full(2, 7.0, dtype=np.float32))
    assert c.client_stats()["goaways_seen"] == 1
    st = srv.stats()
    assert st["drains"] == 1 and st["goaways_sent"] == 1
    assert st["draining"] and st["connections_live"] == 0


def test_refused_past_max_connections():
    stub = _StubRouter()
    srv = net.NetServer(stub, host="127.0.0.1", port=0, max_connections=1)
    c1 = net.NetClient(srv.address, retry_budget=0)
    try:
        assert c1.ping(timeout=WAIT) == "pong"
        c2 = net.NetClient(srv.address, retry_budget=0)
        try:
            with pytest.raises((ServeOverloadedError,
                                errors.CommunicationError)):
                c2.ping(timeout=WAIT)
        finally:
            c2.close()
        assert srv.stats()["refused"] >= 1
    finally:
        c1.close()
        srv.close()


def test_the_server_span_parents_under_the_client_span(served):
    stub, srv, c = served
    telemetry.set_enabled(True)
    try:
        trace_mod.clear_finished()
        with trace_mod.span("client.op", force=True,
                            request_id="req-net-test-1") as sp_:
            ctx = sp_.context()
            c.submit("sketch_apply", A=np.ones(2)).result(timeout=WAIT)
        spans: list = []

        def found():
            spans[:] = [s for s in trace_mod.finished_spans()
                        if s.name == "net.serve"]
            return bool(spans)

        assert _until(found), "no net.serve span recorded"
        s = spans[0]
        assert s.trace_id == ctx.trace_id and s.parent_id == ctx.span_id
        assert s.request_id == ctx.request_id
        assert s.attrs["verb"] == "sketch_apply"
    finally:
        telemetry.set_enabled(False)


def test_stats_surfaces(served):
    stub, srv, c = served
    assert c.ping(timeout=WAIT) == "pong"
    ns = net.net_stats()
    assert ns["servers"] >= 1 and ns["requests"] >= 1
    assert ns["by_verb"]["ping"]["requests"] >= 1
    assert serve_stats()["net"]["requests"] >= 1
    st = c.stats(timeout=WAIT)
    assert st["stub"] is True and st["net"]["requests"] >= 1
    telemetry.set_enabled(True)
    try:
        text = telemetry.prometheus_text()
    finally:
        telemetry.set_enabled(False)
    assert "skylark_net_requests" in text


# -- across packages, and end to end on an executor ------------------------

@pytest.fixture(scope="module")
def executor_server():
    ex = MicrobatchExecutor(device="cpu", linger_us=500, max_batch=4)
    srv = net.NetServer(ex, host="127.0.0.1", port=0)
    yield ex, srv
    srv.close()
    ex.shutdown()


def test_a_reference_client_is_served_by_a_port_server(executor_server):
    ex, srv = executor_server
    A = np.random.default_rng(3).standard_normal((20, 64)).astype(np.float32)
    c = rclient.NetClient(srv.address, retry_budget=1, seed=0)
    try:
        assert c.ping(timeout=WAIT) == "pong"
        out = c.submit("sketch_apply",
                       transform=rsk.JLT(64, 16, RContext(seed=5)), A=A,
                       dimension=rsk.ROWWISE).result(timeout=WAIT)
    finally:
        c.close()
    want = ex.submit("sketch_apply", transform=psk.JLT(64, 16,
                                                       Context(seed=5)),
                     A=torch.from_numpy(A),
                     dimension=psk.ROWWISE).result(WAIT)
    assert isinstance(out, np.ndarray)
    assert torch.equal(torch.from_numpy(out), want)


def test_requests_over_the_wire_equal_in_process(executor_server):
    ex, srv = executor_server
    rng = np.random.default_rng(4)
    A = rng.standard_normal((96, 32)).astype(np.float32)
    X = rng.standard_normal((64, 8)).astype(np.float32)
    Y = rng.standard_normal((64, 1)).astype(np.float32)
    T = psk.CWT(96, 16, Context(seed=6))
    plan = dp.ShardPlan(kind="cwt", n=64, s_dim=16, d=8, seed=5, targets=1,
                        shard_rows=16)
    c = net.NetClient(srv.address, seed=0)
    try:
        got = c.submit("sketch_apply", transform=T, A=A,
                       dimension=psk.COLUMNWISE).result(timeout=WAIT)
        dist = c.submit("dist_sketch", plan=plan, X=X,
                        Y=Y).result(timeout=WAIT)
        st = c.stats(timeout=WAIT)
    finally:
        c.close()
    want = ex.submit("sketch_apply", transform=T, A=torch.from_numpy(A),
                     dimension=psk.COLUMNWISE).result(WAIT)
    assert torch.equal(torch.from_numpy(got), want)
    inproc = ex.submit_dist_sketch(plan, dp.ArraySource(X, Y)).result(WAIT)
    assert sorted(dist) == ["SX", "SY", "coverage", "degraded", "missing"]
    assert torch.equal(torch.from_numpy(dist["SX"]), inproc.SX)
    assert torch.equal(torch.from_numpy(dist["SY"]), inproc.SY)
    assert dist["coverage"] == 1.0 and not dist["degraded"]
    # the executor's stats cross the wire with the front door's block
    assert st["net"]["requests"] >= 2 and st["completed"] >= 1
