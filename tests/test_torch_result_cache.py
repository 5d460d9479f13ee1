"""The port's result cache, single-flight and residency
(``engine/resultcache.py``) against the JAX package's, on the CPU.

Exact throughout: digests are the reference's hex, eviction sequences,
``stats()`` counts and the DEGRADED shed bounds are equal, and no value
handed out aliases the cache (a caller's in-place write never reaches
another caller).
"""

from concurrent.futures import Future

import numpy as np
import pytest
import torch

import torch_serve_cases as cases
from libskylark_tpu.engine import resultcache as jrc
from libskylark_tpu.engine import serve as jserve
from libskylark_tpu_torch.engine import resultcache as rc
from libskylark_tpu_torch.engine import serve


@pytest.mark.parametrize("variant", ["plain", "strided", "tensor",
                                     "big_seed"])
@pytest.mark.parametrize("endpoint", cases.ENDPOINTS)
def test_request_digest_is_the_reference_hex(endpoint, variant):
    jk = cases.case(endpoint, "ref", variant)
    pk = cases.case(endpoint, "port", variant)
    want = jserve.request_digest(
        endpoint, jserve.derive_request(endpoint, **jk), jk)
    got = serve.request_digest(
        endpoint, serve.derive_request(endpoint, **pk), pk)
    assert got == want


def test_seed_and_bytes_change_the_request_digest():
    kw = cases.case("solve_l2_sketched", "port")
    d0 = serve.request_digest("solve_l2_sketched",
                              serve.derive_request("solve_l2_sketched", **kw),
                              kw)
    other = cases.case("solve_l2_sketched", "port", seed=1)
    kw2 = dict(kw, transform=other["transform"])
    kw3 = dict(kw, B=kw["B"] + 1.0)
    for k in (kw2, kw3):
        assert serve.request_digest(
            "solve_l2_sketched",
            serve.derive_request("solve_l2_sketched", **k), k) != d0


def _parts(side):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 8)).astype(np.float32)
    parts = [("a", a), ("strided", a[:, ::2]), ("t", a.T),
             ("i64", np.arange(9, dtype=np.int64).reshape(3, 3)),
             ("u32", np.array([2**32 - 1, 5], np.uint32)),
             ("f64", np.float64(0.25)), ("bytes", b"\x00\x01xyz"),
             ("str", "hello"), ("none", None),
             ("bool", np.array([True, False]))]
    if side == "port":
        # tensors hash as the numpy arrays of the same bytes
        parts[0] = ("a", torch.from_numpy(a))
        parts[2] = ("t", torch.from_numpy(a).T)
    return parts


def test_operand_digest_is_the_reference_hex():
    statics = ("sketch_apply", "JLT", "Normal()", 16, True, "float32",
               (8, 64))
    assert (rc.operand_digest(_parts("port"), statics)
            == jrc.operand_digest(_parts("ref"), statics))
    assert rc.operand_digest([("A", None)]) == jrc.operand_digest(
        [("A", None)])
    assert rc.operand_digest([]) == jrc.operand_digest([])
    # framing: shape and dtype are part of the address
    a = np.arange(12, dtype=np.float32)
    assert rc.operand_digest([("A", a)]) != rc.operand_digest(
        [("A", a.reshape(3, 4))])
    assert rc.operand_digest([("A", a)]) != rc.operand_digest(
        [("A", a.view(np.int32))])


def test_operand_ref_forms():
    d = rc.operand_digest([("A", np.ones(3, np.float32))])
    ref = rc.OperandRef(d)
    for mod in (rc, jrc):
        assert mod.is_ref(ref if mod is rc else jrc.OperandRef(d))
        assert mod.is_ref("ref:" + d) and not mod.is_ref(d)
        assert mod.as_ref("ref:" + d).digest == d
    assert rc.as_ref(ref) is ref


def _value(side, nbytes):
    n = nbytes // 4
    if side == "port":
        return torch.zeros(n, dtype=torch.float32)
    return np.zeros(n, np.float32)


# (op, key, class, nbytes)
SCRIPT = [("put", "a", "interactive", 400), ("put", "b", "interactive", 400),
          ("put", "c", "best_effort", 100), ("get", "a", "standard", 0),
          ("put", "d", "interactive", 300), ("get", "a", "interactive", 0),
          ("get", "b", "best_effort", 0), ("put", "e", "best_effort", 200),
          ("put", "f", "best_effort", 120), ("get", "c", "interactive", 0),
          ("put", "g", "standard", 5000), ("put", "h", "standard", 300),
          ("put", "i", "standard", 300), ("get", "h", "standard", 0),
          ("put", "b", "interactive", 400), ("get", "zz", "standard", 0),
          ("put", "j", "interactive", 900), ("get", "d", "interactive", 0)]


def _run_script(side):
    mod = rc if side == "port" else jrc
    cache = mod.ResultCache("t", max_bytes=2000)
    trace = []
    for op, key, cls, nbytes in SCRIPT:
        if op == "put":
            val = _value(side, nbytes)
            if side == "ref":
                val = jrc.freeze_result(val)
            trace.append(cache.put(key, cls, val))
        else:
            trace.append(cache.lookup(key, cls) is not mod.MISS)
    present = [k for k in "abcdefghij"
               if cache.lookup(k, "standard") is not mod.MISS]
    return trace, present, cache.stats()


def test_eviction_sequence_and_stats_equal_the_reference():
    got, want = _run_script("port"), _run_script("ref")
    assert got[0] == want[0]
    assert got[1] == want[1]
    stats = dict(got[2])
    assert stats.pop("digest_d2h_bytes") == 0
    assert stats == want[2]


def _flight_stats(mod, leader_fails):
    cache = mod.ResultCache("f", max_bytes=1 << 20)
    leader = Future()
    fl = cache.lead_flight("k", "standard", leader)
    followers = [cache.join_flight("k", "interactive") for _ in range(3)]
    if leader_fails:
        leader.set_exception(ValueError("boom"))
    else:
        leader.set_result(torch.arange(4.0) if mod is rc
                          else np.arange(4, dtype=np.float32))
    cache.settle_flight(fl, leader)
    late = cache.join_flight("k", "standard")
    stats = cache.stats()
    stats.pop("digest_d2h_bytes", None)
    return followers, late, stats


@pytest.mark.parametrize("leader_fails", [False, True])
def test_single_flight_fan_out_equals_the_reference(leader_fails):
    got, late, stats = _flight_stats(rc, leader_fails)
    want, jlate, jstats = _flight_stats(jrc, leader_fails)
    assert late is None and jlate is None
    assert stats == jstats
    for f, j in zip(got, want):
        if leader_fails:
            assert isinstance(f.exception(timeout=1), ValueError)
            assert isinstance(j.exception(timeout=1), ValueError)
        else:
            np.testing.assert_array_equal(f.result(timeout=1).numpy(),
                                          j.result(timeout=1))
    if not leader_fails:
        # every follower got its own tensor, none the cached one
        ptrs = {f.result().data_ptr() for f in got}
        assert len(ptrs) == len(got)


def test_claim_is_one_flush_for_concurrent_identical_requests():
    cache = rc.ResultCache("c", max_bytes=1 << 20)
    lead = Future()
    kind, fl = cache.claim("k", "standard", lead)
    assert kind == "lead"
    kind2, f2 = cache.claim("k", "standard", Future())
    assert kind2 == "follow"
    fl.frozen = rc.freeze_result(torch.ones(3))
    lead.set_result(torch.ones(3))
    cache.settle_flight(fl, lead)
    kind3, v = cache.claim("k", "best_effort", Future())
    assert kind3 == "hit" and torch.equal(v, torch.ones(3))
    st = cache.stats()
    assert (st["misses"], st["single_flight_coalesced"], st["hits"]) == (
        1, 1, 1)
    assert torch.equal(f2.result(timeout=1), torch.ones(3))


def test_abort_fails_every_follower():
    for mod in (rc, jrc):
        cache = mod.ResultCache("a")
        fl = cache.lead_flight("k", "standard", Future())
        fs = [cache.join_flight("k", "standard") for _ in range(2)]
        cache.abort_flight(fl, KeyError("gone"))
        assert all(isinstance(f.exception(timeout=1), KeyError) for f in fs)


def test_standalone_single_flight_equals_the_reference():
    out = []
    for mod in (rc, jrc):
        sf = mod.SingleFlight("r")
        lead = Future()
        fl = sf.lead("k", "standard")
        fs = [sf.join("k", "interactive") for _ in range(2)]
        lead.set_result(np.arange(3.0))
        sf.settle(fl, lead)
        assert all(np.array_equal(f.result(1), np.arange(3.0)) for f in fs)
        out.append(sf.stats())
    assert out[0] == out[1]


def test_freeze_and_handout_never_alias():
    buf = torch.arange(24.0).reshape(2, 3, 4)
    view = buf[1, :, :2]
    frozen = rc.freeze_result((view, 1.5, np.arange(3)))
    assert frozen[0].is_contiguous()
    assert frozen[0].untyped_storage().nbytes() == view.numel() * 4
    assert frozen[0].data_ptr() != view.data_ptr()
    assert not frozen[2].flags.writeable
    out = rc.handout(frozen)
    assert out[0].data_ptr() != frozen[0].data_ptr()
    out[0].add_(1.0)
    assert torch.equal(frozen[0], view)


def test_merge_cache_blocks_equals_the_reference():
    blocks = []
    for i in range(2):
        trace, present, st = _run_script("ref")
        st["residency"] = {"resident_operands": i, "pinned_results": 1}
        blocks.append(st)
    want = jrc.merge_cache_blocks(blocks + [None])
    got = rc.merge_cache_blocks(blocks + [None])
    assert got.pop("digest_d2h_bytes") == 0
    assert got == want


def test_residency_pins_once_and_refuses_other_bytes():
    table = rc.ResidencyTable("r", device="cpu")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    d = rc.operand_digest([("A", a)])
    assert d == jrc.operand_digest([("A", a)])
    table.pin(d, a)
    table.pin(d, a.copy())
    assert table.stats()["uploads"] == 1
    assert torch.equal(table.resolve(d), torch.from_numpy(a))
    assert np.array_equal(table.host(d), a)
    with pytest.raises(ValueError):
        table.pin(d, a + 1)
    table.pin_result("r1", torch.ones(2), owner=d)
    assert table.result("r1") is not None
    assert table.unpin(d) and table.result("r1") is None
    with pytest.raises(KeyError):
        table.resolve(d)


@pytest.mark.parametrize("max_queue,shed_fraction", [(1024, 0.25), (64, 0.5),
                                                     (10, 1.0), (3, 0.1)])
def test_class_shed_bound_equals_the_reference(max_queue, shed_fraction,
                                               monkeypatch):
    monkeypatch.setenv("SKYLARK_QOS_SHED_BEST_EFFORT", "0.2")
    ex = serve.MicrobatchExecutor(max_queue=max_queue, device="cpu",
                                  shed_fraction=shed_fraction)
    jex = jserve.MicrobatchExecutor(max_queue=max_queue,
                                    shed_fraction=shed_fraction)
    try:
        for cls in ("interactive", "standard", "best_effort"):
            assert ex._class_shed_bound(cls) == jex._class_shed_bound(cls)
    finally:
        ex.shutdown()
        jex.shutdown()
