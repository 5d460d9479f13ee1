"""The port's shared-memory replica transport
(``libskylark_tpu_torch/fleet/shm.py``) against the reference's contract
(``tests/test_fleet_shm.py``), on the CPU.

Oracles:

- *codec exactness*: what rides a ring slot decodes bit-equal and in
  place (the decoded view maps the segment), and the pickle fallback
  (small, oversize, object or structured dtypes, an exhausted ring)
  carries the same values: transport choice never changes a result;
- *slot lifecycle*: collecting a decoded view releases its slot to the
  writer (the ack turnaround), exhaustion falls back to the pipe instead
  of blocking, and the fallback counters tell the truth;
- *segment lifecycle*: ``/dev/shm`` names exist only until the owner's
  unlink, so a SIGTERM'd or ``kill -9``'d attached peer leaks nothing;
- *no tensor on a pipe* (the port's departure, ROADMAP C28): an encoded
  payload holding CPU tensors (strided ones too) and numpy arrays holds
  no ``torch.Tensor``, nor does the pickle of any message; a tensor comes
  back as a tensor only where the receiver asks (``tensors=``), a
  bfloat16 tensor is refused at encode;
- *the reference's bytes*: a payload encoded by either package's
  transport decodes in the other's to the same arrays.

Leak checks count this process's segments (a name carries its creator's
pid): the test processes of a parallel run hold their own.

The process-replica tier (results through real children, shm on and
off, SIGTERM and ``kill -9``) is ``tests/test_torch_fleet_process.py``.
"""

from __future__ import annotations

import gc
import json
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from libskylark_tpu.fleet import shm as rshm
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.fleet import shm as pshm
from libskylark_tpu_torch.fleet.shm import (HostTensor, ShmRef,
                                            ShmTransport, shm_entries)

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/dev/shm"),
    reason="POSIX shared memory filesystem not available")


def _mine():
    """This process's live segments (other test processes may hold
    theirs)."""
    return shm_entries(pid=os.getpid())


@pytest.fixture(autouse=True)
def no_leaked_segments():
    """Every test ends with no live segment of this process."""
    yield
    gc.collect()
    assert _mine() == [], f"leaked /dev/shm entries: {_mine()}"


def _transport(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("slot_bytes", 1 << 16)
    kw.setdefault("min_bytes", 64)
    return ShmTransport.create("t", **kw)


def _pair(**kw):
    t = _transport(**kw)
    return t, ShmTransport.attach(t.child_spec())


def _tensors(obj) -> list:
    """Every torch.Tensor in a payload's containers, at any depth."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, HostTensor):
            walk(x.array)

    walk(obj)
    return out


class _Holder:
    """An object carrying a tensor outside any container."""

    def __init__(self, t):
        self.t = t


class TestRingCodec:
    def test_roundtrip_bit_equal_and_in_place(self):
        t, peer = _pair()
        try:
            A = np.arange(6000, dtype=np.float32).reshape(60, 100)
            enc, claimed = t.encode({"A": A, "x": 7})
            assert isinstance(enc["A"], ShmRef)
            assert enc["x"] == 7 and len(claimed) == 1
            dec = peer.decode(enc)
            assert np.array_equal(dec["A"], A)
            assert str(dec["A"].dtype) == "float32"
            assert not dec["A"].flags.owndata
            assert not dec["A"].flags.writeable
        finally:
            t.destroy()
            peer.destroy()

    def test_small_arrays_stay_inline(self):
        t, peer = _pair(min_bytes=1 << 20)
        try:
            A = np.ones((8, 8), np.float32)
            enc, claimed = t.encode({"A": A})
            assert isinstance(enc["A"], np.ndarray) and claimed == []
            assert np.array_equal(peer.decode(enc)["A"], A)
        finally:
            t.destroy()
            peer.destroy()

    def test_oversize_object_structured_fall_back_by_reason(self):
        t, peer = _pair(slot_bytes=1 << 10, min_bytes=8)
        try:
            big = np.zeros(4096, np.float64)
            obj = np.array([object()] * 8, dtype=object)
            rec = np.zeros(64, dtype=[("a", "<f4"), ("b", "<i4")])
            enc, claimed = t.encode({"big": big, "obj": obj, "rec": rec})
            assert all(isinstance(enc[k], np.ndarray)
                       for k in ("big", "obj", "rec"))
            assert claimed == []
            assert t.tx.fallback_reasons["oversize"] == 1
            assert t.tx.fallback_reasons["dtype"] == 2
            assert np.array_equal(peer.decode(enc)["rec"], rec)
        finally:
            t.destroy()
            peer.destroy()

    def test_torn_header_rejected_and_slots_recovered(self):
        t, peer = _pair()
        try:
            enc, claimed = t.encode(
                {"A": np.arange(1024, dtype=np.float32)})
            assert len(claimed) == 1
            enc["A"].dtype = "not-a-dtype"
            with pytest.raises(Exception):
                peer.decode(enc)
            peer.recover(enc)
            t.release(peer.drain_acks())
            assert t.tx.free_slots() == t.tx.slots
        finally:
            t.destroy()
            peer.destroy()

    def test_decoded_arrays_uniformly_read_only(self):
        t, peer = _pair()
        try:
            enc, _ = t.encode({"big": np.arange(1024, dtype=np.float32),
                               "small": np.arange(4, dtype=np.float32)})
            dec = peer.decode(enc)
            assert not dec["big"].flags.writeable
            assert not dec["small"].flags.writeable
        finally:
            t.destroy()
            peer.destroy()

    def test_exhaustion_degrades_then_ack_recovers(self):
        t, peer = _pair(slots=2)
        try:
            arrs = [np.full(128, i, np.float32) for i in range(4)]
            enc, _ = t.encode({"a": arrs})
            kinds = [type(v).__name__ for v in enc["a"]]
            assert kinds.count("ShmRef") == 2
            assert kinds.count("ndarray") == 2
            assert t.tx.fallbacks == 2
            dec = peer.decode(enc)
            for got, want in zip(dec["a"], arrs):
                assert np.array_equal(got, want)
            del dec
            gc.collect()
            t.release(peer.drain_acks())
            assert t.tx.free_slots() == 2
            enc2, _ = t.encode({"b": arrs[0]})
            assert isinstance(enc2["b"], ShmRef)
        finally:
            t.destroy()
            peer.destroy()

    def test_noncontiguous_source(self):
        t, peer = _pair()
        try:
            view = np.arange(400, dtype=np.float32).reshape(20, 20)[::2,
                                                                  1::3]
            enc, _ = t.encode({"v": view})
            assert isinstance(enc["v"], ShmRef)
            assert np.array_equal(peer.decode(enc)["v"], view)
        finally:
            t.destroy()
            peer.destroy()

    def test_shm_vs_inline_identical(self):
        t, peer = _pair()
        try:
            A = np.random.default_rng(0).standard_normal(
                (50, 70)).astype(np.float32)
            via_ring, _ = t.encode({"A": A})
            assert isinstance(via_ring["A"], ShmRef)
            dec_ring = peer.decode(via_ring)["A"]
            dec_inline = peer.decode({"A": A.copy()})["A"]
            assert dec_ring.tobytes() == dec_inline.tobytes()
        finally:
            t.destroy()
            peer.destroy()


class TestTensors:
    def test_payload_holds_no_tensor(self):
        """CPU tensors, a transposed and a sliced one among them, and
        numpy arrays: the encoded payload and the pickle of the message
        hold numpy arrays and headers only."""
        t, peer = _pair(slots=2)
        try:
            base = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
            payload = {
                "A": base,                        # rides a slot
                "At": base.T,                     # strided, rides a slot
                "S": base[::3, 1::2],             # strided, ring full
                "small": torch.ones(3),           # under min_bytes
                "np": np.arange(512, dtype=np.float64),
                "nested": [torch.zeros(2, 2), {"x": base[:2]}],
            }
            enc, _ = t.encode(payload)
            assert _tensors(enc) == []
            data = pshm.pipe_dumps(("submit", 1, "sketch_apply", enc))
            msg = pickle.loads(data)
            assert _tensors(msg) == []
            # a tensor inside another object is made a host array too
            held = pickle.loads(pshm.pipe_dumps(_Holder(base)))
            assert isinstance(held.t, HostTensor)
            assert np.array_equal(held.t.array, base.numpy())
            # what left as a tensor comes back as a tensor where asked
            dec = peer.decode(msg[3], tensors=torch.from_numpy)
            for key in ("A", "At", "S", "small"):
                assert isinstance(dec[key], torch.Tensor)
                assert torch.equal(dec[key], payload[key])
            assert isinstance(dec["np"], np.ndarray)
            assert torch.equal(dec["nested"][1]["x"], base[:2])
            # and as host arrays where not
            plain = peer.decode(pickle.loads(data)[3])
            assert isinstance(plain["At"], np.ndarray)
            assert np.array_equal(plain["At"], base.T.numpy())
        finally:
            t.destroy()
            peer.destroy()

    def test_to_wire_without_a_ring(self):
        payload = {"A": torch.arange(6.0).reshape(2, 3).T,
                   "b": np.ones(2), "k": 3}
        wire = pshm.to_wire(payload)
        assert _tensors(wire) == []
        back = pshm.from_wire(pickle.loads(pshm.pipe_dumps(wire)),
                              tensors=torch.from_numpy)
        assert torch.equal(back["A"], payload["A"])
        assert isinstance(back["b"], np.ndarray) and back["k"] == 3

    def test_bfloat16_refused_at_encode(self):
        t = _transport()
        try:
            with pytest.raises(errors.UnsupportedError):
                t.encode({"A": torch.ones(64, 64, dtype=torch.bfloat16)})
            with pytest.raises(errors.UnsupportedError):
                pshm.to_wire({"A": torch.ones(4, dtype=torch.bfloat16)})
        finally:
            t.destroy()


class TestAcrossPackages:
    def test_either_package_decodes_the_others_slots(self):
        """The two packages' rings, headers and segments are one format: a
        reference peer attached to the port's segments decodes what the
        port wrote, and the port decodes what the reference peer wrote
        (the reference only attaches: its leak check never sees a name
        of this test)."""
        A = np.random.default_rng(1).standard_normal(
            (40, 90)).astype(np.float32)
        pt = _transport()
        rp = rshm.ShmTransport.attach(pt.child_spec())
        try:
            enc, _ = pt.encode({"A": A})
            ref = enc["A"]
            got = rp.decode({"A": rshm.ShmRef(ref.slot, ref.shape,
                                               ref.dtype, ref.nbytes)})
            assert got["A"].tobytes() == A.tobytes()
            renc, _ = rp.encode({"A": A.T.copy()})
            r = renc["A"]
            back = pt.decode({"A": ShmRef(r.slot, r.shape, r.dtype,
                                          r.nbytes)})
            assert back["A"].tobytes() == A.T.tobytes()
            # the port's names are not the reference's
            assert not pt.child_spec()["p2c"].startswith(rshm.SHM_PREFIX)
            del got, back
        finally:
            pt.destroy()
            rp.destroy()


# a peer that attaches both segments by name and sleeps: the boot window's
# other side, transport-level only (no torch import)
_ATTACHER = (
    "import json, sys, time\n"
    "from multiprocessing import resource_tracker, shared_memory\n"
    "spec = json.loads(sys.argv[1])\n"
    "segs = [shared_memory.SharedMemory(name=spec[k])\n"
    "        for k in ('p2c', 'c2p')]\n"
    "for s in segs:\n"
    "    resource_tracker.unregister(s._name, 'shared_memory')\n"
    "print('attached', flush=True)\n"
    "time.sleep(60)\n")


def _attacher(spec):
    proc = subprocess.Popen([sys.executable, "-c", _ATTACHER,
                             json.dumps(spec)],
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "attached"
    return proc


class TestSegmentLifecycle:
    def test_unlink_removes_names_views_stay_valid(self):
        t, peer = _pair()
        A = np.arange(256, dtype=np.float32)
        enc, _ = t.encode({"A": A})
        dec = peer.decode(enc)
        assert len(_mine()) == 2
        t.unlink()
        assert _mine() == []
        assert np.array_equal(dec["A"], A)
        del dec
        t.destroy()
        peer.destroy()

    def test_destroy_idempotent(self):
        t = _transport()
        t.destroy()
        t.destroy()
        assert _mine() == []

    @pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL])
    def test_killed_attached_child_leaks_nothing(self, sig):
        t = _transport()
        proc = _attacher(t.child_spec())
        try:
            t.unlink()                    # the boot handshake's end
            assert _mine() == []
            proc.send_signal(sig)
            proc.wait(timeout=30)
            assert _mine() == []
        finally:
            if proc.poll() is None:
                proc.kill()
            t.destroy()

    def test_child_dead_before_unlink_parent_destroy_cleans(self):
        t = _transport()
        proc = _attacher(t.child_spec())
        try:
            proc.kill()
            proc.wait(timeout=30)
            assert len(_mine()) == 2          # still in the boot window
            t.destroy()
            assert _mine() == []
        finally:
            if proc.poll() is None:
                proc.kill()
