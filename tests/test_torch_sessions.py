"""The port's stateful sketch sessions (sessions/) and the executor's
session verbs against the JAX package's, on the CPU.

The same seeded batches go through both packages' registries:
- each kind finalizes as the reference's: ``cwt`` ``torch.equal``;
  ``jlt``, ``srht`` and ``isvd`` within 1e-5 relative (a float32
  matmul in another order; the singular vectors up to sign); ``krr``
  within 1e-5 with B1-cos's plain version in ``f32`` and 1e-4 in the
  default bf16x3 (ROADMAP C9);
- the ``SKYJRNL2`` journals are byte-equal for the same appends;
- state carried across: a ``cwt`` session the reference's registry
  journaled and checkpointed, resumed by the port's registry, ends
  ``torch.equal`` to the reference's finished session (and the other
  way round);
- ``dtype="float64"`` sessions hold float32 accumulators, as the
  reference's do with jax's 64-bit mode off, and journal float64 bytes;
- the registry's semantics: idempotent and gap-refusing sequence
  numbers, the extent bound, TTL eviction, torn-tail recovery, the
  rollback and poisoned journal, lease fencing, the private default
  root, crash replay and checkpoint-bounded replay;
- the executor: open/append/finalize futures, DRAINING refuses,
  DEGRADED sheds (``session_shed``), an expired deadline resolves
  without a journal write, a drain checkpoints and a peer resumes.
"""

import os
import stat

import numpy as np
import pytest
import torch

from libskylark_tpu import sessions as rs
from libskylark_tpu_torch import engine
from libskylark_tpu_torch import sessions as ps
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.engine.serve import ServeOverloadedError
from libskylark_tpu_torch.sessions import journal as pj
from libskylark_tpu_torch.sketch import params

N, D, S = 512, 6, 32


def _data(seed=0, n=N, targets=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((n, targets)).astype(np.float32))


SPECS = {"cwt": {"targets": 2}, "jlt": {"targets": 2},
         "srht": {"targets": 2}, "isvd": {"k": 4},
         "krr": {"targets": 2, "sigma": 2.5, "lam": 0.1}}


def _spec(pkg, kind, **kw):
    return pkg.SessionSpec(**{"kind": kind, "n": N, "s_dim": S, "d": D,
                              "seed": 4, **SPECS[kind], **kw})


def _port_registry(path, **kw):
    return ps.SessionRegistry(directory=str(path), device="cpu", **kw)


def _feed(reg, sid, X, Y, kind, lo=0, hi=N, step=100, seq0=0):
    targets = SPECS[kind].get("targets", 0)
    for i, a in enumerate(range(lo, hi, step)):
        b = min(a + step, hi)
        reg.append(sid, X[a:b], Y[a:b] if targets else None,
                   seq=seq0 + i + 1)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_each_kind_matches_the_reference(tmp_path, kind):
    X, Y = _data()
    R = rs.SessionRegistry(directory=str(tmp_path / "r"))
    P = _port_registry(tmp_path / "p")
    rid = R.open(_spec(rs, kind), session_id="s1")
    pid = P.open(_spec(ps, kind), session_id="s1")
    # power-of-two batches: the reference's SRHT fold compiles one program
    # per block size
    _feed(R, rid, X, Y, kind, step=128)
    prec = params.get_pallas_precision()
    try:
        params.set_pallas_precision("f32")      # B1-cos's f32 regime
        _feed(P, pid, X, Y, kind, step=128)
    finally:
        params.set_pallas_precision(prec)
    assert (open(tmp_path / "r" / "s1.journal", "rb").read()
            == open(tmp_path / "p" / "s1.journal", "rb").read())
    want, got = R.finalize(rid), P.finalize(pid)
    assert got["rows"] == want["rows"] == N
    if kind == "cwt":
        for k in ("SX", "SY"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    elif kind == "isvd":
        assert _rel(got["singular_values"], want["singular_values"]) <= 1e-5
        sign = np.sign(np.sum(got["Vt"].numpy() * np.asarray(want["Vt"]),
                              axis=1, keepdims=True))
        assert _rel(got["Vt"].numpy() * sign, want["Vt"]) <= 1e-5
    elif kind == "krr":
        assert _rel(got["coef"], want["coef"]) <= 1e-5
    else:
        for k in ("SX", "SY"):
            assert _rel(got[k], want[k]) <= 1e-5


def test_krr_in_the_default_regime(tmp_path):
    X, Y = _data()
    R = rs.SessionRegistry(directory=str(tmp_path / "r"))
    P = _port_registry(tmp_path / "p")
    rid = R.open(_spec(rs, "krr"))
    pid = P.open(_spec(ps, "krr"))
    _feed(R, rid, X, Y, "krr")
    _feed(P, pid, X, Y, "krr")
    assert params.get_pallas_precision() == "bf16x3"
    assert _rel(P.finalize(pid)["coef"], R.finalize(rid)["coef"]) <= 1e-4


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cwt_state_carries_across_packages(tmp_path, writer):
    """Half a stream appended and checkpointed by one package's registry,
    two more appends journaled only, then resumed by the other's registry
    from checkpoint plus journal tail: the finished session is
    ``torch.equal`` to an uninterrupted one."""
    X, Y = _data()
    W = (rs.SessionRegistry(directory=str(tmp_path)) if writer == "reference"
         else _port_registry(tmp_path))
    sid = W.open(_spec(rs if writer == "reference" else ps, "cwt"),
                 session_id="carry")
    _feed(W, sid, X, Y, "cwt", 0, 200)
    W.checkpoint(sid)
    _feed(W, sid, X, Y, "cwt", 200, 400, seq0=2)
    W.close()
    other = (_port_registry(tmp_path) if writer == "reference"
             else rs.SessionRegistry(directory=str(tmp_path)))
    assert other.rows(sid) == (4, 400)
    assert other.stats()["replayed_records"] == 2
    _feed(other, sid, X, Y, "cwt", 400, N, seq0=4)
    got = other.finalize(sid)
    U = _port_registry(tmp_path / "u")
    uid = U.open(_spec(ps, "cwt"))
    _feed(U, uid, X, Y, "cwt")
    want = U.finalize(uid)
    for k in ("SX", "SY"):
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy())


def test_float64_sessions_compute_in_float32(tmp_path):
    X, Y = _data()
    R = rs.SessionRegistry(directory=str(tmp_path / "r"))
    P = _port_registry(tmp_path / "p")
    rid = R.open(_spec(rs, "cwt", dtype="float64"), session_id="f")
    pid = P.open(_spec(ps, "cwt", dtype="float64"), session_id="f")
    X64 = X.astype(np.float64) / 3.0
    _feed(R, rid, X64, Y, "cwt")
    _feed(P, pid, X64, Y, "cwt")
    recs, _ = pj.scan(str(tmp_path / "p" / "f.journal"))
    assert recs[0][1]["X"].dtype == np.float64
    assert P.describe(pid)["rows"] == N
    want, got = R.finalize(rid), P.finalize(pid)
    assert got["SX"].dtype == torch.float32
    np.testing.assert_array_equal(got["SX"].numpy(), np.asarray(want["SX"]))


def test_train_kind_is_not_ported(tmp_path):
    """A ``kind="train"`` spec builds a TrainSessionState over its
    operand sidecar; without the sidecar the open refuses and leaves
    nothing on disk."""
    from libskylark_tpu_torch.train import TrainSessionState
    from libskylark_tpu_torch.train import state as tstate

    P = _port_registry(tmp_path)
    spec = ps.SessionSpec(kind="train", n=4, s_dim=2, d=2,
                          extra={"solver": "lsqr"})
    with pytest.raises(errors.SessionEvictedError, match="sidecar"):
        P.open(spec, session_id="t")
    assert os.listdir(tmp_path) == []
    rng = np.random.default_rng(0)
    tstate.save_operands(str(tmp_path), "t", {
        "A": rng.standard_normal((12, 3)).astype(np.float32),
        "B": rng.standard_normal(12).astype(np.float32)})
    state = ps.state.make_state(spec, str(tmp_path), "t", device="cpu")
    assert isinstance(state, TrainSessionState)
    assert P.open(spec, session_id="t") == "t"
    assert P.append("t", np.asarray([[2]]), seq=1) == (1, 2)
    assert P.describe("t")["info"]["iterations"] == 2


def test_sequence_numbers_and_the_extent(tmp_path):
    X, Y = _data()
    P = _port_registry(tmp_path)
    sid = P.open(_spec(ps, "cwt"))
    assert P.append(sid, X[:10], Y[:10], seq=1) == (1, 10)
    assert P.append(sid, X[:10], Y[:10], seq=1) == (1, 10)   # duplicate
    with pytest.raises(errors.InvalidParametersError, match="gap"):
        P.append(sid, X[:10], Y[:10], seq=3)
    with pytest.raises(errors.InvalidParametersError, match="extent"):
        P.append(sid, np.zeros((N, D)), np.zeros((N, 2)))
    with pytest.raises(errors.InvalidParametersError, match="needs Y"):
        P.append(sid, X[:3])
    assert P.stats()["duplicates"] == 1
    with pytest.raises(errors.InvalidParametersError, match="exists"):
        P.open(_spec(ps, "cwt"), session_id=sid)
    with pytest.raises(errors.InvalidParametersError, match="must match"):
        P.open(_spec(ps, "cwt"), session_id="../evil")
    P.finalize(sid)
    with pytest.raises(errors.SessionEvictedError):
        P.append(sid, X[:1], Y[:1])
    with pytest.raises(errors.SessionEvictedError):
        P.rows("never-opened")


def test_ttl_eviction(tmp_path, monkeypatch):
    X, Y = _data()
    P = _port_registry(tmp_path)
    sid = P.open(_spec(ps, "cwt", ttl_s=60.0))
    P.append(sid, X[:5], Y[:5])
    import time as _time

    real = _time.monotonic
    monkeypatch.setattr("libskylark_tpu_torch.sessions.registry.time."
                        "monotonic", lambda: real() + 100.0)
    with pytest.raises(errors.SessionEvictedError, match="TTL"):
        P.append(sid, X[5:6], Y[5:6])
    assert P.stats()["evicted"] == 1
    assert not os.path.exists(tmp_path / f"{sid}.journal")


def test_crash_replay_and_torn_tail(tmp_path):
    X, Y = _data()
    P = _port_registry(tmp_path)
    sid = P.open(_spec(ps, "cwt"), session_id="crash")
    _feed(P, sid, X, Y, "cwt", 0, 300)
    # a crash: no checkpoint, no close; then a torn final record
    with open(tmp_path / "crash.journal", "ab") as fh:
        fh.write(b"\x10\x00\x00\x00garbage")
    Q = _port_registry(tmp_path)
    assert Q.rows(sid) == (3, 300)
    assert Q.stats()["replayed_records"] == 3
    _feed(Q, sid, X, Y, "cwt", 300, N, seq0=3)
    got = Q.finalize(sid)
    U = _port_registry(tmp_path / "u")
    uid = U.open(_spec(ps, "cwt"))
    _feed(U, uid, X, Y, "cwt")
    assert torch.equal(got["SX"], U.finalize(uid)["SX"])
    with pytest.raises(errors.SessionEvictedError, match="fenced"):
        P.append(sid, X[:1], Y[:1], seq=9)


def test_checkpoint_bounds_replay_and_fencing(tmp_path):
    X, Y = _data()
    A = _port_registry(tmp_path)
    sid = A.open(_spec(ps, "jlt"))
    _feed(A, sid, X, Y, "jlt", 0, 200)
    A.checkpoint_all()
    B = _port_registry(tmp_path)
    assert B.rows(sid) == (2, 200)
    assert B.stats()["replayed_records"] == 0
    assert B.stats()["resumed"] == 1
    # the stale owner is fenced: no append, no checkpoint over B's state
    with pytest.raises(errors.SessionEvictedError, match="fenced"):
        A.append(sid, X[200:210], Y[200:210], seq=3)
    A.checkpoint(sid)          # resumes it back from disk, fencing B
    with pytest.raises(errors.SessionEvictedError, match="fenced"):
        B.append(sid, X[200:210], Y[200:210], seq=3)
    assert A.stats()["fenced"] == 1 and B.stats()["fenced"] == 1


def test_journal_rollback_and_poison(tmp_path, monkeypatch):
    j = pj.SessionJournal.create(str(tmp_path / "j"), fsync_every=1)
    j.append(1, {"X": np.ones((2, 3), np.float32)})
    size = os.path.getsize(tmp_path / "j")
    real = j._fh.write

    def short(b):
        real(b[:7])
        return 7

    monkeypatch.setattr(j._fh, "write", short, raising=False)
    with pytest.raises(errors.IOError_, match="short write"):
        j.append(2, {"X": np.ones((2, 3), np.float32)})
    assert os.path.getsize(tmp_path / "j") == size

    def fail_truncate(n):
        raise OSError("read-only")

    monkeypatch.setattr(j._fh, "truncate", fail_truncate, raising=False)
    with pytest.raises(errors.IOError_):
        j.append(2, {"X": np.ones((2, 3), np.float32)})
    with pytest.raises(errors.IOError_, match="refused"):
        j.append(2, {"X": np.ones((2, 3), np.float32)})
    records, _ = pj.scan(str(tmp_path / "j"))
    assert [s for s, _ in records] == [1]
    with open(tmp_path / "bad", "wb") as fh:
        fh.write(b"NOTAJRNL")
    with pytest.raises(errors.IOError_, match="bad magic"):
        pj.scan(str(tmp_path / "bad"))


def test_default_root_is_private(tmp_path, monkeypatch):
    monkeypatch.delenv("SKYLARK_SESSION_DIR", raising=False)
    monkeypatch.setattr("tempfile.gettempdir", lambda: str(tmp_path))
    root = ps.default_session_dir()
    assert root.startswith(str(tmp_path))
    P = ps.SessionRegistry(device="cpu")
    assert P.directory == root
    assert stat.S_IMODE(os.stat(root).st_mode) == 0o700
    os.rmdir(root)
    os.symlink(str(tmp_path), root)
    with pytest.raises(errors.IOError_, match="symlink"):
        ps.SessionRegistry(device="cpu")


# -- the executor's verbs -------------------------------------------------


def test_executor_session_verbs(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYLARK_SESSION_DIR", str(tmp_path))
    X, Y = _data()
    ex = engine.MicrobatchExecutor(device="cpu", name="ex-a")
    try:
        sid = ex.open_sketch_session("cwt", n=N, s_dim=S, d=D, seed=4,
                                     targets=2)
        assert ex.session_append(sid, X[:100], Y[:100], seq=1).result() \
            == (1, 100)
        f = ex.session_append(sid, X[100:200], Y[100:200], seq=2,
                              deadline=-1.0)
        with pytest.raises(ServeOverloadedError, match="deadline"):
            f.result()
        assert ex.sessions.rows(sid) == (1, 100)
        monkeypatch.setattr(ex, "_is_degraded", lambda: True)
        with pytest.raises(ServeOverloadedError, match="DEGRADED"):
            ex.session_append(sid, X[100:200], Y[100:200], seq=2).result()
        monkeypatch.undo()
        monkeypatch.setenv("SKYLARK_SESSION_DIR", str(tmp_path))
        st = ex.stats()
        assert st["session_shed"] == 1 and st["sessions"]["appends"] == 1
        with pytest.raises(errors.SessionEvictedError):
            ex.session_append("nope", X[:1], Y[:1]).result()
        assert ex.drain(timeout=5.0)
    finally:
        ex.shutdown()
    assert os.path.exists(tmp_path / f"{sid}.ckpt.npz")
    with pytest.raises(ServeOverloadedError):
        ex.session_append(sid, X[:1], Y[:1]).result()
    peer = engine.MicrobatchExecutor(device="cpu", name="ex-b")
    try:
        for i, a in enumerate(range(100, N, 100)):
            peer.session_append(sid, X[a:a + 100], Y[a:a + 100],
                                seq=i + 2).result()
        st = peer.stats()["sessions"]
        assert st["resumed"] == 1 and st["replayed_records"] == 0
        got = peer.session_finalize(sid).result()
        with pytest.raises(errors.SessionEvictedError):
            peer.session_finalize(sid).result()
    finally:
        peer.shutdown()
    R = rs.SessionRegistry(directory=str(tmp_path / "r"))
    rid = R.open(_spec(rs, "cwt"))
    _feed(R, rid, X, Y, "cwt")
    np.testing.assert_array_equal(got["SX"].numpy(),
                                  np.asarray(R.finalize(rid)["SX"]))
