"""Session registry: open/append/finalize over journaled, resumable
sketch state (the port of libskylark_tpu/sessions/registry.py; its
artifacts are the reference's, so either package resumes the other's
sessions).

The registry owns every live session of one executor (the serve layer
holds one per :class:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor`)
and the on-disk artifacts that make a session survivable — all under
the shared ``SKYLARK_SESSION_DIR`` root:

``<sid>.meta.json``
    the :class:`~libskylark_tpu_torch.sessions.state.SessionSpec`, written
    atomically at open — everything a peer needs to rebuild the
    transform streams;
``<sid>.journal``
    the append-only journal (:mod:`libskylark_tpu_torch.sessions.journal`):
    every accepted append is durable here *before* its future
    resolves;
``<sid>.ckpt.npz`` / ``.json``
    the newest checkpoint (:func:`libskylark_tpu_torch.utility.checkpoint
    .save_sync`) — accumulator bytes at a recorded ``(seq, rows)``,
    written by the drain path and bounding replay cost;
``<sid>.lease``
    the ownership fence: ``{"gen", "owner"}``, bumped atomically by
    whichever registry opens or resumes the session.

Because the artifacts are trusted state (a resume rebuilds whatever
they say), the implicit default root is created ``0o700`` and refused
outright when it is a symlink or owned by another uid — it lives at a
predictable path under the world-writable system temp dir, where any
local user could otherwise pre-create it and plant forged sessions.
An explicitly configured root (``SKYLARK_SESSION_DIR`` or the
``directory=`` argument) is the operator's deliberate choice — e.g.
group-shared network storage — and is not second-guessed.

**Ownership fencing.** Exactly one registry may hold a session live.
Opening or resuming a session bumps the generation in ``<sid>.lease``;
every verb re-reads the lease under the session's lock before acting
(appends re-validate again after the journal write, before the ack;
eviction re-validates adjacent to the unlink), and a registry whose
recorded generation no longer matches has been **fenced** — some peer
resumed the session out from under it (a drain race, a
partitioned-then-healed owner). A fenced owner drops its in-memory
entry, abandons its journal handle, and leaves every on-disk artifact
strictly alone (they belong to the new owner now — in particular its
TTL sweep must not delete them); the verb that observes the fence
raises ``SessionEvictedError``, and a *later* touch resumes from disk
again — the handoff-back path when the ring returns the session here.
A router keeps verbs pinned to one live owner in the first place
(session affinity, ROADMAP A7 fleet/); the lease is the storage-layer
backstop for the races that remain. It fences at
*touch* granularity: no fenced owner ever acks, checkpoints over, or
deletes the new owner's state, though a single already-in-flight
journal write can still land before its (refused) ack — advisory
cross-process file locks cannot exclude it without also breaking
crash-orphaned-file adoption.

Resilience tiers:

1. **graceful** — a DRAINING replica's drain hook calls
   :meth:`checkpoint_all`; a peer's first touch of the session id
   resumes from the checkpoint (journal tail empty past it) and the
   stream continues bit-equal;
2. **crash** — a ``kill -9``'d replica wrote no checkpoint, but the
   journal holds every accepted append: the peer replays checkpoint +
   journal tail, truncating any torn final record, and idempotent
   sequence numbers make the client's retried append a no-op if it was
   already durable;
3. **degradation** — per-session TTL eviction raises
   :class:`~libskylark_tpu_torch.base.errors.SessionEvictedError` (terminal:
   artifacts removed, the id tombstoned), and the serve layer sheds
   session appends before interactive traffic under DEGRADED health.

The ``session.append`` fault site fires before the journal write, so a
chaos plan (including the ``crash`` spec) kills an append *before* it
becomes durable — the client's retry then lands exactly once.
"""

from __future__ import annotations

import json
import os
import re
import stat as _stat
import tempfile
import time
import uuid
import weakref
from typing import Optional, Tuple

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.sessions.journal import SessionJournal
from libskylark_tpu_torch.sessions.state import (
    SessionSpec,
    SessionState,
    make_state,
)
from libskylark_tpu_torch.telemetry import metrics as _metrics

_OPENED = _metrics.counter(
    "sessions.opened", "Stateful serve sessions opened, by kind")
_APPENDS = _metrics.counter(
    "sessions.appends", "Session append batches accepted (journaled "
    "and folded)")
_FINALIZED = _metrics.counter(
    "sessions.finalized", "Sessions finalized, by kind")
_EVICTED = _metrics.counter(
    "sessions.evicted", "Sessions evicted, by reason")
_RESUMED = _metrics.counter(
    "sessions.resumed", "Sessions resumed from disk (drain handoff or "
    "crash replay), by source")
_REPLAYED = _metrics.counter(
    "sessions.replayed_records", "Journal records re-folded during "
    "session resume")
_CKPTS = _metrics.counter(
    "sessions.checkpoints", "Synchronous session checkpoints written")
_FENCED = _metrics.counter(
    "sessions.fenced", "Stale session owners fenced off after a peer "
    "resumed their session (lease generation mismatch)")
_LIVE = _metrics.gauge(
    "sessions.live", "Live sessions per registry")


def default_session_dir() -> str:
    """The durability root: ``SKYLARK_SESSION_DIR`` when set, else a
    host-stable directory under the system temp dir (single-host
    handoff works out of the box; point the variable at shared storage
    for cross-host resume)."""
    configured = _env.SESSION_DIR.get()
    if configured:
        return str(configured)
    try:
        uid = os.getuid()
    except AttributeError:  # pragma: no cover - non-posix
        uid = 0
    return os.path.join(tempfile.gettempdir(), f"skylark_sessions_{uid}")


def _ensure_private_dir(path: str, strict: bool) -> None:
    """Create the durability root ``0o700``; with ``strict`` (the
    implicit default under the world-writable temp dir — module doc)
    also refuse a root that is a symlink or owned by another uid,
    since either means some other local user controls what a resume
    will trust."""
    os.makedirs(path, mode=0o700, exist_ok=True)
    if not strict or os.name != "posix":
        return
    st = os.lstat(path)
    if _stat.S_ISLNK(st.st_mode):
        raise errors.IOError_(
            f"session dir {path} is a symlink — refusing: its target "
            "is under someone else's control; set SKYLARK_SESSION_DIR "
            "to a directory you own")
    if st.st_uid != os.getuid():
        raise errors.IOError_(
            f"session dir {path} is owned by uid {st.st_uid}, not "
            f"this process's uid {os.getuid()} — refusing: another "
            "user could plant or delete session state; set "
            "SKYLARK_SESSION_DIR to a directory you own")
    if st.st_mode & 0o077:
        os.chmod(path, 0o700)


class _Entry:
    """One live session: state + journal + its own fold lock. Starts
    as an unpopulated placeholder during a resume (``state is None``,
    the lock held by the resumer for the whole replay) — every
    consumer acquires ``lock`` before touching ``state``, so racers on
    the first touch simply block until the resume lands (or observe
    ``dead`` if it failed)."""

    __slots__ = ("state", "journal", "lock", "last_touch", "ttl",
                 "dead", "lease_gen", "pins")

    def __init__(self, state: Optional[SessionState] = None,
                 journal: Optional[SessionJournal] = None):
        self.state = state
        self.journal = journal
        self.lock = _locks.make_lock("sessions.session")
        self.last_touch = time.monotonic()
        self.ttl = float("inf")
        self.dead: Optional[str] = None
        self.lease_gen = 0
        self.pins = 0
        if state is not None:
            self.reset_ttl()

    def reset_ttl(self) -> None:
        ttl = self.state.spec.ttl_s
        self.ttl = float(ttl if ttl is not None
                         else _env.SESSION_TTL.get())


class SessionRegistry:
    """Open/append/finalize with TTL eviction, checkpointing, lease
    fencing and resume-with-replay (module doc). Thread-safe;
    per-session folds serialize on the session's own lock, the
    registry lock only guards the id maps — a resume replays under
    the session's lock, never the registry's."""

    def __init__(self, directory: Optional[str] = None,
                 name: str = "sessions", device=None):
        from libskylark_tpu_torch.base.device import resolve_device

        self.name = str(name)
        # the device of every session's accumulators (default: the
        # package default)
        self.device = resolve_device(device)
        # the implicit default root sits at a predictable path under
        # the world-writable temp dir: hold it to the strict private
        # checks; an explicit root is the operator's choice
        implicit = directory is None and not _env.SESSION_DIR.get()
        self.directory = os.path.abspath(directory
                                         or default_session_dir())
        _ensure_private_dir(self.directory, strict=implicit)
        self._lock = _locks.make_lock("sessions.registry")
        # this registry's identity on the lease files it holds
        self._token = f"{os.getpid()}.{uuid.uuid4().hex[:12]}"
        self._live: "dict[str, _Entry]" = {}
        self._tombstones: "dict[str, tuple]" = {}  # sid -> (reason,
        #                                             monotonic stamp)
        self._counts = {"opened": 0, "appends": 0, "duplicates": 0,
                        "finalized": 0, "evicted": 0, "resumed": 0,
                        "replayed_records": 0, "checkpoints": 0,
                        "fenced": 0}
        _REGISTRIES.add(self)

    # -- paths ----------------------------------------------------------

    def _meta_path(self, sid: str) -> str:
        return os.path.join(self.directory, f"{sid}.meta.json")

    def _journal_path(self, sid: str) -> str:
        return os.path.join(self.directory, f"{sid}.journal")

    def _ckpt_path(self, sid: str) -> str:
        return os.path.join(self.directory, f"{sid}.ckpt")

    def _lease_path(self, sid: str) -> str:
        return os.path.join(self.directory, f"{sid}.lease")

    # -- tombstones -----------------------------------------------------

    def _tombstone_locked(self, sid: str, reason: str) -> None:
        """Caller holds ``self._lock``. Tombstones are a courtesy
        error-message cache — once the artifacts are gone, an unknown
        id yields the same :class:`SessionEvictedError` from the
        resume path — so they are pruned by age past a size cap
        rather than retained forever (a long-lived serving process
        must not leak one dict entry per session it ever finalized).
        Memory stays bounded by eviction rate x the grace period."""
        now = time.monotonic()
        self._tombstones[sid] = (reason, now)
        if len(self._tombstones) > _TOMBSTONE_CAP:
            grace = float(_env.SESSION_TTL.get())
            for k in [k for k, (_r, t) in self._tombstones.items()
                      if now - t > grace]:
                del self._tombstones[k]

    def _tombstone_reason(self, sid: str) -> Optional[str]:
        """Caller holds ``self._lock``."""
        hit = self._tombstones.get(sid)
        return hit[0] if hit is not None else None

    # -- lease fencing (module doc) -------------------------------------

    def _read_lease(self, sid: str) -> Tuple[int, str]:
        """A MISSING or unparsable lease reads as generation 0 (the
        lease is genuinely gone or replaced — writes are atomic, so
        garbage means someone removed it). Any other I/O error
        propagates: a transient EIO on network storage must surface
        as a retryable failure, never be misread as "a peer fenced
        us" (which would terminally drop a healthy session)."""
        try:
            with open(self._lease_path(sid)) as fh:
                d = json.load(fh)
            return int(d["gen"]), str(d.get("owner", ""))
        except (FileNotFoundError, ValueError, KeyError, TypeError):
            return 0, ""

    def _acquire_lease(self, sid: str) -> int:
        """Bump the session's lease generation to this registry,
        fencing whoever held it before (their next touch observes the
        mismatch). Atomic via rename; fsync'd so the fence survives
        the machine crashes the journal protects against."""
        gen = self._read_lease(sid)[0] + 1
        tmp = self._lease_path(sid) + f".{self._token}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"gen": gen, "owner": self._token}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._lease_path(sid))
        return gen

    def _fenced_locked(self, sid: str, entry: _Entry) -> Optional[str]:
        """Caller holds ``entry.lock``. Returns the fence reason if
        this registry lost the session's lease (a peer resumed it),
        after dropping the entry WITHOUT touching the on-disk
        artifacts — they belong to the new owner now."""
        if entry.lease_gen == 0:
            return None                    # unpopulated placeholder
        gen, owner = self._read_lease(sid)
        if gen == entry.lease_gen and owner == self._token:
            return None
        reason = (f"fenced: resumed by another replica (lease "
                  f"generation {gen}, held {entry.lease_gen})")
        entry.dead = reason
        try:
            entry.journal.abandon()
        except OSError:
            pass
        with self._lock:
            # dropped, NOT tombstoned: the artifacts on disk are
            # valid (they belong to the new owner), so when the ring
            # later hands the session BACK here — the new owner
            # drains or crashes in its turn — the first touch must
            # resume it, not refuse on a stale tombstone. Only the
            # verb that observes the fence errors; the next touch
            # re-resolves through the resume path.
            self._live.pop(sid, None)
            self._counts["fenced"] += 1
            live = len(self._live)
        _FENCED.inc()
        _LIVE.set(live, registry=self.name)
        return reason

    # -- open -----------------------------------------------------------

    def open(self, spec: SessionSpec,
             session_id: Optional[str] = None) -> str:
        """Create a fresh session; returns its id. An id colliding with
        a live session, a tombstone, or on-disk artifacts refuses —
        open never silently adopts existing state (that is the resume
        path's explicit job, and it happens on first touch of an
        unknown-but-on-disk id). Like resume, the file I/O (meta +
        lease fsyncs, journal create) and the accumulator build run
        under a placeholder entry's own lock, never the registry lock
        — opening one session must not stall every other session's
        verbs."""
        spec = spec.validate()
        sid = str(session_id) if session_id else uuid.uuid4().hex[:16]
        # explicit whitelist (ids become filenames under the shared
        # durability root): letters, digits, dash, underscore only
        if not re.fullmatch(r"[A-Za-z0-9_-]{1,64}", sid):
            raise errors.InvalidParametersError(
                f"session id {sid!r} must match [A-Za-z0-9_-]{{1,64}}")
        entry = _Entry()
        entry.lock.acquire()
        try:
            with self._lock:
                if sid in self._live or sid in self._tombstones:
                    raise errors.InvalidParametersError(
                        f"session {sid!r} already exists")
                if os.path.exists(self._meta_path(sid)):
                    raise errors.InvalidParametersError(
                        f"session {sid!r} has on-disk state; resume "
                        "it by appending, or pick a fresh id")
                self._live[sid] = entry
            journal = None
            try:
                # the journal's "xb" create is the atomic RESERVATION
                # of the id across registries sharing the dir: exactly
                # one racing open can win it (the meta-exists precheck
                # above is advisory fast-refusal), so the loser's
                # cleanup can never delete artifacts a winning peer
                # already owns
                try:
                    journal = SessionJournal.create(
                        self._journal_path(sid))
                except FileExistsError:
                    raise errors.InvalidParametersError(
                        f"session {sid!r} has on-disk state; resume "
                        "it by appending, or pick a fresh id"
                    ) from None
                state = make_state(spec, self.directory, sid,
                                   device=self.device)
                tmp = self._meta_path(sid) + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump({"spec": spec.to_dict(), "v": 1}, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, self._meta_path(sid))
                lease_gen = self._acquire_lease(sid)
            except BaseException as e:
                entry.dead = f"open failed: {e}"
                with self._lock:
                    self._live.pop(sid, None)
                if journal is not None:
                    # we hold the reservation: the partial artifacts
                    # are ours to delete
                    try:
                        journal.abandon()
                    except OSError:
                        pass
                    self._remove_artifacts(sid)
                raise
            entry.state = state
            entry.journal = journal
            entry.lease_gen = lease_gen
            entry.reset_ttl()
            entry.last_touch = time.monotonic()
            with self._lock:
                self._counts["opened"] += 1
                live = len(self._live)
        finally:
            entry.lock.release()
        _OPENED.inc(kind=spec.kind)
        _LIVE.set(live, registry=self.name)
        return sid

    # -- resolution + resume --------------------------------------------

    def _resolve(self, sid: str) -> _Entry:
        with self._lock:
            e = self._live.get(sid)
            if e is not None:
                return e
            reason = self._tombstone_reason(sid)
            if reason is not None:
                raise errors.SessionEvictedError(
                    f"session {sid!r} is gone ({reason})")
        return self._resume(sid)

    def _resume(self, sid: str) -> _Entry:
        """First touch of an unknown-but-on-disk id: publish a
        placeholder entry with its lock already held, then replay the
        disk artifacts under THAT lock — never the registry lock, so
        one session's resume (checkpoint load + journal-tail re-fold)
        cannot block every other session's verbs. Racing resolvers get
        the placeholder and simply block on its lock like any other
        verb. Lock order is session → registry, same as every verb.
        A failed resume drops the placeholder without a tombstone — a
        later touch retries from disk."""
        entry = _Entry()
        entry.lock.acquire()
        try:
            with self._lock:
                raced = self._live.get(sid)
                if raced is not None:
                    return raced           # someone else is resuming
                reason = self._tombstone_reason(sid)
                if reason is not None:
                    raise errors.SessionEvictedError(
                        f"session {sid!r} is gone ({reason})")
                self._live[sid] = entry
            try:
                replayed, source = self._resume_into(sid, entry)
            except BaseException as e:
                entry.dead = f"resume failed: {e}"
                with self._lock:
                    self._live.pop(sid, None)
                raise
            with self._lock:
                self._counts["resumed"] += 1
                self._counts["replayed_records"] += replayed
                live = len(self._live)
            _RESUMED.inc(source=source)
            if replayed:
                _REPLAYED.inc(replayed)
            _LIVE.set(live, registry=self.name)
            return entry
        finally:
            entry.lock.release()

    def _resume_into(self, sid: str, entry: _Entry) -> Tuple[int, str]:
        """Rebuild a session from its disk artifacts into ``entry``
        (caller holds ``entry.lock``). Checkpoint (if any) restores
        the accumulator bytes at its recorded ``(seq, rows)``; the
        journal's intact tail replays on top, records at or below the
        checkpoint seq skipped (idempotent). The journal reopens
        truncated past any torn record, ready for the stream to
        continue."""
        from libskylark_tpu_torch.utility import checkpoint as _ckpt

        meta_path = self._meta_path(sid)
        if not os.path.exists(meta_path):
            raise errors.SessionEvictedError(
                f"session {sid!r} is unknown here and has no journal/"
                f"checkpoint under {self.directory} — evicted, "
                "finalized, or never opened")
        with open(meta_path) as fh:
            meta = json.load(fh)
        state = make_state(SessionSpec.from_dict(meta["spec"]),
                           self.directory, sid, device=self.device)
        # fence the previous owner FIRST: once the generation is
        # bumped, its next touch drops its entry, so it can neither
        # append to the journal we are about to replay nor TTL-evict
        # the artifacts out from under us
        lease_gen = self._acquire_lease(sid)
        source = "journal"
        loaded = _ckpt.load_sync(self._ckpt_path(sid))
        if loaded is not None:
            arrays, cmeta = loaded
            state.load(arrays, cmeta["rows"], cmeta["seq"])
            source = "checkpoint"
        journal, records = SessionJournal.open_for_append(
            self._journal_path(sid))
        replayed = 0
        for seq, batch in records:
            if seq <= state.seq:
                continue                   # already in the checkpoint
            X, Y = state.coerce_batch(batch["X"], batch.get("Y"))
            state.fold(X, Y)
            state.seq = seq
            replayed += 1
        entry.state = state
        entry.journal = journal
        entry.lease_gen = lease_gen
        entry.reset_ttl()
        entry.last_touch = time.monotonic()
        return replayed, source

    # -- ttl / eviction -------------------------------------------------

    def _check_ttl(self, sid: str, entry: _Entry) -> None:
        """Caller holds ``entry.lock``. Raises after evicting (TTL) or
        after dropping a fenced entry (lease lost — artifacts left for
        the new owner)."""
        if entry.dead is not None:
            raise errors.SessionEvictedError(
                f"session {sid!r} is gone ({entry.dead})")
        fenced = self._fenced_locked(sid, entry)
        if fenced is not None:
            raise errors.SessionEvictedError(
                f"session {sid!r} is gone ({fenced})")
        if (entry.pins == 0
                and time.monotonic() - entry.last_touch > entry.ttl):
            # pinned sessions (an in-flight or scheduled train slice —
            # :meth:`pin`) never TTL-evict: a long slice that crosses
            # the TTL must not race its own checkpoint into eviction.
            # Fence and dead checks above still apply to pinned
            # entries — a pin is not a lease.
            self._evict(sid, entry, "ttl")
            raise errors.SessionEvictedError(
                f"session {sid!r} exceeded its idle TTL "
                f"({entry.ttl}s) and was evicted")

    def _evict(self, sid: str, entry: _Entry, reason: str) -> None:
        """Terminal removal (caller holds ``entry.lock`` and has
        verified the lease — see :meth:`_check_ttl`): delete every
        artifact while the journal handle is still open (so a racing
        resume cannot slip in between), close it, tombstone the id."""
        # delete gate: re-validate the lease ADJACENT to the
        # irreversible unlink (symmetric to append's ack gate) — a
        # peer's resume that landed since the caller's fence check
        # owns the artifacts now, and this owner must drop fenced
        # instead of deleting them
        fenced = self._fenced_locked(sid, entry)
        if fenced is not None:
            raise errors.SessionEvictedError(
                f"session {sid!r} is gone ({fenced})")
        entry.dead = reason
        self._remove_artifacts(sid)
        try:
            entry.journal.close()
        except OSError:
            pass
        if os.path.exists(self._journal_path(sid)):
            # non-posix: unlinking the open journal above may have
            # failed (Windows PermissionError, swallowed); retry now
            # that the handle is closed so the id cannot wedge
            try:
                os.unlink(self._journal_path(sid))
            except OSError:
                pass
        with self._lock:
            self._live.pop(sid, None)
            self._tombstone_locked(sid, reason)
            self._counts["evicted" if reason != "finalized"
                         else "finalized"] += 1
            live = len(self._live)
        if reason != "finalized":
            _EVICTED.inc(reason=reason)
        _LIVE.set(live, registry=self.name)

    def _remove_artifacts(self, sid: str) -> None:
        for p in (self._journal_path(sid), self._meta_path(sid),
                  self._ckpt_path(sid) + ".npz",
                  self._ckpt_path(sid) + ".json",
                  # the train operand sidecar, written before open and
                  # removed with the rest of the session
                  os.path.join(self.directory, f"{sid}.operands.npz"),
                  os.path.join(self.directory, f"{sid}.operands.json"),
                  self._lease_path(sid)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def sweep(self) -> int:
        """Evict every TTL-expired session; returns how many (fenced
        entries count — they are dropped either way, just without
        touching the new owner's artifacts)."""
        with self._lock:
            snapshot = list(self._live.items())
        n = 0
        for sid, entry in snapshot:
            with entry.lock:
                try:
                    self._check_ttl(sid, entry)
                except errors.SessionEvictedError:
                    n += 1
        return n

    def evict(self, sid: str, reason: str = "operator") -> None:
        """Administrative eviction (terminal, like a TTL expiry)."""
        entry = self._resolve(sid)
        with entry.lock:
            if (entry.dead is None
                    and self._fenced_locked(sid, entry) is None):
                self._evict(sid, entry, reason)

    # -- append ---------------------------------------------------------

    def append(self, sid: str, X, Y=None, seq: Optional[int] = None,
               tags: frozenset = frozenset()) -> tuple:
        """Accept one row batch: validate, journal (durable), fold.
        Returns ``(seq, rows)`` — the applied sequence number and the
        stream position after the fold. A ``seq`` at or below the
        session's cursor is a duplicate replay and returns the current
        position as a no-op (crash-retry idempotency); a gap refuses.
        The ``session.append`` fault site fires *before* the journal
        write (module doc)."""
        entry = self._resolve(sid)
        with entry.lock:
            self._check_ttl(sid, entry)
            state = entry.state
            target = state.seq + 1 if seq is None else int(seq)
            if target <= state.seq:
                entry.last_touch = time.monotonic()
                with self._lock:
                    self._counts["duplicates"] += 1
                return state.seq, state.rows
            if target != state.seq + 1:
                raise errors.InvalidParametersError(
                    f"append sequence gap: session {sid!r} is at "
                    f"{state.seq}, got {target}")
            Xc, Yc = state.coerce_batch(X, Y)
            faults.check("session.append", tags=tags,
                         detail=f"{sid}#{target}")
            batch = {"X": Xc}
            if Yc is not None:
                batch["Y"] = Yc
            entry.journal.append(target, batch)
            # ack gate: re-validate the lease AFTER the write landed.
            # If a peer resumed (fenced us) between the entry check
            # and the write, the record may sit past the point the
            # peer's replay scanned — it must never be acknowledged
            # as durable (the client's retry lands on the new owner).
            fenced = self._fenced_locked(sid, entry)
            if fenced is not None:
                raise errors.SessionEvictedError(
                    f"session {sid!r} is gone ({fenced})")
            state.fold(Xc, Yc)
            state.seq = target
            entry.last_touch = time.monotonic()
            out = (state.seq, state.rows)
        with self._lock:
            self._counts["appends"] += 1
        _APPENDS.inc()
        return out

    # -- finalize -------------------------------------------------------

    def finalize(self, sid: str) -> dict:
        """Compute the session's terminal result, then remove it (and
        its artifacts) — the id is tombstoned so a late append raises
        :class:`SessionEvictedError` instead of resurrecting state."""
        entry = self._resolve(sid)
        with entry.lock:
            self._check_ttl(sid, entry)
            result = entry.state.finalize()
            kind = entry.state.spec.kind
            self._evict(sid, entry, "finalized")
        _FINALIZED.inc(kind=kind)
        return result

    # -- checkpointing (the drain hook's verb) --------------------------

    def checkpoint(self, sid: str) -> None:
        """Synchronously checkpoint one session: journal fsync'd, the
        accumulator bytes durable under the session's checkpoint path
        (:func:`libskylark_tpu_torch.utility.checkpoint.save_sync`). A dead
        or fenced entry is skipped — a stale owner must not overwrite
        the new owner's checkpoint."""
        from libskylark_tpu_torch.utility import checkpoint as _ckpt

        entry = self._resolve(sid)
        with entry.lock:
            if (entry.dead is not None
                    or self._fenced_locked(sid, entry) is not None):
                return
            entry.journal.sync()
            _ckpt.save_sync(
                self._ckpt_path(sid), entry.state.arrays(),
                {"seq": entry.state.seq, "rows": entry.state.rows,
                 "spec": entry.state.spec.to_dict()})
            # a checkpoint is activity: a session checkpointing on
            # schedule must not drift toward its idle TTL while making
            # durable progress
            entry.last_touch = time.monotonic()
        with self._lock:
            self._counts["checkpoints"] += 1
        _CKPTS.inc()

    def checkpoint_all(self) -> int:
        """Checkpoint every live session (the DRAINING replica's
        drain hook — :meth:`MicrobatchExecutor.drain` calls this before
        stopping, so a peer resumes from state, not from a full journal
        replay). Returns how many were written; per-session failures
        are contained (the drain must keep going)."""
        import warnings

        with self._lock:
            sids = list(self._live)
        n = 0
        for sid in sids:
            try:
                self.checkpoint(sid)
                n += 1
            except Exception as e:  # noqa: BLE001 — drain the rest
                warnings.warn(
                    f"session {sid!r} checkpoint failed: {e}",
                    RuntimeWarning, stacklevel=2)
        return n

    # -- pinning (train jobs: no TTL eviction while work is in flight)

    def pin(self, sid: str) -> None:
        """Hold the session out of TTL eviction while work on it is
        scheduled or in flight (the train manager pins for the whole
        job: slices refresh ``last_touch`` on each ack, but a single
        slice longer than the TTL — or a deep scheduler backlog —
        must not let the sweep race the next slice's checkpoint).
        Pins nest; they do not survive the registry (an entry rebuilt
        by resume starts unpinned — the resuming owner re-pins)."""
        entry = self._resolve(sid)
        with entry.lock:
            self._check_ttl(sid, entry)
            entry.pins += 1
            entry.last_touch = time.monotonic()

    def unpin(self, sid: str) -> None:
        """Release one pin. Only live entries are touched — an
        unpin after eviction/fencing is a no-op, never a resume."""
        with self._lock:
            entry = self._live.get(sid)
        if entry is None:
            return
        with entry.lock:
            if entry.pins > 0:
                entry.pins -= 1
            entry.last_touch = time.monotonic()

    # -- introspection / lifecycle --------------------------------------

    def describe(self, sid: str) -> dict:
        """Snapshot of a live (or resumable) session: spec, cursor,
        and — for states that expose :meth:`info` (train sessions) —
        the solver's progress facts. Does not refresh ``last_touch``
        (status polling is not activity, same as :meth:`rows`)."""
        entry = self._resolve(sid)
        with entry.lock:
            self._check_ttl(sid, entry)
            state = entry.state
            out = {"spec": state.spec.to_dict(), "seq": state.seq,
                   "rows": state.rows, "pins": entry.pins}
            info = getattr(state, "info", None)
            if callable(info):
                out["info"] = info()
            return out

    def session_ids(self) -> list:
        with self._lock:
            return sorted(self._live)

    def rows(self, sid: str) -> tuple:
        """``(seq, rows)`` of a live (or resumable) session. Validates
        like every verb (fence + TTL) — a fenced stale owner must not
        keep reporting its pre-handoff cursor as live — but does not
        refresh ``last_touch`` (polling is not activity)."""
        entry = self._resolve(sid)
        with entry.lock:
            self._check_ttl(sid, entry)
            return entry.state.seq, entry.state.rows

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["live"] = len(self._live)
        return out

    def close(self) -> None:
        """Sync every journal and drop the in-memory maps WITHOUT
        deleting artifacts — the shutdown path; a peer (or a restart)
        resumes from disk."""
        with self._lock:
            snapshot = list(self._live.items())
            self._live.clear()
        for _sid, entry in snapshot:
            try:
                if entry.journal is not None:
                    entry.journal.close()
            except OSError:
                pass
        _LIVE.set(0, registry=self.name)


_TOMBSTONE_CAP = 1024

_REGISTRIES: "weakref.WeakSet[SessionRegistry]" = weakref.WeakSet()


def sessions_stats() -> dict:
    """Aggregate session counters over every live registry (the
    ``sessions`` telemetry collector block)."""
    agg = {"registries": 0, "live": 0}
    keys = ("opened", "appends", "duplicates", "finalized", "evicted",
            "resumed", "replayed_records", "checkpoints", "fenced")
    for k in keys:
        agg[k] = 0
    for reg in list(_REGISTRIES):
        s = reg.stats()
        agg["registries"] += 1
        agg["live"] += s["live"]
        for k in keys:
            agg[k] += s[k]
    return agg


_metrics.register_collector("sessions", sessions_stats)


__all__ = ["SessionRegistry", "default_session_dir", "sessions_stats"]
