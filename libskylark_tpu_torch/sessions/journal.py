"""Append-only session journal (the port of
libskylark_tpu/sessions/journal.py): every accepted append, durable
before its future resolves. The format is the reference's byte for byte,
so either package resumes the other's journal.

One file per session under the registry directory. Record layout::

    [u32 payload length][u32 crc32 of payload][payload bytes]

after an 8-byte file magic (``SKYJRNL2``). The payload is a small
JSON header (``{"seq", "keys"}``) followed by one raw ``.npy`` body
per batch key — **nothing in a record is executable**. The journal
lives under a shared, sometimes world-visible directory, so a planted
file must never be able to run code in the serving process; ``.npy``
bodies are read with ``allow_pickle=False`` and reproduce the exact
bytes of the batch the client sent, so replaying a record re-folds
exactly that batch.

Durability discipline:

- every append is one unbuffered ``write(2)`` straight to the OS page
  cache before returning — a ``kill -9``'d replica loses nothing
  already accepted (the OS holds the bytes; only a whole-machine crash
  can drop them);
- every ``SKYLARK_SESSION_FSYNC_EVERY``-th append (default 8) also
  **fsyncs**, bounding what a machine crash can lose; drain/checkpoint
  paths call :meth:`sync` to force the bound to zero.

Torn tails are expected, not fatal: a crash mid-write leaves a partial
final record. :func:`scan` validates length + CRC record by record and
stops at the first damage; :meth:`SessionJournal.open_for_append`
truncates the file back to the intact prefix, so a resumed session
replays exactly the accepted appends and the retried tail append lands
cleanly after them (idempotent sequence numbers make the overlap a
no-op either way).

A torn record must never be left MID-file either: a failed or short
append write (ENOSPC, a transient I/O error) rolls the file back to
the pre-write offset before the error surfaces, so the intact prefix
always covers every acknowledged record. If even the rollback fails,
the journal is **poisoned** — further appends refuse with the original
cause — because appending past damage would make ``scan`` silently
drop every later (acknowledged!) record at replay time.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors

MAGIC = b"SKYJRNL2"
_HDR = struct.Struct("<II")
_PHDR = struct.Struct("<I")


def _encode_record(seq: int, batch: dict) -> bytes:
    """JSON header + raw ``.npy`` array bodies (module doc: the
    payload carries data only, never executable state)."""
    keys = sorted(batch)
    head = json.dumps({"seq": int(seq), "keys": keys}).encode("utf-8")
    buf = io.BytesIO()
    buf.write(_PHDR.pack(len(head)))
    buf.write(head)
    for k in keys:
        np.lib.format.write_array(buf, np.asarray(batch[k]),
                                  allow_pickle=False)
    return buf.getvalue()


def _decode_record(payload: bytes) -> Tuple[int, dict]:
    buf = io.BytesIO(payload)
    (hlen,) = _PHDR.unpack(buf.read(_PHDR.size))
    head = json.loads(buf.read(hlen).decode("utf-8"))
    batch = {str(k): np.lib.format.read_array(buf, allow_pickle=False)
             for k in head["keys"]}
    return int(head["seq"]), batch


def scan(path: str) -> Tuple[list, int]:
    """``([(seq, batch_dict), ...], good_offset)`` — every intact
    record in order, plus the byte offset of the intact prefix (the
    truncation point for recovery). A missing file scans as empty; a
    bad magic raises (that is not a torn tail, it is not a journal)."""
    if not os.path.exists(path):
        return [], len(MAGIC)
    records: list = []
    with open(path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic != MAGIC:
            if magic == b"SKYJRNL1":
                raise errors.IOError_(
                    f"{path} is a version-1 session journal (pickle "
                    "payloads) — this build reads only "
                    f"{MAGIC.decode()}; v1 never shipped, delete the "
                    "artifacts and re-open the session")
            raise errors.IOError_(
                f"{path} is not a session journal (bad magic)")
        good = fh.tell()
        while True:
            hdr = fh.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            length, crc = _HDR.unpack(hdr)
            payload = fh.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break                      # torn tail: stop at damage
            try:
                seq, batch = _decode_record(payload)
            except Exception:              # noqa: BLE001 — torn payload
                break
            records.append((seq, batch))
            good = fh.tell()
    return records, good


class SessionJournal:
    """Writer half: append-only with batched fsync (module doc).
    The file is opened unbuffered, so every record is a single
    ``write(2)`` and nothing ever sits in a userspace buffer that an
    :meth:`abandon` (the fenced-owner path) could accidentally flush
    into a file this process no longer owns."""

    def __init__(self, path: str, fsync_every: Optional[int] = None):
        self.path = path
        self._fsync_every = max(int(
            fsync_every if fsync_every is not None
            else _env.SESSION_FSYNC_EVERY.get()), 1)
        self._since_sync = 0
        self._fh = None
        self._failed: Optional[str] = None

    @classmethod
    def create(cls, path: str,
               fsync_every: Optional[int] = None) -> "SessionJournal":
        j = cls(path, fsync_every)
        fh = open(path, "xb", buffering=0)
        fh.write(MAGIC)
        os.fsync(fh.fileno())
        j._fh = fh
        return j

    @classmethod
    def open_for_append(cls, path: str,
                        fsync_every: Optional[int] = None,
                        ) -> Tuple["SessionJournal", list]:
        """Recovery open: scan the intact prefix, truncate any torn
        tail, position for append. Returns ``(journal, records)``."""
        records, good = scan(path)
        j = cls(path, fsync_every)
        if not os.path.exists(path):
            return cls.create(path, fsync_every), records
        fh = open(path, "r+b", buffering=0)
        fh.truncate(good)
        fh.seek(good)
        j._fh = fh
        return j, records

    def append(self, seq: int, batch: dict) -> None:
        """Make one append durable (see the module durability
        discipline). The caller folds only after this returns."""
        if self._failed is not None:
            raise errors.IOError_(
                f"session journal {self.path} refused the append: a "
                f"previous write failed unrecoverably "
                f"({self._failed}); the intact prefix still covers "
                "every acknowledged record — resume elsewhere")
        payload = _encode_record(seq, batch)
        rec = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        start = self._fh.tell()
        short = False
        try:
            n = self._fh.write(rec)
            short = n is not None and n != len(rec)
        except OSError as e:
            self._rollback(start, e)
            raise
        if short:
            e = errors.IOError_(
                f"short write appending to {self.path} "
                "(disk full?)")
            self._rollback(start, e)
            raise e
        self._since_sync += 1
        if self._since_sync >= self._fsync_every:
            try:
                os.fsync(self._fh.fileno())
            except OSError as e:
                # post-failure fsync semantics are undefined (the
                # kernel may drop the dirty pages and clear the
                # error): the machine-crash durability bound cannot
                # be promised any more, so poison the journal
                self._failed = f"fsync failed: {e}"
                raise
            self._since_sync = 0

    def _rollback(self, offset: int, cause: BaseException) -> None:
        """Truncate a torn record back off the tail so the file ends
        at the intact prefix; poison the journal if that fails too."""
        try:
            self._fh.truncate(offset)
            self._fh.seek(offset)
        except OSError:
            self._failed = f"rollback after failed write failed: {cause}"

    def sync(self) -> None:
        """Force the fsync bound to zero (drain/checkpoint paths)."""
        if self._fh is not None and not self._fh.closed:
            try:
                os.fsync(self._fh.fileno())
            except OSError as e:
                self._failed = f"fsync failed: {e}"
                raise
            self._since_sync = 0

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            try:
                self.sync()
            finally:
                self._fh.close()

    def abandon(self) -> None:
        """Close WITHOUT syncing — the fenced-owner path: another
        replica owns this file now and this process must not touch
        another byte of it (appends are unbuffered, so nothing is
        lost)."""
        if self._fh is not None and not self._fh.closed:
            self._fh.close()


def replay(path: str) -> Iterator[Tuple[int, dict]]:
    """Read-only iteration over the intact records (peers inspecting a
    journal they do not own)."""
    records, _ = scan(path)
    return iter(records)


__all__ = ["SessionJournal", "replay", "scan"]
