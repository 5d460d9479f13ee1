"""WebHDFS transport for the streaming readers (the port of
libskylark_tpu/io/webhdfs.py).

HDFS's REST interface (``GET /webhdfs/v1/<path>?op=OPEN``) over stdlib
``urllib``, yielding decoded text lines: the seam every reader of
:mod:`libskylark_tpu_torch.io.chunked` accepts
(``iter_libsvm_batches(webhdfs_lines(...))``,
``read_libsvm_sharded(webhdfs_lines(...), mesh)``, ...). The namenode
answers OPEN with a 307 redirect to the datanode that holds the first
block, which ``urllib`` follows. Reads stream in ``buffer_bytes`` chunks
with a carry for the partial last line: memory stays O(buffer).

Resilience: both halves run under a
:class:`~libskylark_tpu_torch.resilience.RetryPolicy` (default: 4
attempts, decorrelated-jitter backoff, a transient-error predicate;
``SKYLARK_WEBHDFS_RETRIES`` sets the attempt count).

- **OPEN** retries transient connection failures; the last failure
  raises :class:`~libskylark_tpu_torch.base.errors.IOError_` with the URL
  and the attempt count in its trace.
- **read** failures *reconnect and resume*: OPEN takes a byte
  ``offset`` and the streamer counts the bytes it consumed, so a dropped
  connection reopens at ``offset + consumed`` and the line stream is the
  one an uninterrupted read gives.

The fault sites ``io.webhdfs.open`` (per connection attempt) and
``io.webhdfs.read`` (per chunk) make both paths testable; the tests run
the transport against a REST stub on the loopback address.
"""

from __future__ import annotations

import dataclasses
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator, Optional

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience.policy import DeadlineExceededError, RetryPolicy
from libskylark_tpu_torch.telemetry import metrics as _metrics
from libskylark_tpu_torch.telemetry import trace as _trace

# every survived connection drop, counted whether telemetry is on or not
_RECONNECTS = _metrics.counter(
    "io.webhdfs.reconnects",
    "Mid-stream WebHDFS connection drops that reconnected and resumed")


def _is_transient(e: BaseException) -> bool:
    """Worth a retry: connection/timeout trouble, short/dropped reads
    (``http.client.IncompleteRead`` et al.), and server-side (5xx /
    429) HTTP failures. Client errors (404, 403, ...) and logic errors
    fail immediately — they would fail identically forever."""
    import http.client

    if isinstance(e, DeadlineExceededError):
        return False     # exhausted budgets stop, never retry
    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500 or e.code == 429
    return isinstance(
        e, (urllib.error.URLError, ConnectionError, TimeoutError, OSError,
            http.client.HTTPException, errors.IOError_))


def default_retry() -> RetryPolicy:
    """The transport's default policy (``SKYLARK_WEBHDFS_RETRIES``
    bounds attempts, default 4)."""
    attempts = max(1, _env.WEBHDFS_RETRIES.get())
    return RetryPolicy(max_attempts=attempts, base_delay=0.1,
                       max_delay=2.0, retry_on=_is_transient)


def _open_url(namenode: str, path: str, user: Optional[str],
              offset: int, length: Optional[int],
              buffer_bytes: int, timeout: float,
              retry: Optional[RetryPolicy] = None):
    retry = retry or default_retry()
    if not path.startswith("/"):
        path = "/" + path
    params = {"op": "OPEN", "buffersize": str(buffer_bytes)}
    if user:
        params["user.name"] = user
    if offset:
        params["offset"] = str(offset)
    if length is not None:
        params["length"] = str(length)
    url = (namenode.rstrip("/") + "/webhdfs/v1" +
           urllib.parse.quote(path) + "?" + urllib.parse.urlencode(params))
    attempts = {"n": 0}

    def attempt(timeout=timeout):
        # default mirrors the caller's value: with timeout=None the
        # policy injects no kwarg (urlopen treats None as "no timeout",
        # same as before the retry wiring)
        attempts["n"] += 1
        faults.check("io.webhdfs.open", detail=url)
        return urllib.request.urlopen(url, timeout=timeout)

    try:
        # per-attempt timeout = the caller's urlopen timeout; the policy
        # threads it through so a hung connect consumes one attempt, not
        # the whole budget. The span covers the whole retry ladder —
        # per-attempt retry events attach to it (resilience.policy).
        with _trace.span("io.webhdfs.open",
                         attrs={"path": path, "offset": offset}):
            return dataclasses.replace(
                retry, timeout_arg="timeout", attempt_timeout=timeout,
            ).call(attempt)
    except (KeyboardInterrupt, SystemExit):
        raise               # cancellation is not an I/O failure — a
        #                     rewrap would make Ctrl-C retryable upstream
    except BaseException as e:  # noqa: BLE001 — rewrap with provenance
        err = errors.IOError_(
            f"webhdfs OPEN failed for {path!r} via {namenode!r}: {e}")
        err.append_trace(f"url={url}")
        err.append_trace(
            f"attempts={attempts['n']}/{retry.max_attempts}")
        raise err from e


def webhdfs_lines(
    namenode: str,
    path: str,
    user: Optional[str] = None,
    offset: int = 0,
    length: Optional[int] = None,
    buffer_bytes: int = 1 << 20,
    encoding: str = "utf-8",
    timeout: float = 60.0,
    retry: Optional[RetryPolicy] = None,
) -> Iterator[str]:
    """Stream the lines of an HDFS file through WebHDFS.

    ``namenode`` is the REST endpoint (``http://host:9870``); ``path``
    the absolute HDFS path. Yields text lines (newline stripped by the
    consumer — same contract as a file handle). O(buffer_bytes) memory.

    Transient mid-stream failures reconnect at the consumed byte offset
    under ``retry`` (see module docstring) — the line stream is
    bit-identical to an uninterrupted read.
    """
    retry = retry or default_retry()
    delays = retry.delays()
    reconnects = 0
    consumed = 0          # bytes successfully read off the wire
    carry = b""
    while True:
        want = None if length is None else length - consumed
        if want is not None and want <= 0:
            break
        resp = _open_url(namenode, path, user, offset + consumed, want,
                         buffer_bytes, timeout, retry=retry)
        clean_eof = False
        try:
            while True:
                faults.check("io.webhdfs.read", detail=path)
                chunk = resp.read(buffer_bytes)
                if not chunk:
                    clean_eof = True
                    break
                consumed += len(chunk)
                if reconnects:
                    # progress after a reconnect: the retry budget is
                    # per-INCIDENT, not per-stream — a week-long stream
                    # must survive unlimited isolated blips, just never
                    # max_attempts consecutive dead connections
                    reconnects = 0
                    delays = retry.delays()
                carry += chunk
                # split out complete lines; keep the partial tail
                if b"\n" in carry:
                    complete, carry = carry.rsplit(b"\n", 1)
                    for line in complete.split(b"\n"):
                        yield line.decode(encoding) + "\n"
        except (GeneratorExit, KeyboardInterrupt, SystemExit):
            raise                   # abandonment/cancellation — not a
            #                         transport failure, never rewrapped
        except BaseException as e:  # noqa: BLE001 — predicate decides
            reconnects += 1
            if not retry.retryable(e) or reconnects >= retry.max_attempts:
                if isinstance(e, errors.SkylarkError):
                    e.append_trace(
                        f"webhdfs read of {path!r} died at byte "
                        f"{offset + consumed} "
                        f"(connection {reconnects}/{retry.max_attempts})")
                    raise
                err = errors.IOError_(
                    f"webhdfs read failed for {path!r} at byte "
                    f"{offset + consumed}: {e}")
                err.append_trace(
                    f"connections={reconnects}/{retry.max_attempts}")
                raise err from e
            _RECONNECTS.inc_always()
            retry.sleep(next(delays))
            continue      # reopen at offset + consumed, carry intact
        finally:
            try:
                resp.close()
            except Exception:  # pragma: no cover - close-on-dead-socket
                pass
        if clean_eof:
            break
    if carry:
        yield carry.decode(encoding)
