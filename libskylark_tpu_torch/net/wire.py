"""Deterministic, pickle-free framed wire protocol for the serve tier
(the port of libskylark_tpu/net/wire.py; its SKW1 bytes are the
reference's, so port and reference processes interoperate).

The journal-v2 / train-state codec discipline (sessions/journal.py,
train/slices.py) promoted to a socket: every message is one
**self-delimiting, CRC-guarded frame** whose header is canonical JSON
and whose array payloads are raw ``.npy`` streams written with
``allow_pickle=False``. Nothing on the wire can execute code on
decode, and the same logical message always encodes to the same bytes
(sorted JSON keys, versioned npy format) — which is what makes a
client retry *re-send the identical request* and the server's
content-addressed single-flight table (docs/caching) adopt it onto
the original flight instead of recomputing.

Frame anatomy (docs/networking, "Frame anatomy")::

    MAGIC(4) | u32 payload_len | u32 crc32(payload) | payload
    payload = u32 header_len | header_json | body_0 .. body_{k-1}
    body_i  = one .npy stream (np.lib.format, allow_pickle=False)

``MAGIC = b"SKW1"`` carries the protocol version; a reader that sees
anything else has lost frame sync and must tear the connection down
(:class:`~libskylark_tpu_torch.base.errors.WireProtocolError` — resyncing a
corrupt stream by scanning would risk executing a half-frame as a
fresh one). The CRC guards the *payload*; the length fields guard
the CRC (a torn length reads as short payload → CRC mismatch).

Values (request kwargs, response results) cross the wire through a
small recursive **tagged codec** (:func:`encode_value` /
:func:`decode_value`): JSON scalars inline; ndarrays (any dtype,
order, or striding) and numpy scalars as npy bodies (a tensor, on any
device, as the C-contiguous host copy of its values: the reference's
bytes for the same array); CSR sparse
operands as their three part arrays (never densified); sketch
transforms, kernels, shard plans, and train specs as their existing
``to_dict`` registry forms (``deserialize_sketch`` /
``deserialize_kernel`` / ``ShardPlan.from_dict`` /
``TrainJobSpec.from_dict``); operand-residency refs as their digest
strings. Anything else is a :class:`WireProtocolError` at *encode*
time — the codec refuses to invent a representation.

Error frames carry the stable :mod:`libskylark_tpu_torch.base.errors` code
table (code 117 = protocol violation; ``WIRE_OVERLOADED_CODE`` 118 =
``engine.serve.ServeOverloadedError``), the message, and the
structured retry fields (``retry_after_s``, ``tenant``) so a client
reconstructs the *same* exception type with the same backoff hint the
server raised (docs/networking, "Error codes").
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors as _errors

MAGIC = b"SKW1"
_LEN = struct.Struct("<II")          # payload length, crc32(payload)
_HLEN = struct.Struct("<I")          # header length inside the payload

#: Sanity bound on one frame (header + bodies). Operands bigger than
#: this belong on the residency path (``operand.register`` + ref
#: submits), not inline in every request.
MAX_FRAME_BYTES = 1 << 30

#: Sanity bound on the JSON header alone — a "header length" beyond
#: this is a torn or hostile stream, not a real request.
MAX_HEADER_BYTES = 1 << 24

# frame types
REQ = "req"
RES = "res"
ERR = "err"
GOAWAY = "goaway"


class PeerClosed(Exception):
    """Clean EOF at a frame boundary — the peer hung up between
    frames. Not a protocol violation (mid-frame EOF is)."""


# ---------------------------------------------------------------------------
# the tagged value codec
# ---------------------------------------------------------------------------


def _is_jsonable_scalar(v) -> bool:
    return v is None or isinstance(v, (bool, int, float, str))


def host_body(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a C-contiguous host array: one copy off the
    card for a CUDA tensor, a DTensor's blocks gathered. ``np.asarray`` of
    a transposed CPU tensor would keep its strides and write a
    Fortran-ordered ``.npy``, whose header is not the reference's."""
    from libskylark_tpu_torch.parallel.mesh import to_host

    if t.dtype not in _NPY_DTYPES:
        raise _errors.WireProtocolError(
            f"tensor dtype {t.dtype} has no .npy encoding")
    return np.ascontiguousarray(to_host(t))


_NPY_DTYPES = frozenset((
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
    torch.int64, torch.float16, torch.float32, torch.float64,
    torch.complex64, torch.complex128))


def encode_value(v, bodies: List[np.ndarray]):
    """Encode one value to its JSON-safe tagged spec, appending any
    array payloads to ``bodies`` (the frame's npy section, in spec
    order). Deterministic: the same value always yields the same spec
    and the same body bytes."""
    from libskylark_tpu_torch.base.sparse import SparseMatrix
    from libskylark_tpu_torch.engine import resultcache as _rcache
    from libskylark_tpu_torch.ml.kernels import Kernel
    from libskylark_tpu_torch.sketch.transform import (Dimension,
                                                       SketchTransform)

    if _is_jsonable_scalar(v):
        return {"k": "py", "v": v}
    if isinstance(v, np.ndarray):
        bodies.append(v)
        return {"k": "nd", "i": len(bodies) - 1}
    if isinstance(v, np.generic):
        bodies.append(np.asarray(v))
        return {"k": "n0", "i": len(bodies) - 1}
    if isinstance(v, torch.Tensor):
        bodies.append(host_body(v))
        return {"k": "nd", "i": len(bodies) - 1}
    if isinstance(v, Dimension):
        return {"k": "dim", "v": v.value}
    if isinstance(v, SparseMatrix):
        data, indices, indptr = v.csr_parts()
        base = len(bodies)
        bodies.extend((data, indices, indptr))
        return {"k": "csr", "i": base, "shape": [int(s) for s in v.shape]}
    if isinstance(v, SketchTransform):
        return {"k": "sketch", "d": v.to_dict()}
    if isinstance(v, Kernel):
        return {"k": "kernel", "d": v.to_dict()}
    if _rcache.is_ref(v):
        return {"k": "ref", "v": str(_rcache.as_ref(v).digest)}
    # late imports: train/dist are optional layers above the codec
    from libskylark_tpu_torch.dist.plan import ShardPlan
    from libskylark_tpu_torch.train.jobs import TrainJobSpec

    if isinstance(v, ShardPlan):
        return {"k": "plan", "d": v.to_dict()}
    if isinstance(v, TrainJobSpec):
        return {"k": "tspec", "d": v.to_dict()}
    if isinstance(v, tuple):
        return {"k": "tup", "x": [encode_value(x, bodies) for x in v]}
    if isinstance(v, list):
        return {"k": "list", "x": [encode_value(x, bodies) for x in v]}
    if isinstance(v, dict):
        bad = [k for k in v if not isinstance(k, str)]
        if bad:
            raise _errors.WireProtocolError(
                f"wire dicts need str keys, got {type(bad[0]).__name__}")
        return {"k": "map",
                "x": {k: encode_value(v[k], bodies) for k in sorted(v)}}
    if hasattr(v, "__array__"):
        # other array-likes: ship the host copy
        bodies.append(np.asarray(v))
        return {"k": "nd", "i": len(bodies) - 1}
    raise _errors.WireProtocolError(
        f"value of type {type(v).__name__} has no wire encoding")


def decode_value(spec, bodies: List[np.ndarray]):
    """Inverse of :func:`encode_value`."""
    from libskylark_tpu_torch.base.sparse import SparseMatrix
    from libskylark_tpu_torch.engine import resultcache as _rcache
    from libskylark_tpu_torch.ml.kernels import deserialize_kernel
    from libskylark_tpu_torch.sketch.transform import (
        Dimension, deserialize_sketch,
    )

    if not isinstance(spec, dict) or "k" not in spec:
        raise _errors.WireProtocolError(f"malformed value spec {spec!r}")
    k = spec["k"]
    try:
        if k == "py":
            return spec["v"]
        if k == "nd":
            return bodies[spec["i"]]
        if k == "n0":
            return bodies[spec["i"]][()]
        if k == "dim":
            return Dimension(spec["v"])
        if k == "csr":
            i = spec["i"]
            return SparseMatrix.from_csr(
                bodies[i], bodies[i + 1], bodies[i + 2],
                tuple(spec["shape"]))
        if k == "sketch":
            return deserialize_sketch(spec["d"])
        if k == "kernel":
            return deserialize_kernel(spec["d"])
        if k == "ref":
            return _rcache.OperandRef(spec["v"])
        if k == "plan":
            from libskylark_tpu_torch.dist.plan import ShardPlan

            return ShardPlan.from_dict(spec["d"])
        if k == "tspec":
            from libskylark_tpu_torch.train.jobs import TrainJobSpec

            return TrainJobSpec.from_dict(spec["d"])
        if k == "tup":
            return tuple(decode_value(x, bodies) for x in spec["x"])
        if k == "list":
            return [decode_value(x, bodies) for x in spec["x"]]
        if k == "map":
            return {name: decode_value(x, bodies)
                    for name, x in spec["x"].items()}
    except _errors.SkylarkError:
        raise
    except Exception as e:  # noqa: BLE001 — decode is a trust boundary
        raise _errors.WireProtocolError(
            f"failed to decode {k!r} value: {e}") from e
    raise _errors.WireProtocolError(f"unknown value tag {k!r}")


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def encode_frame(header: dict, bodies: Tuple[np.ndarray, ...] = ()) -> bytes:
    """One complete frame as bytes (header JSON + npy bodies, length-
    and CRC-prefixed)."""
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode("utf-8")
    buf = io.BytesIO()
    buf.write(_HLEN.pack(len(hdr)))
    buf.write(hdr)
    for arr in bodies:
        np.lib.format.write_array(
            buf, host_body(arr) if isinstance(arr, torch.Tensor)
            else np.asarray(arr), allow_pickle=False)
    payload = buf.getvalue()
    if len(payload) > MAX_FRAME_BYTES:
        raise _errors.WireProtocolError(
            f"frame payload {len(payload)} bytes exceeds "
            f"MAX_FRAME_BYTES {MAX_FRAME_BYTES}")
    return (MAGIC + _LEN.pack(len(payload), zlib.crc32(payload))
            + payload)


def decode_payload(payload: bytes) -> Tuple[dict, List[np.ndarray]]:
    """Header + bodies from one CRC-verified frame payload."""
    if len(payload) < _HLEN.size:
        raise _errors.WireProtocolError("frame payload shorter than "
                                        "its header-length field")
    (hlen,) = _HLEN.unpack_from(payload, 0)
    if hlen > MAX_HEADER_BYTES or _HLEN.size + hlen > len(payload):
        raise _errors.WireProtocolError(
            f"frame header length {hlen} exceeds payload")
    try:
        header = json.loads(
            payload[_HLEN.size:_HLEN.size + hlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise _errors.WireProtocolError(
            f"frame header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise _errors.WireProtocolError("frame header is not an object")
    bodies: List[np.ndarray] = []
    buf = io.BytesIO(payload)
    buf.seek(_HLEN.size + hlen)
    n_bodies = int(header.get("nb", 0))
    for _ in range(n_bodies):
        try:
            bodies.append(np.lib.format.read_array(
                buf, allow_pickle=False))
        except Exception as e:  # noqa: BLE001 — torn/hostile npy
            raise _errors.WireProtocolError(
                f"frame body failed to decode: {e}") from e
    if buf.read(1):
        raise _errors.WireProtocolError(
            "frame payload has trailing bytes past its declared bodies")
    return header, bodies


def read_frame(recv: Callable[[int], bytes]) -> Tuple[dict,
                                                      List[np.ndarray]]:
    """Read one frame through ``recv(n) -> exactly-n-or-fewer bytes``
    (a socket ``recv``). Raises :class:`PeerClosed` on clean EOF at a
    frame boundary, :class:`~libskylark_tpu_torch.base.errors
    .WireProtocolError` on bad magic, bad CRC, or mid-frame EOF."""
    head = _recv_exact(recv, len(MAGIC) + _LEN.size, at_boundary=True)
    if head is None:
        raise PeerClosed()
    if head[:len(MAGIC)] != MAGIC:
        raise _errors.WireProtocolError(
            f"bad frame magic {head[:len(MAGIC)]!r} (stream lost sync)")
    plen, crc = _LEN.unpack_from(head, len(MAGIC))
    if plen > MAX_FRAME_BYTES:
        raise _errors.WireProtocolError(
            f"frame length {plen} exceeds MAX_FRAME_BYTES")
    payload = _recv_exact(recv, plen)
    if zlib.crc32(payload) != crc:
        raise _errors.WireProtocolError("frame CRC mismatch")
    return decode_payload(payload)


def _recv_exact(recv: Callable[[int], bytes], n: int,
                at_boundary: bool = False) -> Optional[bytes]:
    chunks = []
    got = 0
    while got < n:
        chunk = recv(min(n - got, 1 << 20))
        if not chunk:
            if at_boundary and got == 0:
                return None
            raise _errors.WireProtocolError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# requests / responses / errors
# ---------------------------------------------------------------------------


def pack_request(verb: str, kwargs: dict, *, seq: int,
                 tenant: Optional[str] = None,
                 qos_class: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None,
                 trace: Optional[dict] = None) -> bytes:
    """One request frame. ``kwargs`` are the verb's operand kwargs
    (transport fields ride the header, never the kwarg map). The
    header's ``digest`` is blake2b over the encoded kwarg section —
    the transport idempotency token a reconnect-retry re-presents;
    flight adoption itself keys on the router's *content* digest,
    which the identical re-sent bytes re-derive (docs/networking,
    "Retry & idempotency")."""
    bodies: List[np.ndarray] = []
    kw = {k: encode_value(kwargs[k], bodies) for k in sorted(kwargs)}
    h = hashlib.blake2b(
        json.dumps(kw, sort_keys=True).encode(), digest_size=16)
    for arr in bodies:
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode() + repr(a.shape).encode())
        h.update(a.tobytes())
    header = {
        "t": REQ, "verb": str(verb), "seq": int(seq), "kw": kw,
        "nb": len(bodies), "digest": h.hexdigest(),
    }
    if tenant is not None:
        header["tenant"] = str(tenant)
    if qos_class is not None:
        header["qos"] = str(qos_class)
    if deadline_s is not None:
        header["deadline_s"] = float(deadline_s)
    if timeout is not None:
        header["timeout"] = float(timeout)
    if trace:
        header["trace"] = trace
    return encode_frame(header, tuple(bodies))


def unpack_request(header: dict,
                   bodies: List[np.ndarray]) -> Tuple[str, dict]:
    """(verb, kwargs) from a request frame's header + bodies."""
    verb = header.get("verb")
    kw = header.get("kw")
    if not isinstance(verb, str) or not isinstance(kw, dict):
        raise _errors.WireProtocolError(
            "request frame missing verb/kw fields")
    return verb, {k: decode_value(v, bodies) for k, v in kw.items()}


def pack_result(seq: int, value) -> bytes:
    bodies: List[np.ndarray] = []
    spec = encode_value(value, bodies)
    return encode_frame(
        {"t": RES, "seq": int(seq), "value": spec, "nb": len(bodies)},
        tuple(bodies))


def unpack_result(header: dict, bodies: List[np.ndarray]):
    return decode_value(header.get("value"), bodies)


def pack_error(seq: Optional[int], exc: BaseException) -> bytes:
    """One structured error frame: stable code, message, and the
    retry fields (``retry_after_s`` / ``tenant``) the matching
    exception classes carry."""
    code = exc_code(exc)
    header = {
        "t": ERR, "code": code, "error": type(exc).__name__,
        "message": str(exc),
        "retry_after_s": float(getattr(exc, "retry_after_s", 0.0)),
    }
    if seq is not None:
        header["seq"] = int(seq)
    tenant = getattr(exc, "tenant", None)
    if tenant:
        header["tenant"] = str(tenant)
    return encode_frame(header)


def exc_code(exc: BaseException) -> int:
    """The wire error code for one exception (docs/networking, "Error
    codes"): SkylarkError subclasses carry their own stable code;
    ``ServeOverloadedError`` (a RuntimeError by design) maps to
    :data:`~libskylark_tpu_torch.base.errors.WIRE_OVERLOADED_CODE`;
    everything else degrades to the base code 100 with the type name
    prefixed into the message by :func:`pack_error`'s caller."""
    from libskylark_tpu_torch.engine.serve import ServeOverloadedError

    if isinstance(exc, ServeOverloadedError):
        return _errors.WIRE_OVERLOADED_CODE
    if isinstance(exc, _errors.SkylarkError):
        return int(getattr(exc, "code", _errors.SkylarkError.code))
    return _errors.SkylarkError.code


def unpack_error(header: dict) -> BaseException:
    """Reconstruct the typed exception an error frame describes, with
    retry fields intact (the ``retry_after_s`` fidelity contract)."""
    from libskylark_tpu_torch.engine.serve import ServeOverloadedError

    code = int(header.get("code", _errors.SkylarkError.code))
    message = str(header.get("message", ""))
    retry_after = float(header.get("retry_after_s", 0.0))
    if code == _errors.WIRE_OVERLOADED_CODE:
        exc: BaseException = ServeOverloadedError(message)
        exc.retry_after_s = retry_after
        return exc
    if code == _errors.TenantQuotaError.code:
        return _errors.TenantQuotaError(
            message, tenant=str(header.get("tenant", "")),
            retry_after_s=retry_after)
    exc = _errors.from_code(code, message)
    if retry_after:
        exc.retry_after_s = retry_after
    return exc


def pack_goaway(drain_timeout_s: float) -> bytes:
    return encode_frame(
        {"t": GOAWAY, "drain_timeout_s": float(drain_timeout_s)})


#: header fields carrying span identity across the wire — the client
#: puts its SpanContext here; the server opens its ``net.serve`` span
#: with ``parent=SpanContext(**trace)`` so the request's tree is one
#: trace end to end (docs/observability).
TRACE_FIELDS = ("trace_id", "span_id", "request_id")


def trace_header(ctx) -> Optional[Dict[str, Optional[str]]]:
    if ctx is None:
        return None
    return {f: getattr(ctx, f, None) for f in TRACE_FIELDS}


__all__ = [
    "ERR", "GOAWAY", "MAGIC", "MAX_FRAME_BYTES", "PeerClosed", "REQ",
    "RES", "decode_payload", "decode_value", "encode_frame",
    "encode_value", "exc_code", "host_body", "pack_error", "pack_goaway",
    "pack_request", "pack_result", "read_frame", "trace_header",
    "unpack_error", "unpack_request", "unpack_result",
]
