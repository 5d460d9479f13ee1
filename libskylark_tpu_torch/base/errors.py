"""Exception hierarchy with stable error codes.

The port's copy of libskylark_tpu/base/errors.py: the same classes, codes
(100-117, and 118 for an overloaded server on the wire) and readers, so a
caller that dispatches on ``code`` or calls :func:`strerror` treats both
packages alike.
"""

from __future__ import annotations


class SkylarkError(Exception):
    """Base of all libskylark_tpu_torch errors."""

    code = 100

    def __init__(self, message: str = ""):
        super().__init__(message or self.__doc__)
        self._trace: list[str] = []

    def append_trace(self, entry: str) -> "SkylarkError":
        """Add one entry to the error's trace (where it passed through)."""
        self._trace.append(entry)
        return self

    @property
    def trace(self) -> list[str]:
        return list(self._trace)


class UnsupportedError(SkylarkError):
    """Operation not supported for the given types or devices."""

    code = 101


class InvalidParametersError(SkylarkError):
    """Invalid parameters passed to an algorithm or transform."""

    code = 102


class AllocationError(SkylarkError):
    """Device/host memory allocation failure."""

    code = 103


class CommunicationError(SkylarkError):
    """Collective communication failure (MPI-exception analog)."""

    code = 104


class MeshError(SkylarkError):
    """Device-mesh or sharding incompatibility."""

    code = 105


class SparseError(SkylarkError):
    """Sparse-matrix error."""

    code = 106


class RandgenError(SkylarkError):
    """Random-stream error."""

    code = 107


class SketchError(SkylarkError):
    """Sketch-layer error."""

    code = 108


class NLAError(SkylarkError):
    """NLA-layer error (factorization failed, solver diverged...)."""

    code = 109


class MLError(SkylarkError):
    """ML-layer error."""

    code = 110


class IOError_(SkylarkError):
    """Data IO error."""

    code = 111


class NotImplementedYetError(SkylarkError, NotImplementedError):
    """Declared in the API surface but not yet implemented."""

    code = 112


class SessionEvictedError(SkylarkError):
    """A stateful serve session is gone: evicted, finalized or never
    opened. Terminal for the session id: the client opens a new session
    and streams again."""

    code = 113


class SketchCoverageError(SkylarkError):
    """A distributed sketch merge could not reach the caller's
    ``min_coverage``: the error carries the ``coverage`` reached and the
    ``missing`` row ranges."""

    code = 114

    def __init__(self, message: str = "", *, coverage: float = 0.0,
                 missing=()):
        super().__init__(message)
        self.coverage = float(coverage)
        self.missing = tuple(tuple(r) for r in missing)


class TenantQuotaError(SkylarkError):
    """A serve request exceeded its tenant's admission quota; retryable
    after ``retry_after_s``, never queued."""

    code = 115

    def __init__(self, message: str = "", *, tenant: str = "",
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.tenant = str(tenant)
        self.retry_after_s = float(retry_after_s)


class TrainBudgetExhaustedError(SkylarkError):
    """A training job ran out of its iteration budget or deadline before
    converging: the error carries ``iterations``, the last ``residual``
    and ``slices``."""

    code = 116

    def __init__(self, message: str = "", *, iterations: int = 0,
                 residual=None, slices: int = 0):
        super().__init__(message)
        self.iterations = int(iterations)
        self.residual = None if residual is None else float(residual)
        self.slices = int(slices)


class WireProtocolError(CommunicationError):
    """A network frame violated the serve wire protocol (bad magic, CRC
    mismatch, a torn frame, an unknown verb): the connection is torn
    down and the client reconnects."""

    code = 117


#: The on-wire code of an overloaded server (the serve layer's
#: backpressure error, a RuntimeError that carries no ``code`` itself).
WIRE_OVERLOADED_CODE = 118


_CODE_TABLE = {
    cls.code: cls
    for cls in [
        SkylarkError,
        UnsupportedError,
        InvalidParametersError,
        AllocationError,
        CommunicationError,
        MeshError,
        SparseError,
        RandgenError,
        SketchError,
        NLAError,
        MLError,
        IOError_,
        NotImplementedYetError,
        SessionEvictedError,
        SketchCoverageError,
        TenantQuotaError,
        TrainBudgetExhaustedError,
        WireProtocolError,
    ]
}


def strerror(code: int) -> str:
    """The first line of the error class's description for ``code``."""
    cls = _CODE_TABLE.get(code)
    if cls is None:
        return f"unknown error code {code}"
    return cls.__doc__.split("\n")[0]


def from_code(code: int, message: str = "") -> SkylarkError:
    """An error of the class that ``code`` names (SkylarkError if none)."""
    return _CODE_TABLE.get(code, SkylarkError)(message)
