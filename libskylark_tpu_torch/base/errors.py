"""Exception hierarchy with stable error codes.

The port's copy of libskylark_tpu/base/errors.py, cut to the classes the
PyTorch package raises. The codes are the reference's (100-112), so a
caller that dispatches on ``code`` treats both packages alike.
"""

from __future__ import annotations


class SkylarkError(Exception):
    """Base of all libskylark_tpu_torch errors."""

    code = 100

    def __init__(self, message: str = ""):
        super().__init__(message or self.__doc__)


class UnsupportedError(SkylarkError):
    """Operation not supported for the given types or devices."""

    code = 101


class InvalidParametersError(SkylarkError):
    """Invalid parameters passed to an algorithm or transform."""

    code = 102


class SketchError(SkylarkError):
    """Sketch-layer error."""

    code = 108


class NLAError(SkylarkError):
    """NLA-layer error (factorization failed, solver diverged...)."""

    code = 109


class IOError_(SkylarkError):
    """Data IO error."""

    code = 111


class NotImplementedYetError(SkylarkError):
    """Declared in the API surface but not yet implemented."""

    code = 112
