"""Sketch-and-solve least squares (the port of
libskylark_tpu/nla/least_squares.py ``approximate_least_squares``)."""

from __future__ import annotations

from typing import Optional

from libskylark_tpu_torch.algorithms import regression
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor


def approximate_least_squares(A, B, context: Context,
                              sketch_size: Optional[int] = None,
                              sketch: str = "fjlt", device=None):
    """Sketch-and-solve least squares (Drineas et al.), sketch size
    4×Width(A) by default. Only ``sketch="jlt"`` is ported; the default
    FJLT and the CWT raise until their slices land."""
    if sketch == "fjlt":
        raise errors.NotImplementedYetError(
            "the FJLT sketch is not ported yet (slice A4); pass sketch='jlt'")
    if sketch == "cwt":
        raise errors.NotImplementedYetError(
            "the CWT sketch is not ported yet (slices A4/A5); "
            "pass sketch='jlt'")
    if sketch != "jlt":
        raise errors.InvalidParametersError(
            f"unknown sketch {sketch!r}; expected 'fjlt', 'cwt', or 'jlt'")
    from libskylark_tpu_torch.sketch import JLT

    A = as_tensor(A, device)
    m, n = A.shape
    s = int(sketch_size) if sketch_size else 4 * n
    s = min(max(s, n + 1), m)
    T = JLT(m, s, context)
    return regression.solve_l2_sketched(A, B, T, device=A.device)
