"""High-level least squares: approximate_least_squares and
fast_least_squares (the port of libskylark_tpu/nla/least_squares.py)."""

from __future__ import annotations

from typing import Optional

from libskylark_tpu_torch.algorithms import regression
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import is_sparse_operand, place


def approximate_least_squares(A, B, context: Context,
                              sketch_size: Optional[int] = None,
                              sketch: str = "fjlt", device=None):
    """Sketch-and-solve least squares (Drineas et al.): sketch size
    4×Width(A) by default, with an FJLT (DCT mixer), a CWT or a JLT. A
    sparse A turns the FJLT default into a CWT (the FJLT has no sparse
    apply)."""
    from libskylark_tpu_torch import sketch as sk

    families = {"fjlt": sk.FJLT, "cwt": sk.CWT, "jlt": sk.JLT}
    if sketch not in families:
        raise errors.InvalidParametersError(
            f"unknown sketch {sketch!r}; expected 'fjlt', 'cwt', or 'jlt'")
    if is_sparse_operand(A) and sketch == "fjlt":
        sketch = "cwt"
    A, device = place(A, device)
    m, n = A.shape
    s = int(sketch_size) if sketch_size else 4 * n
    s = min(max(s, n + 1), m)
    T = families[sketch](m, s, context)
    return regression.solve_l2_sketched(A, B, T, device=device)


def fast_least_squares(A, B, context: Context,
                       params: Optional[regression.AcceleratedParams] = None,
                       device=None):
    """Accurate sketch-preconditioned solve: Blendenpik with the condition
    fallback. Returns (X, lsqr_iterations)."""
    return regression.solve_l2_accelerated(A, B, context, method="blendenpik",
                                           params=params, device=device)
