"""Matmul-precision policy.

The port of libskylark_tpu/base/precision.py. A float32 product must stay
float32-grade: the reference's oracle is 1e-4, and TF32 keeps about three
decimal digits. :func:`install_default_matmul_precision` runs when the
package is imported and turns TF32 off for matmuls and convolutions;
solver entry points are wrapped in :func:`with_solver_precision`, which
holds the float32 matmul precision at the solver precision while they
run, "highest" unless :func:`set_solver_precision` chose another,
whatever the caller set after the import.
"""

from __future__ import annotations

import contextlib
import functools

import torch


_INSTALLED_AMBIENT = "highest"


def ambient_matmul_precision() -> str:
    """The float32 matmul precision in effect
    (``torch.get_float32_matmul_precision()``)."""
    return torch.get_float32_matmul_precision()


def ambient_precision_pinned_by_user() -> bool:
    """True when the float32 matmul precision differs from the one the
    package installed at import ("highest"): a caller set another. A pin
    equal to it is not detected, as in the reference."""
    return ambient_matmul_precision() != _INSTALLED_AMBIENT


def install_default_matmul_precision() -> None:
    """Full float32 for every f32 matmul and convolution (TF32 off)."""
    torch.set_float32_matmul_precision(_INSTALLED_AMBIENT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# The reference's solver precision names (JAX's matmul precisions) and
# the torch float32 matmul precision each stands for: "highest" is full
# float32, "high" TF32 (or bf16x3), "medium" bf16.
_SOLVER_PRECISIONS = {"highest": "highest", "float32": "highest",
                      "high": "high", "tensorfloat32": "high",
                      "bfloat16_3x": "high", "bfloat16": "medium",
                      "fastest": "medium", "default": None}
_solver_precision = "highest"


def set_solver_precision(value: str) -> None:
    """Set the solvers' matmul precision: "highest"/"float32" (the
    default), "tensorfloat32"/"high", "bfloat16"/"fastest", or "default"
    (the solvers leave the ambient precision as it is)."""
    if value not in _SOLVER_PRECISIONS:
        raise ValueError(f"unknown solver precision {value!r}; one of "
                         f"{sorted(_SOLVER_PRECISIONS)}")
    global _solver_precision
    _solver_precision = value


def get_solver_precision() -> str:
    return _solver_precision


@contextlib.contextmanager
def solver_precision():
    """Hold the float32 matmul precision at the solver precision while
    the block runs ("default": leave it as it is)."""
    target = _SOLVER_PRECISIONS[_solver_precision]
    if target is None:
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(target)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def with_solver_precision(fn):
    """Run ``fn`` under :func:`solver_precision`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with solver_precision():
            return fn(*args, **kwargs)

    return wrapped
