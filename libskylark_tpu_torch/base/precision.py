"""Matmul-precision policy.

The port of libskylark_tpu/base/precision.py. A float32 product must stay
float32-grade: the reference's oracle is 1e-4, and TF32 keeps about three
decimal digits. :func:`install_default_matmul_precision` runs when the
package is imported and turns TF32 off for matmuls and convolutions;
solver entry points are wrapped in :func:`with_solver_precision`, which
holds the float32 matmul precision at "highest" while they run, whatever
the caller set after the import.
"""

from __future__ import annotations

import functools

import torch


def install_default_matmul_precision() -> None:
    """Full float32 for every f32 matmul and convolution (TF32 off)."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def with_solver_precision(fn):
    """Run ``fn`` with the float32 matmul precision held at "highest"."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev)

    return wrapped
