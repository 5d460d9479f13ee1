"""Carrying state across from the JAX package.

The system has no weights: a transform's state is its allocation (seed,
counter, path), N, S and extra hyper-parameters (CT's C), all in its JSON
form, plus the raw (2,) uint32 key data the serve path passes around; a
kernel's is its type, N and parameters, in its JSON form. A trained
model's weights are its coefficient matrix beside its maps' JSON forms.
These helpers take what ``libskylark_tpu`` writes and return the port's
objects; nothing here imports the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Union

import numpy as np

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.ml.kernels import Kernel, deserialize_kernel
from libskylark_tpu_torch.ml.model import HilbertModel
from libskylark_tpu_torch.sketch.transform import (SketchTransform,
                                                   deserialize_sketch)


def transform_from_reference(d: Union[dict[str, Any], str]) -> SketchTransform:
    """The port's transform for a reference ``to_dict()``/``to_json()``."""
    return deserialize_sketch(d)


def kernel_from_reference(d: Union[dict[str, Any], str]) -> Kernel:
    """The port's kernel for a reference ``Kernel.to_dict()``/JSON."""
    return deserialize_kernel(d)


def hilbert_model_from_reference(d: Union[dict[str, Any], str],
                                 device=None) -> HilbertModel:
    """The port's model for a reference ``HilbertModel.to_dict()``, its
    JSON text or a model file's path; the coefficients land on
    ``device``."""
    return HilbertModel.load(d, device)


def key_from_numpy(kd) -> np.ndarray:
    """Raw key data (e.g. ``np.asarray(jax.random.key_data(k))``) as the
    port's (2,) uint32 key."""
    a = np.asarray(kd)
    if a.shape != (2,) or a.dtype != np.uint32:
        raise errors.InvalidParametersError(
            f"key data must be a (2,) uint32 array, got {a.shape} {a.dtype}")
    return a.copy()


def context_from_reference(d: Union[dict[str, Any], str]) -> Context:
    """The port's Context for a reference ``Context.to_dict()``/JSON."""
    return Context.from_dict(json.loads(d) if isinstance(d, str) else d)
