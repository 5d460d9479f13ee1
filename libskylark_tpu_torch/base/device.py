"""Device policy of the port's public entry points.

Entry points take numpy arrays or tensors and run on the package default
device, "cuda" unless :func:`set_default_device` changed it, unless the
call passes ``device=``. A CUDA device with no card present raises; the
port never carries on silently on the CPU. A DTensor stays on its mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from libskylark_tpu_torch.base import errors

_default = torch.device("cuda")


def set_default_device(device) -> None:
    global _default
    _default = torch.device(device)


def default_device() -> torch.device:
    return _default


def resolve_device(device=None) -> torch.device:
    """``device`` (or the package default) as a torch.device, the CUDA
    index filled in: the device that a tensor made there reports, so two
    spellings of one card compare equal. Raises when it names CUDA and no
    CUDA device is available."""
    d = torch.device(device) if device is not None else _default
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise errors.UnsupportedError(
                "no CUDA device is available; pass device='cpu' or call "
                "set_default_device('cpu') to run on the CPU")
        if d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
    return d


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor on the resolved device (moved only if needed). A
    DTensor (parallel/mesh.py) passes unchanged, on its mesh's device:
    ``device`` is not read for it."""
    from libskylark_tpu_torch.parallel.mesh import _is_sharded

    if _is_sharded(x):
        return x
    d = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x if x.device == d else x.to(d)
    return torch.as_tensor(np.asarray(x), device=d)
