"""Label coding: one-vs-all ±1 dummy coding and argmax decoding (the port
of libskylark_tpu/ml/coding.py)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base.device import resolve_device


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, or anything numpy takes) as a numpy
    array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dummy_coding(labels, coding: Sequence = None, dtype=torch.float32,
                 device=None) -> Tuple[torch.Tensor, list]:
    """Labels (n,) → (n, k) matrix with +1 at the label's column and −1
    elsewhere, on ``device``. Returns (Y, coding), ``coding`` the distinct
    label values in column order; pass it back in to reuse a coding made
    on the training data."""
    labels = host_array(labels).reshape(-1)
    if coding is None:
        coding = sorted(set(labels.tolist()))
    coding = list(coding)
    index = {v: i for i, v in enumerate(coding)}
    cols = torch.as_tensor([index[v] for v in labels.tolist()],
                           dtype=torch.int64, device=resolve_device(device))
    Y = torch.where(
        torch.arange(len(coding), device=cols.device)[None, :]
        == cols[:, None], 1.0, -1.0).to(dtype)
    return Y, coding


def dummy_decode(Y, coding: Sequence) -> np.ndarray:
    """(n, k) scores → (n,) labels by argmax over the columns."""
    Y = Y if isinstance(Y, torch.Tensor) else torch.as_tensor(np.asarray(Y))
    return np.asarray(coding)[host_array(torch.argmax(Y, dim=1))]
