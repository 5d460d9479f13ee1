"""Prediction metrics (the port of libskylark_tpu/ml/metrics.py)."""

from __future__ import annotations

import numpy as np

from libskylark_tpu_torch.ml.coding import host_array


def classification_accuracy(pred, truth) -> float:
    """Percentage of matching labels."""
    pred = host_array(pred).reshape(-1)
    truth = host_array(truth).reshape(-1)
    if pred.shape != truth.shape:
        raise ValueError(f"shape mismatch {pred.shape} vs {truth.shape}")
    return float(np.mean(pred == truth) * 100.0)


def rmse(pred, truth) -> float:
    """Root-mean-square error."""
    pred = host_array(pred).reshape(-1)
    truth = host_array(truth).reshape(-1)
    return float(np.sqrt(np.mean((pred - truth) ** 2)))
