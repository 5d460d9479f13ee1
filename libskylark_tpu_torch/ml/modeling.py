"""Model-file consumers (the port of libskylark_tpu/ml/modeling.py):
``LinearizedKernelModel`` loads a model file written by either package's
:class:`~libskylark_tpu_torch.ml.model.HilbertModel` and serves
predictions."""

from __future__ import annotations

import numpy as np

from libskylark_tpu_torch.ml.coding import host_array
from libskylark_tpu_torch.ml.model import HilbertModel


class LinearizedKernelModel:
    """A saved model, loaded onto ``device`` (default: the package
    default device)."""

    def __init__(self, fname: str, device=None):
        self._model = HilbertModel.load(fname, device)

    @property
    def hilbert_model(self) -> HilbertModel:
        return self._model

    def get_input_dimension(self) -> int:
        return self._model.input_size

    def predict(self, X):
        labels, _ = self._model.predict(X)
        m = self._model
        if (not m.regression and m.label_coding is not None
                and m.num_outputs > 1):
            # class indices decoded to the training labels
            return np.asarray(m.label_coding)[host_array(labels).ravel()]
        return labels

    def decision_values(self, X):
        return self._model.decision_values(X)
