"""Hilbert-space model: linear coefficients on top of feature maps (the port
of libskylark_tpu/ml/model.py).

Prediction applies each stored map to the input, scales by √(s_j/d) when
the maps were scaled during training, adds the per-block linear pieces,
and decodes classification outputs by sign or argmax. The JSON form is
the reference's field for field, every map embedded as its (seed,
counter) serialization, so a model file written by either package loads
in the other and predicts the same.
"""

from __future__ import annotations

import json
import math
from typing import Any, Optional, Sequence, Union

import torch

from libskylark_tpu_torch import __version__
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import as_tensor, resolve_device
from libskylark_tpu_torch.ml.coding import host_array
from libskylark_tpu_torch.sketch import (ROWWISE, SketchTransform,
                                         deserialize_sketch)


class HilbertModel:
    """Linear-on-features model. ``coef`` lives on ``device`` (default:
    the package default device), where prediction runs."""

    def __init__(
        self,
        maps: Sequence[SketchTransform],
        scale_maps: bool,
        num_features: int,
        num_outputs: int,
        regression: bool,
        input_size: Optional[int] = None,
        coef=None,
        label_coding: Optional[Sequence] = None,
        device=None,
    ):
        # classification: the original label of each output column, so
        # predictions decode back to the training labels; None = the
        # labels were already 0..k−1
        self.label_coding = list(label_coding) if label_coding else None
        self.maps = list(maps)
        self.scale_maps = bool(scale_maps)
        self.regression = bool(regression)
        self.starts = []
        nf = 0
        for m in self.maps:
            self.starts.append(nf)
            nf += m.sketch_dim
        if self.maps and nf != num_features:
            raise errors.InvalidParametersError(
                f"feature maps produce {nf} features, expected {num_features}")
        self.num_features = int(num_features)
        self.num_outputs = int(num_outputs)
        self.input_size = int(
            input_size if input_size is not None
            else (self.maps[0].input_dim if self.maps else num_features))
        self.coef = (
            torch.zeros((self.num_features, self.num_outputs),
                        dtype=torch.float32, device=resolve_device(device))
            if coef is None else as_tensor(coef, device))

    # -- prediction --

    def decision_values(self, X) -> torch.Tensor:
        """DV = Σⱼ scaleⱼ·Zⱼ(X)·Wⱼ, the raw scores (n, k), on the
        coefficients' device."""
        X = as_tensor(X, self.coef.device)
        if not self.maps:
            return X @ self.coef
        d = self.input_size
        DV = torch.zeros((X.shape[0], self.num_outputs), dtype=X.dtype,
                         device=X.device)
        for m, start in zip(self.maps, self.starts):
            sj = m.sketch_dim
            Z = m.apply(X, ROWWISE, device=X.device)
            if self.scale_maps:
                Z = Z * math.sqrt(sj / d)
            DV = DV + Z @ self.coef[start:start + sj]
        return DV

    def materialize(self) -> "HilbertModel":
        """Pin every feature map's operator on the coefficients' device
        (the maps that keep one): repeated predictions stop regenerating
        it, except where the fused kernel's route serves the apply.
        ``dematerialize`` drops them."""
        for mp in self.maps:
            if hasattr(mp, "materialize"):
                mp.materialize(device=self.coef.device)
        return self

    def dematerialize(self) -> "HilbertModel":
        for mp in self.maps:
            if hasattr(mp, "dematerialize"):
                mp.dematerialize()
        return self

    def predict(self, X):
        """(labels, decision_values). Regression: the labels are the
        decision values. Classification: the sign for one output, the
        argmax column otherwise."""
        DV = self.decision_values(X)
        if self.regression:
            return DV, DV
        if self.num_outputs == 1:
            labels = torch.where(DV[:, 0] >= 0, 1, -1)
        else:
            labels = torch.argmax(DV, dim=1)
        return labels, DV

    # -- serialization --

    def to_dict(self) -> dict[str, Any]:
        return {
            "skylark_object_type": "model:linear-on-features",
            "skylark_version": __version__,
            "num_features": self.num_features,
            "num_outputs": self.num_outputs,
            "input_size": self.input_size,
            "regression": self.regression,
            "feature_mapping": {
                "number_maps": len(self.maps),
                "scale_maps": self.scale_maps,
                "maps": [m.to_dict() for m in self.maps],
            },
            "coef_matrix": host_array(self.coef).tolist(),
            **({"label_coding": self.label_coding}
               if self.label_coding is not None else {}),
        }

    def save(self, fname: str, header: str = "") -> None:
        with open(fname, "w") as f:
            if header:
                for line in header.rstrip("\n").split("\n"):
                    f.write(f"# {line}\n" if not line.startswith("#")
                            else line + "\n")
            json.dump(self.to_dict(), f)

    @staticmethod
    def from_dict(d: dict[str, Any], device=None) -> "HilbertModel":
        fm = d["feature_mapping"]
        try:
            maps = [deserialize_sketch(m) for m in fm["maps"]]
        except errors.SketchError as e:
            raise errors.SketchError(
                "model file embeds a feature map from an incompatible "
                f"stream format — retrain or re-serialize the model ({e})"
            ) from e
        return HilbertModel(
            maps,
            bool(fm["scale_maps"]),
            int(d["num_features"]),
            int(d["num_outputs"]),
            bool(d["regression"]),
            input_size=int(d["input_size"]),
            coef=torch.as_tensor(d["coef_matrix"], dtype=torch.float32),
            label_coding=d.get("label_coding"),
            device=device,
        )

    @staticmethod
    def load(fname_or_json: Union[str, dict], device=None) -> "HilbertModel":
        """Load from a file path, a JSON string or a dict. Files may start
        with '#' comment lines."""
        if isinstance(fname_or_json, dict):
            return HilbertModel.from_dict(fname_or_json, device)
        s = fname_or_json
        if "\n" in s or s.lstrip().startswith("{"):
            text = s
        else:
            with open(s) as f:
                text = f.read()
        lines = [ln for ln in text.split("\n") if not ln.startswith("#")]
        return HilbertModel.from_dict(json.loads("\n".join(lines)), device)
