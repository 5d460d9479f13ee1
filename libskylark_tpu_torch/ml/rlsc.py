"""Regularized least squares classification (the port of
libskylark_tpu/ml/rlsc.py): dummy-code the labels into a ±1 one-vs-all
target matrix, run the matching KRR solver, and return the solution with
the coding (label order) that decodes argmax predictions."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.ml import krr
from libskylark_tpu_torch.ml.coding import dummy_coding, host_array
from libskylark_tpu_torch.ml.kernels import Kernel


@dataclasses.dataclass
class RlscParams(Params):
    use_fast: bool = False
    sketched_rls: bool = False
    sketch_size: int = -1
    fast_sketch: bool = False
    iter_lim: int = 1000
    res_print: int = 10
    tolerance: float = 1e-3
    max_split: int = 0


def _krr_params(params: RlscParams) -> krr.KrrParams:
    """The shared knobs forwarded, the log level one lower, to the
    caller's log stream."""
    return krr.KrrParams(
        am_i_printing=params.am_i_printing,
        log_level=params.log_level - 1,
        prefix=params.prefix + "\t",
        log_stream=params.log_stream,
        use_fast=params.use_fast,
        sketched_rr=params.sketched_rls,
        sketch_size=params.sketch_size,
        fast_sketch=params.fast_sketch,
        iter_lim=params.iter_lim,
        res_print=params.res_print,
        tolerance=params.tolerance,
        max_split=params.max_split,
    )


def _coded(X, labels, device):
    """X on ``device`` and the labels' ±1 coding beside it."""
    X = as_tensor(X, device)
    Y, coding = dummy_coding(labels, dtype=X.dtype, device=X.device)
    return X, Y, coding


def kernel_rlsc(k: Kernel, X, labels, lam: float,
                params: Optional[RlscParams] = None, device=None):
    """Exact RLSC. Returns (A, coding); predict with
    ``dummy_decode(gram(X_new, X)·A, coding)`` or :func:`rlsc_predict`."""
    X, Y, coding = _coded(X, labels, device)
    A = krr.kernel_ridge(k, X, Y, lam, _krr_params(params or RlscParams()),
                         X.device)
    return A, coding


def approximate_kernel_rlsc(k: Kernel, X, labels, lam: float, s: int,
                            context: Context,
                            params: Optional[RlscParams] = None,
                            device=None):
    """Random-features RLSC. Returns (S, W, coding)."""
    X, Y, coding = _coded(X, labels, device)
    S, W = krr.approximate_kernel_ridge(
        k, X, Y, lam, s, context, _krr_params(params or RlscParams()),
        X.device)
    return S, W, coding


def sketched_approximate_kernel_rlsc(k: Kernel, X, labels, lam: float,
                                     s: int, context: Context, t: int = -1,
                                     params: Optional[RlscParams] = None,
                                     device=None):
    """Sketched split-features RLSC. Returns (transforms, W, coding)."""
    X, Y, coding = _coded(X, labels, device)
    transforms, W = krr.sketched_approximate_kernel_ridge(
        k, X, Y, lam, s, context, t, _krr_params(params or RlscParams()),
        X.device)
    return transforms, W, coding


def faster_kernel_rlsc(k: Kernel, X, labels, lam: float, s: int,
                       context: Context,
                       params: Optional[RlscParams] = None, device=None):
    """CG with the random-features preconditioner. Returns (A, coding)."""
    X, Y, coding = _coded(X, labels, device)
    A = krr.faster_kernel_ridge(k, X, Y, lam, s, context,
                                _krr_params(params or RlscParams()),
                                X.device)
    return A, coding


def large_scale_kernel_rlsc(k: Kernel, X, labels, lam: float, s: int,
                            context: Context,
                            params: Optional[RlscParams] = None,
                            device=None):
    """Block-coordinate-descent RLSC. Returns (transforms, W, coding)."""
    X, Y, coding = _coded(X, labels, device)
    transforms, W = krr.large_scale_kernel_ridge(
        k, X, Y, lam, s, context, _krr_params(params or RlscParams()),
        X.device)
    return transforms, W, coding


def rlsc_predict_kernel(k: Kernel, X_new, X_train, A) -> torch.Tensor:
    """Argmax over the one-vs-all KRR scores: int64 class indices into
    the dummy coding."""
    return torch.argmax(krr.krr_predict_kernel(k, X_new, X_train, A), dim=1)


def rlsc_predict(k: Kernel, X_new, X_train, A, coding=None, device=None):
    """RLSC prediction: argmax class indices, decoded to labels when
    ``coding`` (the label order :func:`dummy_coding` returned) is
    given."""
    X_new = as_tensor(X_new, device)
    squeeze = X_new.ndim == 1
    if squeeze:
        X_new = X_new[None, :]
    idx = host_array(rlsc_predict_kernel(
        k, X_new, as_tensor(X_train, X_new.device),
        as_tensor(A, X_new.device)))
    out = idx if coding is None else np.asarray([coding[i] for i in idx])
    return out[0] if squeeze else out
