"""Fast unitary transforms: DCT, DHT, WHT (the port of
libskylark_tpu/sketch/fut.py).

The DCT-II and DCT-III are Makhoul's single-FFT forms on ``torch.fft``
(unnormalized, FFTW's REDFT10/REDFT01 conventions), the DHT is
Re(FFT) − Im(FFT), and the WHT (natural/Sylvester ordering) is a
log2(n) butterfly below ``_MATMUL_MIN_N`` and the kron two-matmul form
H_a·X·H_b above it. Both WHT forms add ±1-weighted terms only, so on
integer data they are exact and agree to the bit.

Scale convention as the reference: ``scale() = 1/sqrt(ScaleVal·N)`` with
ScaleVal 2 for the DCT, 1 for the DHT and WHT.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from libskylark_tpu_torch.base import errors

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _twiddle(n: int, sign: float, real_dtype, device) -> torch.Tensor:
    """exp(sign·iπk/2n) for k < n, its angle rounded in ``real_dtype``
    as the reference rounds it."""
    k = torch.arange(n, dtype=real_dtype, device=device)
    angle = (sign * math.pi / (2.0 * n)) * k
    return torch.polar(torch.ones_like(angle), angle).to(_COMPLEX[real_dtype])


def _dct2_last(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized DCT-II along the last axis: v = [x_even,
    reverse(x_odd)], y_k = 2·Re(FFT(v)_k·W_k), W_k = exp(−iπk/2n)."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], torch.flip(x[..., 1::2], [-1])], -1)
    V = torch.fft.fft(v, dim=-1)
    W = _twiddle(n, -1.0, x.dtype, x.device)
    return (2.0 * (V * W).real).to(x.dtype)


def _dct3_last(y: torch.Tensor) -> torch.Tensor:
    """Unnormalized DCT-III (REDFT01) along the last axis: the inverse of
    :func:`_dct2_last` up to the 2n factor."""
    n = y.shape[-1]
    yr = torch.cat([torch.zeros_like(y[..., :1]), torch.flip(y[..., 1:], [-1])],
                   -1)
    W = _twiddle(n, 1.0, y.dtype, y.device)
    V = 0.5 * torch.complex(y, -yr) * W
    v = torch.fft.ifft(V, dim=-1).real.to(y.dtype)
    m = (n + 1) // 2
    x = torch.empty_like(y)
    x[..., ::2] = v[..., :m]
    x[..., 1::2] = torch.flip(v[..., m:], [-1])
    return 2.0 * n * x


def dct(A: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Unnormalized DCT-II (FFTW REDFT10) along ``axis``."""
    return torch.movedim(_dct2_last(torch.movedim(A, axis, -1)), -1, axis)


def idct(A: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Unnormalized DCT-III (FFTW REDFT01) along ``axis``."""
    return torch.movedim(_dct3_last(torch.movedim(A, axis, -1)), -1, axis)


def dht(A: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Discrete Hartley transform: self-inverse up to n."""
    F = torch.fft.fft(A, dim=axis)
    return F.real - F.imag


# Length at which the WHT switches from the butterfly to the kron
# two-matmul form (the reference's threshold).
_MATMUL_MIN_N = 512


@functools.lru_cache(maxsize=None)
def _hadamard(n: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """Dense Sylvester Hadamard H_n (±1, natural ordering), n = 2^k, made
    once per length, dtype and device."""
    H = np.ones((1, 1), np.float64)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return torch.from_numpy(H).to(device=device, dtype=dtype)


def _wht_matmul(A: torch.Tensor, axis: int) -> torch.Tensor:
    """WHT along ``axis`` as H_a·X·H_b over the (a, b)-folded axis:
    x[p·b + q] = X[p, q] gives (H_a ⊗ H_b)x = vec(H_a X H_b)."""
    x = torch.movedim(A, axis, -1)
    n = x.shape[-1]
    k = n.bit_length() - 1
    a, b = 1 << (k - k // 2), 1 << (k // 2)
    Ha = _hadamard(a, x.dtype, str(x.device))
    Hb = _hadamard(b, x.dtype, str(x.device))
    X = x.reshape(x.shape[:-1] + (a, b))
    Y = torch.matmul(torch.matmul(Ha, X), Hb)
    return torch.movedim(Y.reshape(x.shape), -1, axis)


def _wht_butterfly(A: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """log2(n) butterfly passes along ``axis``."""
    x = torch.movedim(A, axis, 0)
    shape = x.shape
    n = shape[0]
    x = x.reshape(n, -1)
    h = 1
    while h < n:
        x = x.reshape(n // (2 * h), 2, h, -1)
        a, b = x[:, 0], x[:, 1]
        x = torch.stack([a + b, a - b], dim=1).reshape(n, -1)
        h *= 2
    return torch.movedim(x.reshape(shape), 0, axis)


def wht(A: torch.Tensor, axis: int = 0, precision=None) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform (natural ordering) along
    ``axis``; the length must be a power of two. ``precision`` is the
    reference's matmul-precision knob, accepted and ignored: the port's
    float32 matmuls are always full float32 (TF32 off)."""
    n = A.shape[axis]
    if n & (n - 1):
        raise errors.InvalidParametersError(
            f"WHT requires power-of-2 length, got {n}")
    if n >= _MATMUL_MIN_N:
        return _wht_matmul(A, axis)
    return _wht_butterfly(A, axis)


# The serve-surface name of the panel-free Hadamard transform.
fwht = wht


def fwht_sketch(A: torch.Tensor, diag: torch.Tensor, idx: torch.Tensor,
                fut_scale: float, samp_scale: float,
                axis: int = 0, precision=None) -> torch.Tensor:
    """samp_scale · gather(fwht((fut_scale · diag) ⊙ A, axis), idx): the
    panel-free SRHT, in the reference's op order. ``axis`` 0 takes
    columnwise operands (n, m), 1 rowwise ones (m, n). ``precision`` is
    accepted and ignored, as in :func:`wht`."""
    if axis == 0:
        mixed = wht(fut_scale * diag[:, None] * A, axis=0)
        return samp_scale * mixed.index_select(0, idx)
    mixed = wht(fut_scale * diag[None, :] * A, axis=1)
    return samp_scale * mixed.index_select(1, idx)


class FUT:
    """A fast unitary transform with the reference's scale convention."""

    name = "fut"

    def __init__(self, n: int):
        self.n = int(n)

    def scale(self) -> float:
        raise NotImplementedError

    def apply(self, A: torch.Tensor, axis: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def apply_inverse(self, A: torch.Tensor, axis: int = 0) -> torch.Tensor:
        raise NotImplementedError


class DCT(FUT):
    """ScaleVal 2."""

    name = "dct"

    def scale(self) -> float:
        return 1.0 / math.sqrt(2.0 * self.n)

    def apply(self, A, axis=0):
        return dct(A, axis)

    def apply_inverse(self, A, axis=0):
        return idct(A, axis)


class DHT(FUT):
    """ScaleVal 1; self-inverse."""

    name = "dht"

    def scale(self) -> float:
        return 1.0 / math.sqrt(self.n)

    def apply(self, A, axis=0):
        return dht(A, axis)

    apply_inverse = apply


class WHT(FUT):
    """Walsh-Hadamard, n a power of two; ScaleVal 1, self-inverse."""

    name = "wht"

    def scale(self) -> float:
        return 1.0 / math.sqrt(self.n)

    def apply(self, A, axis=0, precision=None):
        """``precision`` is accepted and ignored, as in :func:`wht`."""
        return wht(A, axis)

    apply_inverse = apply


_FUTS = {"dct": DCT, "dht": DHT, "wht": WHT}


def make_fut(name: str, n: int) -> FUT:
    cls = _FUTS.get(name)
    if cls is None:
        raise errors.InvalidParametersError(
            f"unknown fast unitary transform {name!r}; expected one of "
            f"{sorted(_FUTS)}")
    return cls(n)
