"""Threefry-2x32-20 counter PRNG in plain integer ops.

The port of libskylark_tpu/base/threefry.py: the bit-level definition of
the dense-block operator stream. The same code runs on Python ints (host
side key derivation), CPU tensors, and CUDA tensors (the plain version of
the fused sketch kernel), and csrc/dense_sketch.cu repeats it on the card.

PyTorch has no uint32 add or shift on the CPU, so 32-bit words travel in
int64 tensors (or Python ints) and every operation that can carry past 32
bits is reduced with ``& MASK32``. Inputs must already lie in [0, 2^32).

The cipher is the public Threefry-2x32 with 20 rounds from Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3" (SC'11); it is also what
``jax.random`` runs, which is how :mod:`.context` derives JAX's keys.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# rotation schedule for Threefry-2x32 (Salmon et al. Table 2)
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Encrypt counter words (c0, c1) under key (k0, k1).

    Every argument is a Python int or an int64 tensor holding a uint32
    value; tensors broadcast against each other. Returns the two output
    words, in the same representation."""
    ks2 = k0 ^ k1 ^ _PARITY
    keys = (k0, k1, ks2)
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    for group in range(5):
        rots = _ROTATIONS[:4] if group % 2 == 0 else _ROTATIONS[4:]
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        # key injection after each 4-round group
        x0 = (x0 + keys[(group + 1) % 3]) & MASK32
        x1 = (x1 + keys[(group + 2) % 3] + (group + 1)) & MASK32
    return x0, x1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 tensor) → f32 uniform in [0, 1) with 24-bit
    resolution: the top 24 bits, exactly representable in f32."""
    return (bits >> 8).to(torch.float32) * 2.0**-24


# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2010):
# the single-precision polynomial XLA lowers f32 erf_inv to, highest
# coefficient first, for w < 5 and w >= 5.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _sqrt(w: torch.Tensor) -> torch.Tensor:
    """sqrt(w) rounded to float32 the same on every call. On the CPU,
    torch's float32 sqrt is not always correctly rounded, and in a
    threaded process a call may come back ~1e-4 off; two Newton steps in
    float64 reach the float64 root from either, and it rounds to one
    float32."""
    if w.device.type != "cpu":
        return torch.sqrt(w)
    w = w.double()
    r = torch.sqrt(w)
    for _ in range(2):
        r = 0.5 * (r + w / r)
    return r.to(torch.float32)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 erfinv by the reference's own algorithm (XLA's ErfInv32). It
    agrees with ``lax.erf_inv`` to a few ulp, where ``torch.erfinv``
    differs by up to ~1.5e-5 near ±1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    coef = [torch.where(lt, a, b).to(torch.float32)
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return p * x


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → f32 standard normal via inverse CDF:
    √2·erfinv(2u−1), with 2u−1 clamped away from ±1. Everything up to the
    erfinv is bit-exact; erfinv follows the reference's algorithm
    (:func:`erfinv_f32`), so only its log1p rounds differently."""
    u = bits_to_unit(bits)
    v = (2.0 * u - 1.0).clamp(-1.0 + 2.0**-23, 1.0 - 2.0**-23)
    return 1.4142135623730951 * erfinv_f32(v)


def bits_to_cauchy(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → f32 standard Cauchy: tan(π(u−1/2)), u clamped."""
    v = bits_to_unit(bits).clamp(2.0**-24, 1.0 - 2.0**-24)
    return torch.tan(3.141592653589793 * (v - 0.5))


def bits_to_rademacher(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → ±1 from the top bit."""
    return torch.where((bits >> 31) == 0, 1.0, -1.0).to(torch.float32)


def bits_to_uniform(bits: torch.Tensor, low: float,
                    high: float) -> torch.Tensor:
    return low + bits_to_unit(bits) * (high - low)
