"""Counter-based random streams (the port of libskylark_tpu/base/randgen.py).

Two formats, both pure functions of the allocation key:

- **Counter streams** (``stream_slice``/``stream_chunks``): a virtual
  i.i.d. sequence cut into chunks of ``CHUNK``; chunk ``c`` is
  ``dist.sample(chunk_key(key, c), CHUNK)`` with jax.random's own
  samplers, replicated here bit for bit in the layout of JAX's
  partitionable Threefry: ``bits(k, (L,))[j]`` is x0 ^ x1 of Threefry
  under k at the counter words (j >> 32, j & 0xFFFFFFFF), and
  ``split(k)[i]`` is the Threefry pair at (0, i).
- **Dense blocks** (``dense_block``/``dense_panel``): a virtual (rows ×
  n) matrix cut into column blocks of ``block_cols``; with half =
  block_cols/2 and counter c[r, j] = r·half + j, Threefry of (c, c +
  rows·half) under ``chunk_key(key, b)`` gives two words, column j and
  column half + j of block b, mapped by the distribution's
  ``from_bits``. A distribution without a bit transform (StandardLevy)
  keeps the legacy format: block b is its jax.random sampler's
  ``sample(chunk_key(key, b), (rows, block_cols))``, drawn over the
  block's flat index.

The chunk key is ``chunk_key(key, c)`` = fold_in(fold_in(key, c>>31),
c & (2^31−1)) in both. :func:`permutation` is jax.random.permutation's
sort shuffle. Gamma is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import threefry as tf
from libskylark_tpu_torch.base.context import fold_in, key_words

# Elements per stream chunk; part of the stream format.
CHUNK = 4096

_MASK31 = (1 << 31) - 1


def chunk_key(key, cid: int) -> np.ndarray:
    """Key data for chunk (or column block) ``cid`` of a stream."""
    cid = int(cid)
    return fold_in(fold_in(key, cid >> 31), cid & _MASK31)


def chunk_keys(key, first: int, count: int) -> np.ndarray:
    """``chunk_key`` for ids first..first+count-1, as a uint32 (count, 2)
    array (one vectorized pass of the cipher on the host)."""
    k0, k1 = key_words(key)
    cids = np.arange(int(first), int(first) + int(count), dtype=np.int64)
    zero = np.zeros_like(cids)
    h0, h1 = tf.threefry2x32(k0, k1, zero, cids >> 31)
    b0, b1 = tf.threefry2x32(h0, h1, zero, cids & _MASK31)
    return np.stack([b0, b1], axis=1).astype(np.uint32)


def split_keys(keys):
    """``jax.random.split(k)`` for each row k of ``keys`` ((C, 2) uint32
    words as a numpy array or an int64 tensor): the pair (k_a, k_b) of
    (C, 2) arrays, k_a the Threefry pair at counters (0, 0) and k_b at
    (0, 1)."""
    if isinstance(keys, torch.Tensor):
        ctr = torch.arange(2, dtype=torch.int64, device=keys.device)
        x0, x1 = tf.threefry2x32(keys[:, :1], keys[:, 1:], 0, ctr)
        return (torch.stack([x0[:, 0], x1[:, 0]], 1),
                torch.stack([x0[:, 1], x1[:, 1]], 1))
    k = np.asarray(keys).astype(np.int64)
    x0, x1 = tf.threefry2x32(k[:, :1], k[:, 1:], 0, np.arange(2))
    return (np.stack([x0[:, 0], x1[:, 0]], 1).astype(np.uint32),
            np.stack([x0[:, 1], x1[:, 1]], 1).astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """Key data of ``jax.random.split(key, num)``: (num, 2) uint32."""
    k0, k1 = key_words(key)
    x0, x1 = tf.threefry2x32(k0, k1, 0, np.arange(int(num)))
    return np.stack([x0, x1], axis=1).astype(np.uint32)


def chunk_bits(keys: torch.Tensor, length: int) -> torch.Tensor:
    """``jax.random.bits(k, (length,))`` for each row k of ``keys`` ((C,
    2) int64 tensor of uint32 words): (C, length) int64 words."""
    j = torch.arange(length, dtype=torch.int64, device=keys.device)
    x0, x1 = tf.threefry2x32(keys[:, :1], keys[:, 1:], j >> 32,
                             j & tf.MASK32)
    return x0 ^ x1


def bits(key, length: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (length,))`` as an int64 tensor."""
    keys = torch.tensor([list(key_words(key))], dtype=torch.int64,
                        device=device)
    return chunk_bits(keys, length)[0]


def randint_multiplier(span: int) -> int:
    """jax.random.randint's double-draw multiplier for ``span``, in its
    uint32 arithmetic: (2^16 mod span)² mod 2^32, mod span. Zero for every
    power-of-two span and for every span above 2^16."""
    m = (1 << 16) % span
    return ((m * m) & tf.MASK32) % span


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform's mantissa fill: the top 23 bits under the
    exponent of 1.0, minus 1 — f32 in [0, 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _uniform(bits: torch.Tensor, low, high) -> torch.Tensor:
    """``jax.random.uniform(k, minval=low, maxval=high)`` from its bits:
    max(low, floats·(high − low) + low) in f32, the multiply-add rounded
    once, as the fused multiply-add XLA's CPU backend forms. The product
    of two f32 values is exact in f64, so the f64 multiply-add rounded to
    f32 gives the same bits."""
    lo = np.float32(low)
    span = float(np.float32(high) - lo)
    fma = (_unit_floats(bits).double() * span + float(lo)).float()
    return torch.clamp_min(fma, float(lo))


# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------


class Distribution:
    """A named, serializable map from uint32 bits to samples."""

    name: str = "distribution"

    def from_bits(self, bits: torch.Tensor) -> torch.Tensor:
        """Map uint32 bits (int64 tensor) to f32 samples (the dense-block
        format)."""
        raise errors.NotImplementedYetError(
            f"{self.name} has no bit transform")

    def sample_chunks(self, keys: torch.Tensor, length: int) -> torch.Tensor:
        """The jax.random sampler of this distribution, ``sample(k,
        (length,))``, for each row k of ``keys`` ((C, 2) int64 words):
        (C, length) samples, f32 (int64 for integer distributions)."""
        raise errors.NotImplementedYetError(
            f"the {self.name} sampler is not ported yet")

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)  # type: ignore[call-overload]
        d["distribution"] = self.name
        return d

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Distribution":
        d = dict(d)
        name = d.pop("distribution")
        cls = _DIST_REGISTRY.get(name)
        if cls is None:
            raise errors.NotImplementedYetError(
                f"distribution {name!r} is not ported yet")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    mean: float = 0.0
    std: float = 1.0
    name = "normal"

    def from_bits(self, bits):
        return self.mean + self.std * tf.bits_to_normal(bits)

    def sample_chunks(self, keys, length):
        # jr.normal: √2·erf_inv(uniform(nextafter(−1, 0), 1))
        u = _uniform(chunk_bits(keys, length),
                     np.nextafter(np.float32(-1), np.float32(0)), 1.0)
        return self.mean + self.std * (_SQRT2 * tf.erfinv_f32(u))


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    low: float = 0.0
    high: float = 1.0
    name = "uniform"

    def from_bits(self, bits):
        return tf.bits_to_uniform(bits, self.low, self.high)

    def sample_chunks(self, keys, length):
        return _uniform(chunk_bits(keys, length), self.low, self.high)


@dataclasses.dataclass(frozen=True)
class UniformInt(Distribution):
    """Uniform integers in [low, high] inclusive: jax.random.randint's
    double draw, ``((hi mod span)·mult + lo mod span) mod span`` in uint32
    arithmetic, with (k_hi, k_lo) = split(k)."""

    low: int = 0
    high: int = 1
    name = "uniform_int"

    def sample_chunks(self, keys, length):
        span = self.high + 1 - self.low
        span = span & tf.MASK32 if span > 0 else 1
        k_hi, k_lo = split_keys(keys)
        lo = chunk_bits(k_lo, length) % span
        mult = randint_multiplier(span)
        if mult:
            hi = chunk_bits(k_hi, length) % span
            lo = (((hi * mult) & tf.MASK32) + lo) & tf.MASK32
        return self.low + lo % span


@dataclasses.dataclass(frozen=True)
class Cauchy(Distribution):
    loc: float = 0.0
    scale: float = 1.0
    name = "cauchy"

    def from_bits(self, bits):
        return self.loc + self.scale * tf.bits_to_cauchy(bits)

    def sample_chunks(self, keys, length):
        # jr.cauchy: tan(π·(uniform(eps, 1) − 1/2))
        u = _uniform(chunk_bits(keys, length), np.finfo(np.float32).eps,
                     1.0)
        return self.loc + self.scale * torch.tan(_PI * (u - 0.5))


@dataclasses.dataclass(frozen=True)
class Rademacher(Distribution):
    name = "rademacher"

    def from_bits(self, bits):
        return tf.bits_to_rademacher(bits)

    def sample_chunks(self, keys, length):
        # jr.rademacher: +1 where uniform < 1/2, i.e. the top bit is 0
        return tf.bits_to_rademacher(chunk_bits(keys, length))


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    rate: float = 1.0
    name = "exponential"

    def sample_chunks(self, keys, length):
        # jr.exponential: −log1p(−uniform(0, 1))
        u = _uniform(chunk_bits(keys, length), 0.0, 1.0)
        return -torch.log1p(-u) / self.rate


@dataclasses.dataclass(frozen=True)
class StandardLevy(Distribution):
    """Standard Levy, 1/Z² with Z ~ N(0, 1): jax.random.normal's draw,
    then 1/max(z², tiny). No bit transform: its dense blocks take the
    legacy format."""

    name = "standard_levy"

    def sample_chunks(self, keys, length):
        z = Normal().sample_chunks(keys, length)
        return 1.0 / torch.clamp_min(z * z, _TINY)


_SQRT2 = float(np.float32(np.sqrt(2)))
_TINY = float(np.finfo(np.float32).tiny)
_PI = float(np.float32(np.pi))

_DIST_REGISTRY = {cls.name: cls
                  for cls in [Normal, Uniform, UniformInt, Cauchy,
                              Rademacher, StandardLevy, Exponential]}


# ---------------------------------------------------------------------------
# Counter streams
# ---------------------------------------------------------------------------


def stream_chunks(key, dist: Distribution, first_cid: int, n_chunks: int,
                  dtype=None, device=None) -> torch.Tensor:
    """Whole chunks first_cid..first_cid+n_chunks−1 of the stream, flat:
    (n_chunks·CHUNK,) on ``device``; ``dtype`` None keeps the sampler's
    own (f32, or int64 for integers)."""
    keys = torch.from_numpy(
        chunk_keys(key, first_cid, n_chunks).astype(np.int64)).to(device)
    vals = dist.sample_chunks(keys, CHUNK).reshape(-1)
    return vals if dtype is None else vals.to(dtype)


def permutation(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 tensor: arange(n)
    reordered by ceil(3·ln n / ln(2³²−1)) rounds (float64, as JAX
    computes it) of a stable sort on 32-bit keys, each round's keys
    ``bits(subkey, (n,))`` with (key, subkey) = split(key)."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, n, device), stable=True).indices
        x = x[order]
    return x


def stream_slice(key, dist: Distribution, start: int, stop: int, dtype=None,
                 device=None) -> torch.Tensor:
    """Elements [start, stop) of the virtual stream, made from their
    covering chunks alone: the result does not depend on what other
    slices anyone makes."""
    start, stop = int(start), int(stop)
    if stop <= start:
        return torch.zeros((0,), dtype=dtype or torch.float32, device=device)
    c0 = start // CHUNK
    c1 = -(-stop // CHUNK)
    flat = stream_chunks(key, dist, c0, c1 - c0, dtype, device)
    return flat[start - c0 * CHUNK:stop - c0 * CHUNK]


# ---------------------------------------------------------------------------
# Dense blocks
# ---------------------------------------------------------------------------


def dense_panel(
    key,
    dist: Distribution,
    rows: int,
    col_start: int,
    col_stop: int,
    block_cols: int,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Columns [col_start, col_stop) of the virtual (rows × n) matrix in
    the dense-block format, generated on ``device`` (CPU by default)."""
    b0 = col_start // block_cols
    b1 = -(-col_stop // block_cols)
    keys = torch.from_numpy(
        chunk_keys(key, b0, b1 - b0).astype(np.int64)).to(device)
    if type(dist).from_bits is Distribution.from_bits or block_cols % 2:
        # the legacy format: the sampler over each block's flat index
        blocks = dist.sample_chunks(keys, rows * block_cols).reshape(
            b1 - b0, rows, block_cols)
    else:
        half = block_cols // 2
        k0 = keys[:, 0].view(-1, 1, 1)
        k1 = keys[:, 1].view(-1, 1, 1)
        c = (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
             * half
             + torch.arange(half, dtype=torch.int64, device=device)[None, :])
        w0, w1 = tf.threefry2x32(k0, k1, c, (c + rows * half) & tf.MASK32)
        blocks = torch.cat([dist.from_bits(w0), dist.from_bits(w1)], dim=2)
    panel = blocks.permute(1, 0, 2).reshape(rows, (b1 - b0) * block_cols)
    lo = col_start - b0 * block_cols
    return panel[:, lo:lo + col_stop - col_start].to(dtype)


def dense_block(key, dist: Distribution, rows: int, block_id: int,
                block_cols: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Column block ``block_id`` (rows × block_cols) of the virtual
    matrix of :func:`dense_panel`."""
    return dense_panel(key, dist, rows, block_id * block_cols,
                       (block_id + 1) * block_cols, block_cols, dtype,
                       device)
