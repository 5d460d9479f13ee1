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
sort shuffle. :class:`Gamma` is jax.random.gamma's Marsaglia–Tsang
rejection sampler, run as one masked loop over all elements.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.base import threefry as tf
from libskylark_tpu_torch.base.context import fold_in, key_words
from libskylark_tpu_torch.base.device import resolve_device

# Elements per stream chunk; part of the stream format.
CHUNK = 4096

_MASK31 = (1 << 31) - 1

# dense-block panels made in torch (:func:`dense_panel`, the operator of
# every plain dense route): the kernels' routes never make one, which the
# serve layer's flushes are held to
panels = {"dense_panel": 0}
_panel_lock = _locks.make_lock("randgen.panels")


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A small host-made tensor (key words, chunk keys) on ``device``,
    copied without waiting for the device: CUDA stages a pageable source
    at once, so the source may go, and the caller's launches queue behind
    the copy. No host sync, so a hit of a compiled body that refills its
    per-seed streams makes none (engine/compiled.py)."""
    return t.to(device, non_blocking=True)


def chunk_key(key, cid: int) -> np.ndarray:
    """Key data for chunk (or column block) ``cid`` of a stream."""
    cid = int(cid)
    return fold_in(fold_in(key, cid >> 31), cid & _MASK31)


def chunk_keys(key, first: int, count: int) -> np.ndarray:
    """``chunk_key`` for ids first..first+count-1, as a uint32 (count, 2)
    array (one vectorized pass of the cipher on the host)."""
    k0, k1 = key_words(key)
    return chunk_keys_batched(np.array([[k0, k1]]), first, count)[0]


def key_tensor(keys) -> torch.Tensor:
    """(B, 2) key words held in a tensor, as int64 uint32 values: the
    kernels' int32 form (the bits of uint32 words) or int64 words."""
    k = keys.reshape(-1, 2)
    return k.to(torch.int64) & tf.MASK32 if k.dtype == torch.int32 else k


def chunk_keys_batched(keys, first: int, count: int):
    """:func:`chunk_keys` for each row of ``keys`` ((B, 2) uint32 words):
    a (B, count, 2) uint32 array. Keys held in a tensor
    (:func:`key_tensor`) stay on its device: the result is an int64
    tensor there, made with no host read or copy (the form a captured
    serve flush makes its streams in, engine/serve.py)."""
    if isinstance(keys, torch.Tensor):
        k = key_tensor(keys)
        cids = torch.arange(int(first), int(first) + int(count),
                            dtype=torch.int64, device=k.device)
        h0, h1 = tf.threefry2x32(k[:, :1], k[:, 1:], 0, cids >> 31)
        b0, b1 = tf.threefry2x32(h0, h1, 0, cids & _MASK31)
        return torch.stack([b0, b1], dim=2)
    k = np.asarray(keys).astype(np.int64)
    cids = np.arange(int(first), int(first) + int(count), dtype=np.int64)
    zero = np.zeros_like(cids)
    h0, h1 = tf.threefry2x32(k[:, :1], k[:, 1:], zero, cids >> 31)
    b0, b1 = tf.threefry2x32(h0, h1, zero, cids & _MASK31)
    return np.stack([b0, b1], axis=2).astype(np.uint32)


def fold_in_batched(keys, data):
    """``fold_in(k, d)`` for each row k of ``keys`` ((B, 2) uint32 words)
    with ``data`` a scalar or a (B,) array: (B, 2) uint32. Keys held in a
    tensor give an int64 tensor on its device (``data`` then a Python int
    or a tensor there)."""
    if isinstance(keys, torch.Tensor):
        k = key_tensor(keys)
        x0, x1 = tf.threefry2x32(k[:, 0], k[:, 1], 0, data)
        return torch.stack([x0, x1], dim=1)
    k = np.asarray(keys).astype(np.int64)
    d = np.broadcast_to(np.asarray(data, dtype=np.int64), k.shape[:1])
    x0, x1 = tf.threefry2x32(k[:, 0], k[:, 1], np.zeros_like(d), d)
    return np.stack([x0, x1], axis=1).astype(np.uint32)


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
    keys = upload(torch.tensor([list(key_words(key))], dtype=torch.int64),
                  device)
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

    def sample(self, key, shape, dtype=None, device=None) -> torch.Tensor:
        """``sample(key, shape)`` of the reference: this distribution's
        jax.random sampler under the (2,) uint32 key data ``key``, over the
        flat row-major index of ``shape``, on ``device`` (the package
        default when None); ``dtype`` None keeps the sampler's own (f32,
        or int64 for integers)."""
        shape = (tuple(int(d) for d in shape)
                 if isinstance(shape, (tuple, list)) else (int(shape),))
        keys = torch.tensor([list(key_words(key))], dtype=torch.int64,
                            device=resolve_device(device))
        vals = self.sample_chunks(keys, int(np.prod(shape))).reshape(shape)
        return vals if dtype is None else vals.to(dtype)

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


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Gamma(shape_param, scale): ``scale`` times jax.random.gamma's
    standard draw. Element i of ``sample(k, (L,))`` runs Marsaglia–Tsang
    under the i-th key of ``split(k, L)`` (:func:`gamma_standard`)."""

    shape_param: float = 1.0
    scale: float = 1.0
    name = "gamma"

    def sample_chunks(self, keys, length):
        ctr = torch.arange(int(length), dtype=torch.int64, device=keys.device)
        x0, x1 = tf.threefry2x32(keys[:, :1], keys[:, 1:], 0, ctr)
        ek = torch.stack([x0.reshape(-1), x1.reshape(-1)], 1)
        g = gamma_standard(ek, self.shape_param)
        return (self.scale * g).reshape(keys.shape[0], int(length))


def _split3(keys: torch.Tensor):
    """``jax.random.split(k, 3)`` of each row of ``keys``."""
    ctr = torch.arange(3, dtype=torch.int64, device=keys.device)
    x0, x1 = tf.threefry2x32(keys[:, :1], keys[:, 1:], 0, ctr)
    return [torch.stack([x0[:, i], x1[:, i]], 1) for i in range(3)]


def _scalar_uniform(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(k, ())`` for each row k of ``keys``."""
    return _uniform(chunk_bits(keys, 1)[:, 0], 0.0, 1.0)


def gamma_standard(keys: torch.Tensor, alpha: float) -> torch.Tensor:
    """jax.random.gamma's standard draw (``_gamma_one``, JAX 0.9) under
    each row of ``keys`` ((n, 2) int64 words), shape ``alpha``: f32 (n,).

    Per element: alpha < 1 is boosted to alpha + 1; d = alpha − 1/3,
    c = (1/3)/√d; (key, sub) = split(k); each outer round splits key in
    three (key, x_key, u_key), then draws x = normal(s) with (x_key, s) =
    split(x_key) until v = 1 + x·c > 0, and U = uniform(u_key); it
    rejects while U ≥ 1 − 0.0331·X² and log U ≥ X/2 + d·(1 − V + log V)
    (X = x², V = v³). The sample is d·V, times (1 − uniform(sub))^(1/alpha)
    when boosted. Both of JAX's loops run here as one masked loop: each
    round every element still rejecting takes one normal draw, and the
    host reads one flag a round (any element still rejecting?)."""
    f32 = torch.float32
    a0 = np.float32(alpha)
    boost = bool(a0 < 1)
    a = np.float32(a0 + np.float32(1)) if boost else a0
    d = np.float32(a - np.float32(1.0 / 3.0))
    c = np.float32(np.float32(1.0 / 3.0) / np.sqrt(d, dtype=np.float32))
    key, sub = split_keys(keys)
    key, xk, uk = _split3(key)
    n = keys.shape[0]
    V = torch.zeros(n, dtype=f32, device=keys.device)
    todo = torch.ones(n, dtype=torch.bool, device=keys.device)
    while True:
        xk_next, s = split_keys(xk)
        x = Normal().sample_chunks(s, 1)[:, 0]
        v = 1.0 + x * float(c)
        drawn = todo & (v > 0)
        X = x * x
        V3 = v * v * v
        U = _scalar_uniform(uk)
        reject = ((U >= 1.0 - float(np.float32(0.0331)) * (X * X))
                  & (torch.log(U) >= X * 0.5 + float(d) * (
                      (1.0 - V3) + torch.log(V3))))
        done = drawn & ~reject
        V = torch.where(done, V3, V)
        again = drawn & reject
        nkey, nxk, nuk = _split3(key)
        key = torch.where(again[:, None], nkey, key)
        uk = torch.where(again[:, None], nuk, uk)
        xk = torch.where(again[:, None], nxk,
                         torch.where((todo & ~drawn)[:, None], xk_next, xk))
        todo = todo & ~done
        if not bool(todo.any()):
            break
    out = float(d) * V
    if boost:
        u = 1.0 - _scalar_uniform(sub)
        out = out * torch.pow(u, float(np.float32(np.float32(1) / a0)))
    return out


_SQRT2 = float(np.float32(np.sqrt(2)))
_TINY = float(np.finfo(np.float32).tiny)
_PI = float(np.float32(np.pi))

_DIST_REGISTRY = {cls.name: cls
                  for cls in [Normal, Uniform, UniformInt, Cauchy,
                              Rademacher, StandardLevy, Exponential,
                              Gamma]}


# ---------------------------------------------------------------------------
# Counter streams
# ---------------------------------------------------------------------------


def stream_chunks(key, dist: Distribution, first_cid: int, n_chunks: int,
                  dtype=None, device=None, chunk: int = CHUNK) -> torch.Tensor:
    """Whole chunks first_cid..first_cid+n_chunks−1 of the stream, flat:
    (n_chunks·chunk,) on ``device``; ``dtype`` None keeps the sampler's
    own (f32, or int64 for integers). ``chunk`` is part of the stream's
    format: another value makes another stream."""
    keys = torch.from_numpy(
        chunk_keys(key, first_cid, n_chunks).astype(np.int64))
    keys = upload(keys, device)
    vals = dist.sample_chunks(keys, int(chunk)).reshape(-1)
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


def permutation_batched(keys, n: int, device=None) -> torch.Tensor:
    """:func:`permutation` for each row of ``keys`` ((R, 2) uint32 words),
    all rows at once: each round is one Threefry pass over the (R, n)
    words and one row-wise stable sort. Returns (R, n) int64, on the
    device of ``keys`` when they are a tensor (:func:`key_tensor`)."""
    n = int(n)
    if isinstance(keys, torch.Tensor):
        k = key_tensor(keys)
        device = k.device
    else:
        k = np.asarray(keys).astype(np.int64)
    x = torch.arange(n, dtype=torch.int64, device=device).expand(
        k.shape[0], n)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split_keys(k)
        if not isinstance(sub, torch.Tensor):
            sub = upload(torch.from_numpy(sub.astype(np.int64)), device)
        words = chunk_bits(sub, n)
        x = torch.gather(x, 1, torch.sort(words, dim=1, stable=True).indices)
    return x


def stream_slice_batched(keys, dist: Distribution, start: int, stop: int,
                         dtype=None, device=None) -> torch.Tensor:
    """:func:`stream_slice` of each row of ``keys`` ((B, 2) uint32 words),
    made in one pass over all rows: (B, stop − start) on ``device``, or on
    the device of ``keys`` when they are a tensor (:func:`key_tensor`):
    then nothing is read or copied from the host."""
    start, stop = int(start), int(stop)
    if isinstance(keys, torch.Tensor):
        keys = key_tensor(keys)
        device = keys.device
    B = keys.shape[0]
    if stop <= start:
        return torch.zeros((B, 0), dtype=dtype or torch.float32,
                           device=device)
    c0 = start // CHUNK
    c1 = -(-stop // CHUNK)
    ck = chunk_keys_batched(keys, c0, c1 - c0).reshape(-1, 2)
    if not isinstance(ck, torch.Tensor):
        ck = upload(torch.from_numpy(ck.astype(np.int64)), device)
    vals = dist.sample_chunks(ck, CHUNK)
    vals = vals.reshape(B, -1)[:, start - c0 * CHUNK:stop - c0 * CHUNK]
    return vals if dtype is None else vals.to(dtype)


def stream_slice(key, dist: Distribution, start: int, stop: int, dtype=None,
                 device=None, chunk: int = CHUNK) -> torch.Tensor:
    """Elements [start, stop) of the virtual stream, made from their
    covering chunks alone: the result does not depend on what other
    slices anyone makes."""
    start, stop, chunk = int(start), int(stop), int(chunk)
    if stop <= start:
        return torch.zeros((0,), dtype=dtype or torch.float32, device=device)
    c0 = start // chunk
    c1 = -(-stop // chunk)
    flat = stream_chunks(key, dist, c0, c1 - c0, dtype, device, chunk)
    return flat[start - c0 * chunk:stop - c0 * chunk]


# ---------------------------------------------------------------------------
# Dense blocks
# ---------------------------------------------------------------------------


def block_keys(key, col_start: int, col_stop: int, block_cols: int,
               device=None) -> torch.Tensor:
    """The chunk keys of the column blocks that cover [col_start,
    col_stop): (blocks, 2) int64 words on ``device``."""
    b0 = col_start // block_cols
    b1 = -(-col_stop // block_cols)
    return upload(torch.from_numpy(
        chunk_keys(key, b0, b1 - b0).astype(np.int64)), device)


def dense_panel(
    key,
    dist: Distribution,
    rows: int,
    col_start: int,
    col_stop: int,
    block_cols: int,
    dtype=torch.float32,
    device=None,
    keys=None,
) -> torch.Tensor:
    """Columns [col_start, col_stop) of the virtual (rows × n) matrix in
    the dense-block format, generated on ``device`` (CPU by default);
    counted in ``panels``. ``keys``: the blocks' :func:`block_keys`, when
    made beforehand (a compiled body's input), else made here."""
    with _panel_lock:
        panels["dense_panel"] += 1
    b0 = col_start // block_cols
    b1 = -(-col_stop // block_cols)
    if keys is None:
        keys = block_keys(key, col_start, col_stop, block_cols, device)
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
