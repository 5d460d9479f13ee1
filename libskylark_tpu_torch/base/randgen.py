"""Counter-based random streams: the dense-block operator format.

The port of the dense-block part of libskylark_tpu/base/randgen.py. A
virtual i.i.d. (rows × n) matrix is cut into column blocks of
``block_cols``; block ``b`` is a pure function of the allocation key and
``b``, so any column panel can be made without the rest:

- the block key is ``chunk_key(key, b)`` = fold_in(fold_in(key, b>>31),
  b & (2^31−1));
- with half = block_cols/2 and counter c[r, j] = r·half + j, Threefry of
  (c, c + rows·half) gives two words; word 0 is column j and word 1 is
  column half + j, each mapped to a value by the distribution's
  ``from_bits``.

The counter-stream samplers (``stream_slice``/``stream_chunks``) and the
distributions with no bit transform are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import threefry as tf
from libskylark_tpu_torch.base.context import fold_in, key_words

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


# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------


class Distribution:
    """A named, serializable map from uint32 bits to samples."""

    name: str = "distribution"

    def from_bits(self, bits: torch.Tensor) -> torch.Tensor:
        """Map uint32 bits (int64 tensor) to f32 samples."""
        raise errors.NotImplementedYetError(
            f"{self.name} has no bit transform")

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


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    low: float = 0.0
    high: float = 1.0
    name = "uniform"

    def from_bits(self, bits):
        return tf.bits_to_uniform(bits, self.low, self.high)


@dataclasses.dataclass(frozen=True)
class Cauchy(Distribution):
    loc: float = 0.0
    scale: float = 1.0
    name = "cauchy"

    def from_bits(self, bits):
        return self.loc + self.scale * tf.bits_to_cauchy(bits)


@dataclasses.dataclass(frozen=True)
class Rademacher(Distribution):
    name = "rademacher"

    def from_bits(self, bits):
        return tf.bits_to_rademacher(bits)


_DIST_REGISTRY = {cls.name: cls
                  for cls in [Normal, Uniform, Cauchy, Rademacher]}


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
    if type(dist).from_bits is Distribution.from_bits or block_cols % 2:
        raise errors.NotImplementedYetError(
            f"dense blocks of {dist.name} need the jax.random samplers, "
            "which are not ported yet")
    b0 = col_start // block_cols
    b1 = -(-col_stop // block_cols)
    half = block_cols // 2
    keys = torch.from_numpy(
        chunk_keys(key, b0, b1 - b0).astype(np.int64)).to(device)
    k0 = keys[:, 0].view(-1, 1, 1)
    k1 = keys[:, 1].view(-1, 1, 1)
    c = (torch.arange(rows, dtype=torch.int64, device=device)[:, None] * half
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
