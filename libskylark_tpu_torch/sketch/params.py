"""Global sketch tuning knobs (the port of libskylark_tpu/sketch/params.py).

``blocksize`` — column-panel width for the memory-bounded dense apply
(0 disables blocking). ``factor`` — the reference's regime-selection
threshold of the distributed apply (kept for it; the one-card applies do
not read it). ``auto_block_bytes`` — with ``blocksize`` unset,
an apply whose full operator would exceed this many bytes runs
panel-blocked anyway. ``auto_materialize`` — the Nth plain-path apply of
one transform pins its operator (bounded by ``auto_materialize_bytes``);
applies that take the fused kernel's route are never auto-switched
(sketch/dense.py). ``pallas_precision`` — contraction regime of the fused
kernel, with the reference's knob and regime names (the port's own
``kernel_precision`` names are aliases of the same knob). ``use_pallas``,
``use_plan_cache`` and ``pallas_m_tile`` — the kernel routes' switch, the
autotuner's consultation and the tiling pin, in the reference's names
(below).
"""

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors

_blocksize = 0
_factor = 20


def get_blocksize() -> int:
    return _blocksize


def set_blocksize(b: int) -> None:
    global _blocksize
    _blocksize = int(b)


def get_factor() -> int:
    return _factor


def set_factor(f: int) -> None:
    global _factor
    _factor = int(f)


_auto_block_bytes = 2 << 30  # 2 GiB


def get_auto_block_bytes() -> int:
    return _auto_block_bytes


def set_auto_block_bytes(b: int) -> None:
    b = int(b)
    if b <= 0:
        raise ValueError(f"auto_block_bytes must be positive, got {b}")
    global _auto_block_bytes
    _auto_block_bytes = b


# ``use_pallas`` — route dense applies through the fused kernel's route
# (the CUDA kernel on a CUDA tensor, its plain version on a CPU one). Off,
# a CPU tensor takes the plain path; a CUDA tensor raises
# (sketch/dense.py ``pallas_ambient_ok``, parallel/shard_apply.py): no
# setting routes a CUDA tensor past the kernel.
_use_pallas = True


def get_use_pallas() -> bool:
    return _use_pallas


def set_use_pallas(on: bool) -> None:
    global _use_pallas
    _use_pallas = bool(on)


# ``use_plan_cache`` — consult the autotuner's plan cache
# (libskylark_tpu_torch/tune/) at dispatch, BEFORE the heuristics. The
# precedence at every dispatch site: an explicit call-site argument >
# an explicit user override (set_pallas_precision, set_pallas_m_tile or
# SKYLARK_PALLAS_MTILE: a sweep or a pin beats a cached winner) > the
# cached plan > the heuristic. Off with SKYLARK_USE_PLAN_CACHE=0 (or
# set_use_plan_cache(False)); the file is SKYLARK_PLAN_CACHE
# (tune/cache.py). Read by B1's single-lane applies
# (sketch/cuda_dense.py), B4's variant="auto" (sketch/cuda_fastfood.py),
# the hash apply (sketch/hash.py) and the serve executor (engine/serve.py).
_use_plan_cache = _env.USE_PLAN_CACHE.get()


def get_use_plan_cache() -> bool:
    return _use_plan_cache


def set_use_plan_cache(on: bool) -> None:
    global _use_plan_cache
    _use_plan_cache = bool(on)


# The reference's regimes (pallas_dense._dot). "bf16x3" (default) and
# "f32" promise f32-grade rounding: the CUDA kernel runs "bf16x3" as three
# bf16 tensor-core passes and "f32" as three tf32 ones (3×TF32, ≈ 2⁻²¹ a
# term where bf16x3 keeps ≈ 2⁻¹⁶). "bf16gen2" (the operator
# rounded to bf16, two passes) and "bf16" (one pass) trade accuracy for
# speed and are opt-in.
KERNEL_PRECISIONS = ("f32", "bf16x3", "bf16", "bf16gen2")
_PALLAS_PRECISION_DEFAULT = "bf16x3"
_kernel_precision = _PALLAS_PRECISION_DEFAULT


class PrecisionNameError(errors.InvalidParametersError, ValueError):
    """An unknown regime name: a ValueError, as in the reference."""


def check_kernel_precision(p: str) -> str:
    """``p`` if it names a kernel regime; raises otherwise."""
    if p in KERNEL_PRECISIONS:
        return p
    raise PrecisionNameError(
        f"pallas_precision must be one of {KERNEL_PRECISIONS}, got {p!r}")


def get_pallas_precision() -> str:
    return _kernel_precision


def set_pallas_precision(p: str) -> None:
    global _kernel_precision
    _kernel_precision = check_kernel_precision(p)


def pallas_precision_overridden() -> bool:
    """True when the regime differs from the shipping default (a pin
    equal to the default is not detected, as in the reference)."""
    return _kernel_precision != _PALLAS_PRECISION_DEFAULT


get_kernel_precision = get_pallas_precision
set_kernel_precision = set_pallas_precision


# ``pallas_m_tile`` — the reference's m-tile knob, kept for its meaning in
# the precedence: a user who sets it (set_pallas_m_tile away from the
# default, or a valid SKYLARK_PALLAS_MTILE) pins the tiling, so B1's
# single-lane applies take make_plan's heuristic n-split instead of a
# cached plan's. It does NOT change B1's row tile, which is 128 rows,
# fixed when the kernel is compiled (csrc/dense_sketch.cu kBM).
_PALLAS_M_TILE_DEFAULT = 512


def _env_m_tile() -> int:
    v = _env.PALLAS_MTILE.get(_PALLAS_M_TILE_DEFAULT)
    return v if v >= 8 else _PALLAS_M_TILE_DEFAULT


_pallas_m_tile = _env_m_tile()


def get_pallas_m_tile() -> int:
    return _pallas_m_tile


def pallas_m_tile_overridden() -> bool:
    """True when the user set the tile explicitly — a valid
    SKYLARK_PALLAS_MTILE (a typo degrades to the default) or
    set_pallas_m_tile away from the default."""
    if _pallas_m_tile != _PALLAS_M_TILE_DEFAULT:
        return True
    v = _env.PALLAS_MTILE.get()
    return v is not None and v >= 8


def set_pallas_m_tile(t: int) -> None:
    t = int(t)
    if t < 8:
        raise ValueError(f"pallas_m_tile must be >= 8, got {t}")
    global _pallas_m_tile
    _pallas_m_tile = t


# SKYLARK_AUTO_MATERIALIZE=0 turns off the pinning of a transform's
# operator after its Nth plain-route apply (read at import, as the
# reference reads it)
_auto_materialize = _env.AUTO_MATERIALIZE.get()
_auto_materialize_after = 3
_auto_materialize_bytes = 64 * 1024 * 1024


def get_auto_materialize() -> bool:
    return _auto_materialize


def set_auto_materialize(on: bool) -> None:
    global _auto_materialize
    _auto_materialize = bool(on)


def get_auto_materialize_after() -> int:
    return _auto_materialize_after


def set_auto_materialize_after(n: int) -> None:
    n = int(n)
    if n < 1:
        raise ValueError(f"auto_materialize_after must be >= 1, got {n}")
    global _auto_materialize_after
    _auto_materialize_after = n


def get_auto_materialize_bytes() -> int:
    return _auto_materialize_bytes


def set_auto_materialize_bytes(b: int) -> None:
    b = int(b)
    if b <= 0:
        raise ValueError(
            f"auto_materialize_bytes must be > 0, got {b} "
            "(use set_auto_materialize(False) to disable the dispatch)")
    global _auto_materialize_bytes
    _auto_materialize_bytes = b
