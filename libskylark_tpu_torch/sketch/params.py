"""Global sketch tuning knobs (the port of libskylark_tpu/sketch/params.py).

``blocksize`` — column-panel width for the memory-bounded dense apply
(0 disables blocking). ``auto_block_bytes`` — with ``blocksize`` unset,
an apply whose full operator would exceed this many bytes runs
panel-blocked anyway. ``auto_materialize`` — the Nth plain-path apply of
one transform pins its operator (bounded by ``auto_materialize_bytes``);
applies that take the fused kernel's route are never auto-switched
(sketch/dense.py). ``kernel_precision`` — contraction regime of the fused
kernel, with the reference's regime names.
"""

from libskylark_tpu_torch.base import errors

_blocksize = 0


def get_blocksize() -> int:
    return _blocksize


def set_blocksize(b: int) -> None:
    global _blocksize
    _blocksize = int(b)


_auto_block_bytes = 2 << 30  # 2 GiB


def get_auto_block_bytes() -> int:
    return _auto_block_bytes


def set_auto_block_bytes(b: int) -> None:
    b = int(b)
    if b <= 0:
        raise ValueError(f"auto_block_bytes must be positive, got {b}")
    global _auto_block_bytes
    _auto_block_bytes = b


# The reference's regimes (pallas_dense._dot). "bf16x3" (default) and
# "f32" promise f32-grade rounding: the CUDA kernel runs "bf16x3" as three
# bf16 tensor-core passes and "f32" as three tf32 ones (3×TF32, ≈ 2⁻²¹ a
# term where bf16x3 keeps ≈ 2⁻¹⁶). "bf16gen2" (the operator
# rounded to bf16, two passes) and "bf16" (one pass) trade accuracy for
# speed and are opt-in.
KERNEL_PRECISIONS = ("f32", "bf16x3", "bf16", "bf16gen2")
_kernel_precision = "bf16x3"


def check_kernel_precision(p: str) -> str:
    """``p`` if it names a kernel regime; raises otherwise."""
    if p in KERNEL_PRECISIONS:
        return p
    raise errors.InvalidParametersError(
        f"kernel_precision must be one of {KERNEL_PRECISIONS}, got {p!r}")


def get_kernel_precision() -> str:
    return _kernel_precision


def set_kernel_precision(p: str) -> None:
    global _kernel_precision
    _kernel_precision = check_kernel_precision(p)


_auto_materialize = True
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
