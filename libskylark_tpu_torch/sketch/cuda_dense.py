"""Dense sketch on the card: the wrappers of csrc/dense_sketch.cu, their
plain versions, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_dense.py (``_fused_call``,
``_fused_call_cw``, ``_fused_call_cos``, ``_batched_call`` and
``fused_partial``): out = scale · A·Sᵀ (rowwise) or scale · S·A
(columnwise) with S the virtual dense-block operator of base/randgen.py,
generated on the card from the transform's key and never stored whole;
the random Fourier feature map outscale · cos((A·Sᵀ)·inscale·sc + sh), the
rowwise kernel with a cos epilogue (:func:`rft_rowwise_apply`); the
batched sketch of a stacked serve cohort, each lane with its own key and
scale (:func:`serve_batched_apply`), one call for all lanes; and one
shard's unscaled partial against S's columns from a block offset
(:func:`fused_partial`), which a sequence-parallel apply sums over ranks
(parallel/shard_apply.py).

The contraction regime (``precision``, the reference's names, default the
package's ``sketch/params.py`` regime) decides the passes on the card. In
every regime a generation kernel writes the operator's planes (hi, and lo
for bf16x3 and f32) for one chunk of n into a workspace this module
allocates (at most 64 MiB of bf16 planes per lane, or as many tf32
entries, whatever n is), then a warp-specialised wgmma kernel contracts
A, split into hi/lo in registers, against them; n split across blocks for
thin outputs, the partial sums added in a fixed order:

- ``"bf16x3"`` (default), ``"bf16gen2"``, ``"bf16"``: bf16 planes and
  passes;
- ``"f32"``: 3×TF32, hi·hi + hi·lo + lo·hi with hi and lo rounded to tf32
  (the reference's ``Precision.HIGHEST`` to about 2⁻²¹ per term).

Rules of the wrappers:

- a CPU tensor takes the plain version of the regime asked for,
  :func:`dense_apply_plain`, :func:`rft_apply_plain` or
  :func:`serve_batched_plain` (``dense.regime_matmul`` term for term);
- a CUDA tensor launches the kernel or raises — no fallback;
- ``key`` is the transform's key data by value, or (a single apply's
  route inside a captured body, engine/compiled.py) the same two words
  as an int32 tensor on A's device (:func:`device_key`), which the
  kernel reads from device memory: the two give the same bits;
- ``launches[...]`` counts wrapper calls that launched their kernels,
  ``by_regime[...]`` the same calls by regime, and ``generated["entries"]``
  the operator entries the generation kernel made (s_dim · n per lane and
  call, in every regime).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import key_words
from libskylark_tpu_torch.sketch import params as sketch_params
from libskylark_tpu_torch.sketch.dense import (BLOCK_COLS, regime_matmul,
                                               serve_apply)

# dist kind codes of the C ABI (csrc/dense_sketch.cu: enum Dist)
_DIST_KINDS = {
    randgen.Normal: 0,
    randgen.Cauchy: 1,
    randgen.Rademacher: 2,
}
# regime codes of the C ABI (csrc/dense_sketch.cu: enum Regime)
_REGIMES = {"f32": 0, "bf16x3": 1, "bf16gen2": 2, "bf16": 3}

launches = {"dense_rowwise": 0, "dense_columnwise": 0,
            "dense_rowwise_cos": 0, "dense_batched_rowwise": 0,
            "dense_batched_columnwise": 0, "dense_partial_rowwise": 0,
            "dense_partial_columnwise": 0}
generated = {"entries": 0}
by_regime = {p: 0 for p in _REGIMES}  # the same launches by regime

_lib = None


def supported(dist, dtype) -> bool:
    """The kernel's dispatch rule (the reference's ``supported``): the
    standard Normal, Cauchy or Rademacher distribution, float32."""
    if type(dist) not in _DIST_KINDS:
        return False
    if isinstance(dist, randgen.Normal) and (dist.mean, dist.std) != (0, 1):
        return False
    if isinstance(dist, randgen.Cauchy) and (dist.loc, dist.scale) != (0, 1):
        return False
    return dtype == torch.float32


def _regime(precision) -> str:
    return sketch_params.check_kernel_precision(
        precision or sketch_params.get_kernel_precision())


def dense_apply_plain(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                      rowwise: bool, precision: str | None = None
                      ) -> torch.Tensor:
    """The plain PyTorch version of both kernels: S made whole on A's
    device, then the regime's product, then the scale."""
    p = _regime(precision)
    n = A.shape[1] if rowwise else A.shape[0]
    S = randgen.dense_panel(key, dist, s_dim, 0, n, BLOCK_COLS,
                            torch.float32, A.device)
    return scale * (regime_matmul(A, S.T, p, 1) if rowwise
                    else regime_matmul(S, A, p, 0))


def rft_apply_plain(key, dist, A: torch.Tensor, s_dim: int, inscale: float,
                    outscale: float, sc: torch.Tensor, sh: torch.Tensor,
                    precision: str | None = None) -> torch.Tensor:
    """The plain PyTorch version of the cos-epilogue kernel, in its
    operation order: outscale · cos((A @ Sᵀ)·inscale·sc + sh), S made
    whole on A's device (unscaled: the kernel scales the sum), the product
    in the regime."""
    p = _regime(precision)
    S = randgen.dense_panel(key, dist, s_dim, 0, A.shape[1], BLOCK_COLS,
                            torch.float32, A.device)
    return outscale * torch.cos(regime_matmul(A, S.T, p, 1) * inscale * sc
                                + sh)


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("dense_sketch")
        p, i64, u32, f32, c_int = (ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_uint32, ctypes.c_float,
                                   ctypes.c_int)
        lib.sk_dense_tc_plan.argtypes = [i64, i64, i64, c_int,
                                         ctypes.POINTER(i64)]
        lib.sk_dense_tc.argtypes = [c_int, c_int, c_int, p, i64, u32, u32, p,
                                    p, i64, i64, i64, i64, i64, f32, p, p,
                                    f32, p, p, p, p]
        for fn in (lib.sk_dense_tc_plan, lib.sk_dense_tc):
            fn.restype = c_int
        _lib = lib
    return _lib


def _check(dist, A, s_dim: int, ndim: int = 2) -> bool:
    """Checks shared by the wrappers; True when A lies on the CPU (the
    plain version's case)."""
    from libskylark_tpu_torch.kernels import launch

    launch.refuse_dtensor(A)
    if not supported(dist, A.dtype):
        raise errors.UnsupportedError(
            f"dense sketch kernel takes standard normal/cauchy/rademacher "
            f"and float32, got {dist!r} and {A.dtype}")
    if A.ndim != ndim or s_dim <= 0:
        raise errors.InvalidParametersError(
            f"need a {ndim}-D operand and s_dim > 0, got {tuple(A.shape)}, "
            f"s_dim={s_dim}")
    if A.device.type == "cpu":
        return True
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"dense sketch kernel runs on CUDA or CPU, got {A.device}")
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "dense sketch kernel needs a contiguous operand")
    return False


def _launch_tc(A, out, rowwise: bool, precision: str, dist, B: int, m: int,
               n: int, s_dim: int, *, key=(0, 0), keys=None, scales=None,
               scale: float = 1.0, sc=None, sh=None, outscale: float = 0.0,
               block0: int = 0) -> None:
    """One call of the kernels' route (sk_dense_tc): the plan's
    workspace and partial sums allocated here, on A's device. The kernel
    reads A through a TMA tensor map, whose rows must be 16 bytes apart:
    an operand whose rows are not (least squares' [A | b] has 513
    columns) is first copied into a buffer whose rows are, one pass over
    A. ``block0`` is the column block of S that A's first contracted
    column meets (a shard's partial)."""
    from libskylark_tpu_torch.kernels import launch

    cols = A.shape[-1]
    if cols % 4 or A.data_ptr() % 16:
        padded = torch.empty((*A.shape[:-1], -(-cols // 4) * 4),
                             dtype=A.dtype, device=A.device)
        padded[..., :cols] = A
        A = padded
    lib = _load()
    code = _REGIMES[precision]
    plan = (ctypes.c_int64 * 6)()
    with torch.cuda.device(A.device):
        rc = lib.sk_dense_tc_plan(m, n, s_dim, code, plan)
    if rc != 0:
        raise errors.SketchError(f"sk_dense_tc_plan failed: CUDA error {rc}")
    ws = torch.empty(B * plan[0], dtype=torch.uint8, device=A.device)
    part = (torch.empty(B * plan[1], dtype=torch.uint8, device=A.device)
            if plan[1] else None)

    launch.call(lib.sk_dense_tc, A.device, int(rowwise), code,
                _DIST_KINDS[type(dist)], A, A.shape[-1], *key, keys, scales,
                B, m, n, s_dim, int(block0), float(scale), sc, sh,
                float(outscale), out, ws, part)
    launch.count(generated, "entries", B * s_dim * n)


def device_key(key, device) -> torch.Tensor:
    """The (2,) uint32 key words as an int32 tensor on ``device``: the
    form in which a captured body gets its key as a graph input."""
    return lane_keys(np.asarray(key_words(key), dtype=np.uint32),
                     device)[0]


def _key_args(key, device) -> dict:
    """The launch's key arguments: the words by value, or ``keys``, a
    (2,) int32 tensor already on ``device``."""
    if not isinstance(key, torch.Tensor):
        return {"key": key_words(key)}
    if key.device != device or key.dtype != torch.int32 or key.numel() != 2:
        raise errors.InvalidParametersError(
            f"a key tensor must be 2 int32 words on {device}, got "
            f"{key.numel()} {key.dtype} on {key.device}")
    return {"keys": key.contiguous()}


def _count(name: str, precision: str) -> None:
    from libskylark_tpu_torch.kernels import launch

    launch.count(launches, name)
    launch.count(by_regime, precision)


def _apply(key, dist, A, s_dim: int, scale: float, precision, rowwise: bool):
    p = _regime(precision)
    if _check(dist, A, s_dim):
        return dense_apply_plain(key, dist, A, s_dim, scale, rowwise, p)
    n, m = (A.shape[1], A.shape[0]) if rowwise else A.shape
    out = torch.empty((m, s_dim) if rowwise else (s_dim, m),
                      dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    _launch_tc(A, out, rowwise, p, dist, 1, m, n, s_dim,
               **_key_args(key, A.device), scale=scale)
    _count("dense_rowwise" if rowwise else "dense_columnwise", p)
    return out


def rowwise_apply(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                  precision: str | None = None) -> torch.Tensor:
    """out = scale · A @ Sᵀ for A (m, N) float32 → (m, s_dim)."""
    return _apply(key, dist, A, s_dim, scale, precision, rowwise=True)


def columnwise_apply(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                     precision: str | None = None) -> torch.Tensor:
    """out = scale · S @ A for A (N, m) float32 → (s_dim, m)."""
    return _apply(key, dist, A, s_dim, scale, precision, rowwise=False)


def partial_plain(key, dist, A_loc: torch.Tensor, s_dim: int,
                  seq_axis: int, block0: int,
                  precision: str | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_partial`: the unscaled
    operator's columns [256·block0, 256·block0 + n_loc) made on A_loc's
    device, then the regime's product."""
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    p = _regime(precision)
    n = A_loc.shape[seq_axis]
    c0 = BLOCK_COLS * int(block0)
    S = virtual_panel(key, dist, s_dim, c0, c0 + n, 1.0, torch.float32,
                      A_loc.device)
    return (regime_matmul(A_loc, S.T, p, 1) if seq_axis == 1
            else regime_matmul(S, A_loc, p, 0))


def fused_partial(key, dist, A_loc: torch.Tensor, s_dim: int, seq_axis: int,
                  block0: int, precision: str | None = None) -> torch.Tensor:
    """One shard's UNSCALED contraction with the operator's columns
    [256·block0, 256·block0 + n_loc): A_loc·S_locᵀ (m, s_dim) for
    ``seq_axis`` 1, S_loc·A_loc (s_dim, m) for 0, n_loc = A_loc's extent
    on ``seq_axis`` (a multiple of 256 but for the last shard, which may
    end anywhere: the operator's columns past n_loc meet nothing). The
    reference's ``pallas_dense.fused_partial`` takes the shard's slice of
    the block-key table; here the kernel derives block block0 + b's key on
    the card. The caller scales and sums the partials over ranks
    (parallel/shard_apply.py). A CPU tensor takes :func:`partial_plain`; a
    CUDA tensor launches the kernel at scale 1 or raises."""
    if seq_axis not in (0, 1):
        raise errors.InvalidParametersError(
            f"seq_axis must be 0 or 1, got {seq_axis}")
    if int(block0) < 0:
        raise errors.InvalidParametersError(
            f"block0 must be non-negative, got {block0}")
    p = _regime(precision)
    if _check(dist, A_loc, s_dim):
        return partial_plain(key, dist, A_loc, s_dim, seq_axis, block0, p)
    rowwise = seq_axis == 1
    n, m = (A_loc.shape[1], A_loc.shape[0]) if rowwise else A_loc.shape
    out = torch.empty((m, s_dim) if rowwise else (s_dim, m),
                      dtype=torch.float32, device=A_loc.device)
    if m == 0 or n == 0:
        return out.zero_()
    _launch_tc(A_loc, out, rowwise, p, dist, 1, m, n, s_dim,
               key=key_words(key), block0=int(block0))
    _count("dense_partial_rowwise" if rowwise
           else "dense_partial_columnwise", p)
    return out


def rft_rowwise_apply(key, dist, A: torch.Tensor, s_dim: int, inscale: float,
                      outscale: float, sc: torch.Tensor, sh: torch.Tensor,
                      precision: str | None = None) -> torch.Tensor:
    """out = outscale · cos((A @ Sᵀ)·inscale·sc + sh) for A (m, N)
    float32 → (m, s_dim); ``sc``/``sh`` are (s_dim,) per-feature scales
    and shifts."""
    p = _regime(precision)
    cpu = _check(dist, A, s_dim)
    sc = sc.to(device=A.device, dtype=torch.float32).contiguous()
    sh = sh.to(device=A.device, dtype=torch.float32).contiguous()
    if sc.shape != (s_dim,) or sh.shape != (s_dim,):
        raise errors.InvalidParametersError(
            f"sc and sh must have shape ({s_dim},), got {tuple(sc.shape)} "
            f"and {tuple(sh.shape)}")
    if cpu:
        return rft_apply_plain(key, dist, A, s_dim, inscale, outscale, sc, sh,
                               p)
    m, n = A.shape
    out = torch.empty((m, s_dim), dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    _launch_tc(A, out, True, p, dist, 1, m, n, s_dim,
               **_key_args(key, A.device), scale=inscale, sc=sc, sh=sh,
               outscale=outscale)
    _count("dense_rowwise_cos", p)
    return out


def host_words(key_data) -> np.ndarray:
    """(B, 2) uint32 key words on the host, from words or from the
    kernels' int32 key tensor (the plain versions' form; a CUDA tensor is
    read back)."""
    if isinstance(key_data, torch.Tensor):
        kd = key_data.detach().cpu().numpy()
        kd = kd.view(np.uint32) if kd.dtype == np.int32 else kd
        return np.asarray(kd, dtype=np.uint32).reshape(-1, 2)
    return np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)


def host_values(values) -> np.ndarray:
    """A (B,) vector of per-lane values (scales) on the host."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values).reshape(-1)


def serve_batched_plain(key_data, scale, A: torch.Tensor, dist, s_dim: int,
                        rowwise: bool, precision: str | None = None
                        ) -> torch.Tensor:
    """The plain PyTorch version of the batched kernel: ``dense.serve_apply``
    lane by lane (the scaled operator, then the regime's product)."""
    kd = host_words(key_data)
    sc = host_values(scale)
    p = _regime(precision)
    return torch.stack([serve_apply(kd[i], float(sc[i]), A[i], dist=dist,
                                    s_dim=s_dim, rowwise=rowwise,
                                    precision=p)
                        for i in range(A.shape[0])])


def host_to(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device``, copied without waiting for the
    device: CUDA stages a pageable source at once, so the caller may
    reuse it, and the caller's launches queue behind the copy."""
    return t.to(device, non_blocking=True)


def lane_keys(key_data, device) -> torch.Tensor:
    """(B, 2) uint32 key words as an int32 tensor on ``device`` (the
    kernels read the bits as uint32). Keys already in that form, an int32
    tensor on ``device``, pass through untouched: nothing is read from or
    copied off the host, so a captured serve flush takes its keys as a
    graph input (engine/serve.py)."""
    if isinstance(key_data, torch.Tensor):
        return _device_lanes(key_data.reshape(-1, 2), torch.int32, device,
                             "keys")
    kd = np.ascontiguousarray(np.asarray(key_data, dtype=np.uint32)
                              .reshape(-1, 2))
    return host_to(torch.from_numpy(kd.view(np.int32)), device)


def lane_words(key_data, device):
    """A cohort's keys as a batched wrapper takes them: the (B, 2) int32
    key tensor on a CUDA ``device`` untouched (no host read), else (B, 2)
    uint32 words on the host."""
    if isinstance(key_data, torch.Tensor) and torch.device(
            device).type == "cuda":
        return lane_keys(key_data, device)
    return host_words(key_data)


def lane_scales(scale, device) -> torch.Tensor:
    """(B,) float32 per-lane scales on ``device``; a float32 tensor on
    ``device`` passes through untouched, as :func:`lane_keys`' keys do."""
    if isinstance(scale, torch.Tensor):
        return _device_lanes(scale.reshape(-1), torch.float32, device,
                             "scales")
    sc = np.asarray(scale, dtype=np.float32).reshape(-1)
    return host_to(torch.from_numpy(sc.copy()), device)


def _device_lanes(t: torch.Tensor, dtype, device, what: str) -> torch.Tensor:
    if t.dtype != dtype or t.device != torch.device(device):
        raise errors.InvalidParametersError(
            f"lane {what} given as a tensor must be {dtype} on {device}, got "
            f"{t.dtype} on {t.device}")
    return t.contiguous()


def serve_batched_apply(key_data, scale, A: torch.Tensor, dist, s_dim: int,
                        rowwise: bool, precision: str | None = None
                        ) -> torch.Tensor:
    """The batched sketch of a stacked cohort: A (B, m, n) rowwise → (B,
    m, s_dim), A (B, n, m) columnwise → (B, s_dim, m); lane b under the
    key ``key_data[b]`` ((B, 2) uint32 words) and scaled by ``scale[b]``,
    the product in the regime ``precision`` (the reference's argument;
    default: the package's). Every regime scales the operator entries
    before they are rounded, as the reference does. Lane b's result does
    not depend on B. ``key_data`` may be the (B, 2) int32 key tensor and
    ``scale`` a (B,) float32 tensor on A's device (:func:`lane_keys`,
    :func:`lane_scales`): the launch then reads both from device memory."""
    p = _regime(precision)
    cpu = _check(dist, A, s_dim, ndim=3)
    kd = lane_words(key_data, A.device)
    sc = (scale.reshape(-1) if isinstance(scale, torch.Tensor) and not cpu
          else host_values(scale).astype(np.float32))
    if kd.shape[0] != A.shape[0] or sc.shape[0] != A.shape[0]:
        raise errors.InvalidParametersError(
            f"need B keys and B scales for a (B, ., .) operand, got "
            f"{tuple(A.shape)}, {kd.shape[0]} keys, {sc.shape[0]} scales")
    if cpu:
        return serve_batched_plain(kd, sc, A, dist, s_dim, rowwise, p)
    B = A.shape[0]
    n, m = (A.shape[2], A.shape[1]) if rowwise else (A.shape[1], A.shape[2])
    out = torch.empty((B, m, s_dim) if rowwise else (B, s_dim, m),
                      dtype=torch.float32, device=A.device)
    if B == 0 or m == 0:
        return out
    keys = lane_keys(kd, A.device)
    scales = lane_scales(sc, A.device)
    _launch_tc(A, out, rowwise, p, dist, B, m, n, s_dim, keys=keys,
               scales=scales)
    _count("dense_batched_rowwise" if rowwise
           else "dense_batched_columnwise", p)
    return out
