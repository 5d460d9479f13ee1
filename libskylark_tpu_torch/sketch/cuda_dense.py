"""Dense sketch on the card: the wrappers of csrc/dense_sketch.cu, their
plain versions, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_dense.py (``_fused_call``,
``_fused_call_cw``, ``_fused_call_cos`` and ``_batched_call``): out =
scale · A·Sᵀ (rowwise) or scale · S·A (columnwise) with S the virtual
dense-block operator of base/randgen.py, generated on the card from the
transform's key and never stored whole; the random Fourier feature map
outscale · cos((A·Sᵀ)·inscale·sc + sh), the rowwise kernel with a cos
epilogue (:func:`rft_rowwise_apply`); and the batched sketch of a stacked
serve cohort, each lane with its own key and scale
(:func:`serve_batched_apply`), one call for all lanes.

The contraction regime (``precision``, the reference's names, default the
package's ``sketch/params.py`` regime) decides the route on the card:

- ``"bf16x3"`` (default), ``"bf16gen2"``, ``"bf16"``: a generation kernel
  writes the operator's bf16 planes (hi, and lo for bf16x3) for one chunk
  of n into a workspace this module allocates (at most 64 MiB per lane,
  whatever n is), then a warp-specialised wgmma kernel contracts A,
  split into bf16 hi/lo in registers, against them; n split across blocks
  for thin outputs, the partial sums added in a fixed order;
- ``"f32"``: the fp32-FMA kernel, which generates its operator tile per
  m-tile.

Rules of the wrappers:

- a CPU tensor takes the plain version of the regime asked for,
  :func:`dense_apply_plain`, :func:`rft_apply_plain` or
  :func:`serve_batched_plain` (``dense.regime_matmul`` term for term);
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts wrapper calls that launched their kernels,
  ``by_regime[...]`` the same calls by regime, and ``generated["entries"]``
  the operator entries the bf16 regimes' generation kernel made (s_dim · n
  per lane and call).
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
            "dense_batched_columnwise": 0}
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
        sig = [p, u32, u32, p, i64, i64, i64, i64, c_int, f32, p]
        for fn in (lib.sk_dense_rowwise, lib.sk_dense_columnwise):
            fn.argtypes = sig
        lib.sk_dense_rowwise_cos.argtypes = [p, u32, u32, p, p, p, i64, i64,
                                             i64, i64, c_int, f32, f32, p]
        lib.sk_dense_batched.argtypes = [c_int, p, p, p, p, i64, i64, i64,
                                         i64, c_int, p]
        lib.sk_dense_tc_plan.argtypes = [i64, i64, i64, c_int,
                                         ctypes.POINTER(i64)]
        lib.sk_dense_tc.argtypes = [c_int, c_int, c_int, p, i64, u32, u32, p,
                                    p, i64, i64, i64, i64, f32, p, p, f32, p,
                                    p, p, p]
        for fn in (lib.sk_dense_rowwise, lib.sk_dense_columnwise,
                   lib.sk_dense_rowwise_cos, lib.sk_dense_batched,
                   lib.sk_dense_tc_plan, lib.sk_dense_tc):
            fn.restype = c_int
        _lib = lib
    return _lib


def _check(dist, A, s_dim: int, ndim: int = 2) -> bool:
    """Checks shared by the wrappers; True when A lies on the CPU (the
    plain version's case)."""
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
               scale: float = 1.0, sc=None, sh=None,
               outscale: float = 0.0) -> None:
    """One call of the bf16 regimes' route (sk_dense_tc): the plan's
    workspace and partial sums allocated here, on A's device. The kernel
    reads A through a TMA tensor map, whose rows must be 16 bytes apart:
    an operand whose rows are not (least squares' [A | b] has 513
    columns) is first copied into a buffer whose rows are, one pass over
    A."""
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch.call(lib.sk_dense_tc, A.device, int(rowwise), code,
                _DIST_KINDS[type(dist)], A.data_ptr(), A.shape[-1], *key,
                ptr(keys), ptr(scales), B, m, n, s_dim, float(scale),
                ptr(sc), ptr(sh), float(outscale), out.data_ptr(),
                ws.data_ptr(), ptr(part))
    launch.count(generated, "entries", B * s_dim * n)


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
    from libskylark_tpu_torch.kernels import launch

    if p == "f32":
        lib = _load()
        fn = lib.sk_dense_rowwise if rowwise else lib.sk_dense_columnwise
        launch.call(fn, A.device, A.data_ptr(), *key_words(key),
                    out.data_ptr(), m, n, s_dim, A.shape[1],
                    _DIST_KINDS[type(dist)], float(scale))
    else:
        _launch_tc(A, out, rowwise, p, dist, 1, m, n, s_dim,
                   key=key_words(key), scale=scale)
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
    from libskylark_tpu_torch.kernels import launch

    if p == "f32":
        launch.call(_load().sk_dense_rowwise_cos, A.device, A.data_ptr(),
                    *key_words(key), sc.data_ptr(), sh.data_ptr(),
                    out.data_ptr(), m, n, s_dim, A.shape[1],
                    _DIST_KINDS[type(dist)], float(inscale), float(outscale))
    else:
        _launch_tc(A, out, True, p, dist, 1, m, n, s_dim, key=key_words(key),
                   scale=inscale, sc=sc, sh=sh, outscale=outscale)
    _count("dense_rowwise_cos", p)
    return out


def serve_batched_plain(key_data, scale, A: torch.Tensor, dist, s_dim: int,
                        rowwise: bool, precision: str | None = None
                        ) -> torch.Tensor:
    """The plain PyTorch version of the batched kernel: ``dense.serve_apply``
    lane by lane (the scaled operator, then the regime's product)."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    sc = np.asarray(scale).reshape(-1)
    p = _regime(precision)
    return torch.stack([serve_apply(kd[i], float(sc[i]), A[i], dist=dist,
                                    s_dim=s_dim, rowwise=rowwise,
                                    precision=p)
                        for i in range(A.shape[0])])


def lane_keys(key_data, device) -> torch.Tensor:
    """(B, 2) uint32 key words as an int32 tensor on ``device`` (the
    kernels read the bits as uint32)."""
    kd = np.ascontiguousarray(np.asarray(key_data, dtype=np.uint32)
                              .reshape(-1, 2))
    return torch.from_numpy(kd.view(np.int32)).to(device)


def serve_batched_apply(key_data, scale, A: torch.Tensor, dist, s_dim: int,
                        rowwise: bool, precision: str | None = None
                        ) -> torch.Tensor:
    """The batched sketch of a stacked cohort: A (B, m, n) rowwise → (B,
    m, s_dim), A (B, n, m) columnwise → (B, s_dim, m); lane b under the
    key ``key_data[b]`` ((B, 2) uint32 words) and scaled by ``scale[b]``,
    the product in the regime ``precision`` (the reference's argument;
    default: the package's). The bf16 regimes scale the operator entries
    before they are rounded, as the reference does; f32 scales the
    finished sum. Lane b's result does not depend on B."""
    p = _regime(precision)
    cpu = _check(dist, A, s_dim, ndim=3)
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    sc = np.asarray(scale, dtype=np.float32).reshape(-1)
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
    from libskylark_tpu_torch.kernels import launch

    keys = lane_keys(kd, A.device)
    scales = torch.from_numpy(sc.copy()).to(A.device)
    if p == "f32":
        launch.call(_load().sk_dense_batched, A.device, int(rowwise),
                    A.data_ptr(), keys.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), B, m, n, s_dim, _DIST_KINDS[type(dist)])
    else:
        _launch_tc(A, out, rowwise, p, dist, B, m, n, s_dim, keys=keys,
                   scales=scales)
    _count("dense_batched_rowwise" if rowwise
           else "dense_batched_columnwise", p)
    return out
