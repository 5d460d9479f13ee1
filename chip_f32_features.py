#!/usr/bin/env python3
"""LaplacianRFT's features through B1's f32 regime against the plain f32
route, on one CUDA card, at BASELINE config 3 (X 16384×4096 Gaussian,
S = 4096, σ = 2d and 4d).

Usage: ``python3 chip_f32_features.py [--root DIR]``. ``--root`` names the
checkout whose ``libskylark_tpu_torch`` and ``chip_smoke.py`` are
measured (default: this script's), so two trees can be compared in one
call on one card. Prints one ``{"f32_features": ...}`` JSON line per σ:

- ``features_err_over_max``: max |Z − Z_plain| / max |Z_plain|, Z through
  the kernel route, Z_plain the features of the plain f32 version's
  projection (one fp32 matmul of the whole operator, TF32 off);
- ``entries_over_1e-4_max``: the entries where |Z − Z_plain| exceeds
  1e-4 · max |Z_plain|;
- ``err_over_phase_limit``: max over entries of |Z − Z_plain| / (outscale
  · sc · 1e-4 · inscale · (|X|·|W|ᵀ)), the phase's elementwise limit times
  cos's Lipschitz factor;
- ``max_abs_phase``, ``median_abs_phase`` of the plain projection;
- ``kernel_vs_float64``, ``plain_vs_float64``: on the first 2048 rows,
  each route's projection against the float64 product of the same
  operator, max over entries of |error| / (1e-4 · inscale · (|X|·|W|ᵀ)).

It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    root = Path(ap.parse_args().root).resolve()
    if not torch.cuda.is_available():
        print("chip_f32_features: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import ml, sketch as sk
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import BLOCK_COLS

    cs.check(Path(P.__file__).resolve().parent.parent == root,
             f"libskylark_tpu_torch imported from {P.__file__}, not {root}")
    (m, d), s = cs.RFT_SHAPE, cs.RFT_S
    X = cs.make_operand(torch, (m, d), 12)
    for name, sigma in (("2d", 2.0 * d), ("4d", 4.0 * d)):
        T = ml.Laplacian(d, sigma).create_rft(s, P.Context(63), "regular")
        Z = T.apply(X, sk.ROWWISE)
        proj = cd.dense_apply_plain(T.subkey(0), T.dist, X, s, T.inscale,
                                    True, "f32")
        want = T._featurize(proj, 1)
        W = randgen.dense_panel(T.subkey(0), T.dist, s, 0, d, BLOCK_COLS,
                                torch.float32, X.device)
        limit = (T.outscale * T.row_scales(torch.float32, X.device).double()
                 * 1e-4 * T.inscale
                 * (X.abs().double() @ W.abs().double().T))
        diff = (Z - want).abs()
        top = float(want.abs().max())
        rows = slice(0, 2048)
        exact = T.inscale * (X[rows].double() @ W.double().T)
        got = cd.rowwise_apply(T.subkey(0), T.dist, X[rows].contiguous(), s,
                               T.inscale, precision="f32")
        plim = limit[rows] / (T.outscale * T.row_scales(
            torch.float32, X.device).double())

        def vs_exact(Y):
            return float(((Y.double() - exact).abs() / plim).max())

        print(json.dumps({"f32_features": {
            "root": str(root), "sigma": name,
            "features_err_over_max": float(diff.max()) / top,
            "entries_over_1e-4_max": int((diff > 1e-4 * top).sum()),
            "entries": diff.numel(),
            "err_over_phase_limit": float((diff.double() / limit).max()),
            "max_abs_phase": float(proj.abs().max()),
            "median_abs_phase": float(proj.abs().median()),
            "kernel_vs_float64": vs_exact(got),
            "plain_vs_float64": vs_exact(proj[rows])}}), flush=True)
        del Z, proj, want, W, limit, diff, exact, got, plim
    print(cs.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
