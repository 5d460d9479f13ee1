"""skylark_linear: sketch-accelerated least-squares solve from file.

The port of libskylark_tpu/cli/skylark_linear.py (ref: nla/
skylark_linear.cpp:97-201): reads a libsvm regression problem, solves
min ‖Ax − b‖₂ on ``--device`` with FastLeastSquares (Blendenpik, ``-p``)
or sketch-and-solve, writes the solution vector to prefix.x.txt.

Example::

    python -m libskylark_tpu_torch.cli.skylark_linear ls.libsvm -p \\
        --device cuda --prefix out
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from libskylark_tpu_torch.cli import add_device_arg, add_streaming_args

    p = argparse.ArgumentParser(
        prog="skylark_linear",
        description="Sketched least squares (ref: nla/skylark_linear.cpp)",
    )
    p.add_argument("inputfile", help="input file (libsvm format)")
    p.add_argument("-d", "--directory", action="store_true")
    p.add_argument("-s", "--seed", type=int, default=38734)
    p.add_argument("-p", "--highprecision", action="store_true",
                   help="accurate sketch-preconditioned solve (Blendenpik); "
                   "default is sketch-and-solve")
    p.add_argument("-f", "--single", action="store_true",
                   help="kept for command-line parity (f32 is the default)")
    p.add_argument("--prefix", default="out",
                   help="solution written to prefix.x.txt")
    add_streaming_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    from libskylark_tpu_torch.cli import honor_platform_env

    honor_platform_env()
    args = build_parser().parse_args(argv)

    import libskylark_tpu_torch.io as skio
    from libskylark_tpu_torch.base.context import Context
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.cli import write_ascii_matrix
    from libskylark_tpu_torch.nla.least_squares import (
        approximate_least_squares,
        fast_least_squares,
    )

    if args.streaming and args.directory:
        print("error: --streaming reads a single libsvm file",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    t0 = time.time()
    if args.streaming:
        from libskylark_tpu_torch.cli import read_streaming

        X, Y = read_streaming(args.inputfile, args.batch_rows, device)
    else:
        reader = skio.read_dir_libsvm if args.directory else skio.read_libsvm
        X, Y = reader(args.inputfile)
    print(f"Reading the matrix... took {time.time() - t0:.2e} sec")

    context = Context(seed=args.seed)
    t0 = time.time()
    if args.highprecision:
        x = fast_least_squares(X, Y, context, device=device)
        if isinstance(x, tuple):
            x = x[0]
    else:
        x = approximate_least_squares(X, Y, context, device=device)
    print(f"Solving the least squares... took {time.time() - t0:.2e} sec")

    write_ascii_matrix(args.prefix + ".x.txt", x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
