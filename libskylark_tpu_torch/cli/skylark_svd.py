"""skylark_svd: approximate SVD of a matrix read from file.

The port of libskylark_tpu/cli/skylark_svd.py (ref: nla/skylark_svd.cpp:
225-345): reads libsvm (a file or a directory) or an arc-list graph, runs
ApproximateSVD (or the symmetric variant) on ``--device``, writes
prefix.U.txt / prefix.S.txt / prefix.V.txt.

Example::

    python -m libskylark_tpu_torch.cli.skylark_svd --profile 8192 8192 \\
        -k 64 -i 2 --device cuda --prefix out
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from libskylark_tpu_torch.cli import add_device_arg, add_streaming_args

    p = argparse.ArgumentParser(
        prog="skylark_svd",
        description="Sketch-accelerated approximate SVD "
        "(ref: nla/skylark_svd.cpp)",
    )
    p.add_argument("inputfile", nargs="?", help="input file (libsvm format)")
    p.add_argument("--filetype", choices=["LIBSVM", "ARC_LIST"],
                   default="LIBSVM")
    p.add_argument("-d", "--directory", action="store_true",
                   help="inputfile is a directory of libsvm shards")
    p.add_argument("-s", "--seed", type=int, default=38734)
    p.add_argument("-k", "--rank", type=int, default=6)
    p.add_argument("-i", "--powerits", type=int, default=2)
    p.add_argument("--skipqr", action="store_true")
    p.add_argument("-r", "--ratio", type=int, default=2,
                   help="oversampling ratio")
    p.add_argument("-a", "--additive", type=int, default=0,
                   help="oversampling additive")
    p.add_argument("--symmetric", action="store_true")
    p.add_argument("--sparse", action="store_true",
                   help="load the matrix as sparse")
    p.add_argument("--single", action="store_true",
                   help="single precision (f32 is the default; flag kept "
                   "for command-line parity)")
    add_streaming_args(p)
    p.add_argument("--profile", nargs=2, type=int, metavar=("H", "W"),
                   help="generate a random HxW matrix and run on it")
    p.add_argument("--prefix", default="out")
    add_device_arg(p)
    return p


def profile_matrix(h: int, w: int, seed: int):
    """``--profile``'s operand: H×W standard normal float32 from numpy's
    generator seeded with ``seed``, the reference's matrix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.standard_normal((h, w)).astype(np.float32)


def main(argv=None) -> int:
    from libskylark_tpu_torch.cli import honor_platform_env

    honor_platform_env()
    args = build_parser().parse_args(argv)
    import torch

    import libskylark_tpu_torch.io as skio
    from libskylark_tpu_torch.base.context import Context
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.cli import write_ascii_matrix
    from libskylark_tpu_torch.nla.svd import (
        ApproximateSVDParams,
        approximate_svd,
        approximate_symmetric_svd,
    )

    if args.streaming and (args.directory or args.filetype == "ARC_LIST"
                           or args.sparse or args.profile):
        print("error: --streaming applies only to a single dense libsvm "
              "file", file=sys.stderr)
        return 2
    if not args.profile and args.inputfile is None:
        print("error: inputfile required (or --profile)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    context = Context(seed=args.seed)
    t0 = time.time()
    if args.profile:
        h, w = args.profile
        A = torch.from_numpy(profile_matrix(h, w, args.seed)).to(device)
    elif args.filetype == "ARC_LIST":
        # sparse adjacency operand — never densified (ref: the sparse
        # branch of nla/skylark_svd.cpp:129-215)
        A = skio.read_arc_list(args.inputfile, symmetrize=True)
    elif args.directory:
        A, _ = skio.read_dir_libsvm(args.inputfile, sparse=args.sparse)
    elif args.streaming:
        from libskylark_tpu_torch.cli import read_streaming

        A, _ = read_streaming(args.inputfile, args.batch_rows, device)
    else:
        A, _ = skio.read_libsvm(args.inputfile, sparse=args.sparse)
    print(f"Reading the matrix... took {time.time() - t0:.2e} sec")

    params = ApproximateSVDParams(
        num_iterations=args.powerits,
        oversampling_ratio=args.ratio,
        oversampling_additive=args.additive,
        skip_qr=args.skipqr,
    )
    t0 = time.time()
    if args.symmetric or args.filetype == "ARC_LIST":
        V, S = approximate_symmetric_svd(A, args.rank, context, params,
                                         device=device)
        U = V
    else:
        U, S, V = approximate_svd(A, args.rank, context, params,
                                  device=device)
    print(f"Computing approximate SVD... took {time.time() - t0:.2e} sec")

    write_ascii_matrix(args.prefix + ".U.txt", U)
    write_ascii_matrix(args.prefix + ".S.txt", S)
    write_ascii_matrix(args.prefix + ".V.txt", V)
    return 0


if __name__ == "__main__":
    sys.exit(main())
