"""skylark_convert2hdf5: libsvm → HDF5 dataset conversion.

The port of libskylark_tpu/cli/skylark_convert2hdf5.py (ref: ml/
skylark_convert2hdf5.cpp:30-60): mode 0 converts to the dense layout
("X"/"Y" datasets), mode 1 to the sparse layout ("dimensions"/"indptr"/
"indices"/"values"/"Y"), files the JAX package reads too. The conversion
runs on the host; ``--device`` is checked like every driver's.

Example::

    python -m libskylark_tpu_torch.cli.skylark_convert2hdf5 data.libsvm \\
        data.h5 --mode 1 --device cpu
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from libskylark_tpu_torch.cli import add_device_arg

    p = argparse.ArgumentParser(
        prog="skylark_convert2hdf5",
        description="libsvm → HDF5 converter "
        "(ref: ml/skylark_convert2hdf5.cpp)",
    )
    p.add_argument("inputfile", help="libsvm input file")
    p.add_argument("hdf5file", help="HDF5 output file")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1],
                   help="0: dense layout, 1: sparse layout")
    p.add_argument("--min-d", type=int, default=0)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    from libskylark_tpu_torch.cli import honor_platform_env

    honor_platform_env()
    args = build_parser().parse_args(argv)
    import libskylark_tpu_torch.io as skio
    from libskylark_tpu_torch.base.device import resolve_device

    resolve_device(args.device)
    X, Y = skio.read_libsvm(args.inputfile, sparse=args.mode == 1,
                            min_d=args.min_d)
    skio.write_hdf5(args.hdf5file, X, Y)
    print(f"input: {args.inputfile} hdf5file: {args.hdf5file} "
          f"mode: {args.mode} min_d: {args.min_d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
