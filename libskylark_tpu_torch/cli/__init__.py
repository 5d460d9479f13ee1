"""Command-line drivers (the port of libskylark_tpu/cli/).

The analogs of the reference executables (nla/skylark_svd.cpp,
nla/skylark_linear.cpp, ml/skylark_ml.cpp, ml/skylark_graph_se.cpp,
ml/skylark_community.cpp, ml/skylark_convert2hdf5.cpp), plus
``skylark_warmup`` for warmup packs. Run as
``python -m libskylark_tpu_torch.cli.<name> [...]``; each module exposes
``main(argv) -> int``.

Flag names and defaults are the JAX package's, so command lines carry
over, plus ``--device``: a driver runs on the package default device
(``cuda``) unless ``--device`` names another (``--device cpu``); without
a card a CUDA run raises, as every entry point of the port does.
"""

from __future__ import annotations

import socket

import numpy as np

# fileformat enum (ref: ml/options.hpp:46-52)
LIBSVM_DENSE, LIBSVM_SPARSE, HDF5_DENSE, HDF5_SPARSE = 0, 1, 2, 3


def read_dataset(path: str, fileformat: int, min_d: int = 0):
    """ml/io.hpp:871-890 ``read()`` dispatch equivalent: ``(X, Y)`` on the
    host, X a numpy array or a :class:`~libskylark_tpu_torch.base.sparse.
    SparseMatrix`."""
    import libskylark_tpu_torch.io as skio

    if fileformat == LIBSVM_DENSE:
        return skio.read_libsvm(path, min_d=min_d)
    if fileformat == LIBSVM_SPARSE:
        return skio.read_libsvm(path, min_d=min_d, sparse=True)
    if fileformat == HDF5_DENSE:
        return skio.read_hdf5(path, min_d=min_d)
    if fileformat == HDF5_SPARSE:
        return skio.read_hdf5(path, min_d=min_d, sparse=True)
    raise SystemExit(f"unknown fileformat {fileformat}")


def honor_platform_env() -> None:
    """Kept with the reference's signature; does nothing.

    The reference makes an exported ``JAX_PLATFORMS`` effective for a CLI
    run. The port reads no platform variable: a driver's device is its
    ``--device`` flag or the package default (``cuda``), so a variable a
    machine exports globally cannot move a run off the card."""


def add_device_arg(p) -> None:
    """The ``--device`` flag every driver of the port takes."""
    p.add_argument("--device", default=None,
                   help="where the run executes (default: the package "
                        "default, cuda; --device cpu runs on the CPU)")


def write_ascii_matrix(path: str, M, digits: int = 8) -> None:
    """El::Write(..., El::ASCII) equivalent (ref: nla/skylark_svd.cpp:110):
    the same bytes as the reference's writer for the same values."""
    from libskylark_tpu_torch.parallel.mesh import to_host

    np.savetxt(path, to_host(M), fmt=f"%.{digits}g")


def add_streaming_args(p) -> None:
    """Shared --streaming/--batch-rows flags (bounded-memory sharded
    ingestion; the HDFS-reader analog) for the libsvm-reading CLIs."""
    p.add_argument("--streaming", action="store_true",
                   help="stream the (dense libsvm) file into sharded "
                   "device memory in bounded host memory")
    p.add_argument("--batch-rows", type=int, default=65536,
                   help="rows per streamed batch with --streaming")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def read_streaming(path: str, batch_rows: int, device=None):
    """Stream ``path`` into a row-sharded array over the default 1D mesh
    (see io.read_libsvm_sharded).

    In a process group (``torchrun``, or one the caller joined) the
    result is the DTensors over every rank. A process with no group, as
    a single-process CLI run is, gets a one-rank group and mesh on
    ``device`` for the read (NCCL on a card, gloo on the CPU), released
    after it; its one block, the whole matrix, comes back as plain
    tensors on ``device``."""
    import torch.distributed as dist

    import libskylark_tpu_torch.io as skio
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.parallel import make_mesh, multihost

    dev = resolve_device(device)
    own = not (dist.is_available() and dist.is_initialized())
    if own:
        multihost.initialize_distributed(
            f"127.0.0.1:{_free_port()}", 1, 0,
            backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        X, Y = skio.read_libsvm_sharded(path, make_mesh(device=dev.type),
                                        batch_rows=batch_rows)
        if own:
            X, Y = X.to_local(), Y.to_local()
    finally:
        if own:
            dist.destroy_process_group()
    return X, Y
