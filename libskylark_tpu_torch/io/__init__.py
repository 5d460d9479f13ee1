"""Data IO: the LIBSVM readers and writer (``read_libsvm``,
``read_dir_libsvm``, ``write_libsvm``), the arc-list reader and writer
(``read_arc_list``, ``write_arc_list``), their native parsers, the HDF5
reader and writer (``read_hdf5``, ``write_hdf5``; h5py at call time), the
bounded-memory streaming readers (``io.chunked``), the WebHDFS transport
(``webhdfs_lines``) and the streaming CountSketch (``StreamingCWT``)."""

from libskylark_tpu_torch.io import hdf5, native
from libskylark_tpu_torch.io.arclist import read_arc_list, write_arc_list
from libskylark_tpu_torch.io.hdf5 import have_hdf5, read_hdf5, write_hdf5
from libskylark_tpu_torch.io.libsvm import (COLUMNS, ROWS, read_dir_libsvm,
                                            read_libsvm, write_libsvm)
from libskylark_tpu_torch.io.chunked import (iter_hdf5_batches,
                                             iter_libsvm_batches,
                                             prefetch_batches,
                                             read_libsvm_sharded,
                                             scan_libsvm_dims,
                                             stream_sketch_libsvm)
from libskylark_tpu_torch.io.streaming import StreamingCWT
from libskylark_tpu_torch.io.webhdfs import webhdfs_lines

__all__ = ["ROWS", "COLUMNS", "read_libsvm", "read_dir_libsvm",
           "write_libsvm", "read_arc_list", "write_arc_list", "native",
           "hdf5", "have_hdf5", "read_hdf5", "write_hdf5", "StreamingCWT",
           "iter_libsvm_batches", "iter_hdf5_batches", "prefetch_batches",
           "read_libsvm_sharded", "scan_libsvm_dims",
           "stream_sketch_libsvm", "webhdfs_lines"]
