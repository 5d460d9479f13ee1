"""Data IO: the LIBSVM readers and writer (``read_libsvm``,
``read_dir_libsvm``, ``write_libsvm``), the arc-list reader and writer
(``read_arc_list``, ``write_arc_list``), their native parsers, and the
HDF5 reader and writer (``read_hdf5``, ``write_hdf5``; h5py at call
time)."""

from libskylark_tpu_torch.io import hdf5, native
from libskylark_tpu_torch.io.arclist import read_arc_list, write_arc_list
from libskylark_tpu_torch.io.hdf5 import have_hdf5, read_hdf5, write_hdf5
from libskylark_tpu_torch.io.libsvm import (COLUMNS, ROWS, read_dir_libsvm,
                                            read_libsvm, write_libsvm)

__all__ = ["ROWS", "COLUMNS", "read_libsvm", "read_dir_libsvm",
           "write_libsvm", "read_arc_list", "write_arc_list", "native",
           "hdf5", "have_hdf5", "read_hdf5", "write_hdf5"]
