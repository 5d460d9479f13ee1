"""Data IO: the LIBSVM readers and writer (``read_libsvm``,
``read_dir_libsvm``, ``write_libsvm``), the arc-list reader and writer
(``read_arc_list``, ``write_arc_list``) and their native parsers."""

from libskylark_tpu_torch.io import native
from libskylark_tpu_torch.io.arclist import read_arc_list, write_arc_list
from libskylark_tpu_torch.io.libsvm import (COLUMNS, ROWS, read_dir_libsvm,
                                            read_libsvm, write_libsvm)

__all__ = ["ROWS", "COLUMNS", "read_libsvm", "read_dir_libsvm",
           "write_libsvm", "read_arc_list", "write_arc_list", "native"]
