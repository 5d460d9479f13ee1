"""Data IO: the LIBSVM readers and writer (``read_libsvm``,
``read_dir_libsvm``, ``write_libsvm``)."""

from libskylark_tpu_torch.io.libsvm import (COLUMNS, ROWS, read_dir_libsvm,
                                            read_libsvm, write_libsvm)

__all__ = ["ROWS", "COLUMNS", "read_libsvm", "read_dir_libsvm",
           "write_libsvm"]
