"""Frozen copy of hal_tpu_torch/constants.py for the benchmark's plain reference (numpy
only; the same code, imports pointing at hal_bench.reference).  It is the
yardstick: the port may change, this copy does not.

Shared constants.

NULL_INDEX mirrors the reference's hal_index_t NULL_INDEX = -1
(reference api/inc/halDefs.h).  HAL_VERSION mirrors the format version
string written into the file ("2.3", reference README.md:4).
"""

NULL_INDEX = -1
HAL_VERSION = "2.3"

# Storage format tags
FORMAT_HDF5 = "hdf5"
FORMAT_HALZ = "halz"  # hal_tpu's native columnar shard format
FORMAT_MMAP = "mmap"
