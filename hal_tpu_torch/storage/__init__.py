"""Port copy of hal_tpu/storage/__init__.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Storage drivers: format auto-detection + open/save.

Mirrors the factory in reference api/inc/halAlignmentInstance.h:83-111
(openHalAlignment / detectHalAlignmentFormat):

  * hdf5 — byte-compatible with the reference's HDF5 driver
    (api/hdf5_impl/), so alignments produced by the reference toolchain
    (e.g. Cactus) open directly and vice versa.
  * halz — hal_tpu's native columnar shard format: a directory of .npy
    arrays + JSON manifest, mmap-friendly and trivially sharded
    per-genome/per-array (the TPU-native replacement for the reference's
    mmap driver, api/mmap_impl/).
"""

from __future__ import annotations

import os

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.constants import FORMAT_HDF5, FORMAT_HALZ, FORMAT_MMAP
from hal_tpu_torch.storage.remote import is_url, open_remote


def detect_format(path: str) -> str:
    """detectHalAlignmentFormat equivalent."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "halz.json")):
            return FORMAT_HALZ
        raise ValueError("directory %s is not a halz alignment" % path)
    from hal_tpu_torch.storage.mmap_driver import is_mmap_file

    if is_mmap_file(path):
        # reference mmap backend (api/mmap_impl/), read-only interop
        return FORMAT_MMAP
    try:
        import h5py

        if h5py.is_hdf5(path):
            return FORMAT_HDF5
    except ImportError:
        pass
    raise ValueError("cannot detect alignment format of %s" % path)


def open_alignment(path: str, mode: str = "r") -> Alignment:
    if is_url(path):
        # UDC-equivalent remote read-only access (reference README.md:126-131)
        if mode != "r":
            raise ValueError("remote alignments are read-only")
        return open_remote(path)
    fmt = detect_format(path)
    if fmt == FORMAT_MMAP:
        from hal_tpu_torch.storage import mmap_driver

        return mmap_driver.load(path)
    if fmt == FORMAT_HDF5:
        from hal_tpu_torch.storage import hdf5_driver

        return hdf5_driver.load(path)
    from hal_tpu_torch.storage import halz

    return halz.load(path)


def save_alignment(aln: Alignment, path: str, fmt: str | None = None, **opts) -> None:
    if fmt is None:
        fmt = FORMAT_HALZ if (os.path.isdir(path) or not path.endswith((".hal", ".h5", ".hdf5"))) else FORMAT_HDF5
    if fmt == FORMAT_HDF5:
        from hal_tpu_torch.storage import hdf5_driver

        hdf5_driver.save(aln, path, **opts)
    elif fmt == FORMAT_HALZ:
        from hal_tpu_torch.storage import halz

        halz.save(aln, path, **opts)
    elif fmt == FORMAT_MMAP:
        from hal_tpu_torch.storage import mmap_driver

        mmap_driver.save(aln, path, **opts)
    else:
        raise ValueError("unknown format %s" % fmt)
