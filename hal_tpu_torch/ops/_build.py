"""Build and load the port's CUDA kernels (hal_tpu_torch/csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface for sm_90a (Hopper), and ctypes loads it:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o hal_tpu_torch/build/libhal_kernels_<hash>.so \\
         hal_tpu_torch/csrc/*.cu

The build runs at first use and is keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the library
already in hal_tpu_torch/build/.  A failed build raises; nothing falls
back.  Every C entry returns cudaGetLastError() after its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "hal_tpu_torch cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ("libhal_kernels_%s.so" % h.hexdigest()[:16])


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)]
           + [str(s) for s in _sources()])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                           % (res.returncode, " ".join(cmd),
                              res.stderr[-4000:]))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        i32 = ctypes.c_int
        lib.hal_searchsorted_right.argtypes = [vp, i32, vp, vp, vp, vp, ll,
                                               i32, vp]
        lib.hal_searchsorted_right.restype = i32
        from hal_tpu_torch.ops.kernels import SEARCH_TREE_CAP

        if lib.hal_searchsorted_tree_cap() != SEARCH_TREE_CAP:
            raise RuntimeError("csrc/searchsorted.cu's kTreeCap differs "
                               "from kernels.SEARCH_TREE_CAP")
        for name in ("hal_cumsum_i32", "hal_cummax_i32"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, ll, vp, ctypes.c_ulonglong, ctypes.c_uint,
                           vp]
            fn.restype = ctypes.c_int
        lib.hal_scan_tile.argtypes = []
        lib.hal_scan_tile.restype = ll
        _lib = lib
    return _lib
