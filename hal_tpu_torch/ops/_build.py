"""Build and load the port's CUDA kernels (hal_tpu_torch/csrc/*.cu).

nvcc compiles each source to an object for sm_90a (Hopper), one process
per source, all started together, and links them into one shared library
with a plain C interface that ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> hal_tpu_torch/csrc/<src>.cu
    nvcc -shared -o hal_tpu_torch/build/libhal_kernels_<hash>.so <objs>

The build runs at first use and is keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the library
already in hal_tpu_torch/build/.  ptxas's register and spill lines of the
last build are kept in BUILD_LOG.  A failed build raises; nothing falls
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
BUILD_LOG: list[str] = []


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
    nvcc = _nvcc()
    tag = "%s.tmp%d" % (so.stem, os.getpid())
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / ("%s.%s.o" % (src.stem, tag))
        cmd = [nvcc] + NVCC_FLAGS + ["-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = [(obj, cmd, proc.returncode, out + err)
            for obj, cmd, proc in jobs for out, err in [proc.communicate()]]
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    res = None
    if all(rc == 0 for _o, _c, rc, _t in done):
        cmd = [nvcc, "-shared", "-o", str(tmp)] + [str(o) for o, *_ in done]
        res = subprocess.run(cmd, capture_output=True, text=True)
    for obj, *_ in done:
        obj.unlink(missing_ok=True)
    for _o, ccmd, rc, text in done:
        if rc != 0:
            raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                               % (rc, " ".join(ccmd), text[-4000:]))
    if res.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                           % (res.returncode, " ".join(cmd),
                              res.stderr[-4000:]))
    os.replace(tmp, so)
    BUILD_LOG[:] = [line.strip() for _o, _c, _r, text in done
                    for line in text.splitlines()
                    if "Compiling entry" in line or "Used" in line
                    or "spill" in line]
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
        f32 = ctypes.c_float
        lib.hal_phylop_fit.argtypes = [vp, vp, i32, i32, vp, ll, f32, f32, f32,
                                       i32, i32, vp, vp, vp, vp]
        lib.hal_phylop_fit.restype = i32
        lib.hal_phylop_lnl.argtypes = [vp, vp, i32, i32, vp, ll, vp, vp, vp,
                                       vp]
        lib.hal_phylop_lnl.restype = i32
        lib.hal_phylop_fit_wave.argtypes = [i32, i32]
        lib.hal_phylop_fit_wave.restype = ll
        lib.hal_phylop_max_patterns.argtypes = []
        lib.hal_phylop_max_patterns.restype = ll
        for name in ("hal_phylop_max_slots", "hal_phylop_model_words"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        from hal_tpu_torch.ops.phylop_fit import MAX_SLOTS

        if lib.hal_phylop_max_slots() != MAX_SLOTS:
            raise RuntimeError("csrc/phylop_fit.cu's kMaxSlots differs from "
                               "phylop_fit.MAX_SLOTS")
        _lib = lib
    return _lib
