"""Build the repository's native host libraries for the CPU this process
runs on.

The libraries tracked in native/ are built by native/Makefile with
-march=native, for the machine that built them; on another CPU they may
fail to load or stop on an illegal instruction.  This helper compiles a
source with the same compiler and no -march:

    g++ -O3 -fPIC -std=c++17 -shared \\
        -o hal_tpu_torch/build/<name>_<hash>.so <source>

at first use, keyed by a hash of the source and the flags (an unchanged
source loads the library already built).  A source is a file name in
native/ or a path: hal_tpu_torch.native builds native/haltpu.cpp, and
hal_tpu_torch.ops.column_native the port's own column engine,
hal_tpu_torch/csrc/column_engine.cpp (unless HALTPU_COLUMN_LIB names
another library).  A failed build raises; nothing falls back.  native/ is
only read.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from hal_tpu_torch.ops._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX): the native host "
                       "libraries cannot be built")


def library_path(source: str | Path) -> Path:
    src = NATIVE_DIR / source  # a path given whole stays as it is
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / ("%s_%s.so" % (src.stem, h.hexdigest()[:16]))


def build(source: str | Path) -> Path:
    """Compile native/<source>, or the source at a path, unless the library
    for it exists."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    cmd = [_cxx()] + CXX_FLAGS + ["-o", str(tmp), str(NATIVE_DIR / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("native build failed (%d):\n%s\n%s"
                           % (res.returncode, " ".join(cmd),
                              res.stderr[-4000:]))
    os.replace(tmp, so)
    return so
