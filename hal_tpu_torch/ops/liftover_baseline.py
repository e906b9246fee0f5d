"""Port copy of hal_tpu/ops/liftover_baseline.py (numpy only; the same
code), except that the library it loads is built from
native/liftover_baseline.cpp at first use for the CPU this process runs on
(hal_tpu_torch.ops._native_build), not the tracked native/libhalbaseline.so,
which native/Makefile builds with -march=native; a failed build raises
where the original returns None.

ctypes binding for the reference-architecture C++ liftover baseline
(native/liftover_baseline.cpp) — the external performance anchor.

The reference toolchain cannot be built here (no HDF5 headers / sonLib in
the image), so BASELINE.md's measured anchor is this single-threaded C++
per-interval segment walk: the same algorithmic shape as halLiftover's hot
loop (the reference's liftover/impl/halBlockLiftover.cpp:46-113 +
api/impl/halSegmentMapper.cpp), running on the same machine and data as
the TPU kernel.  Its fragment count must equal the device path's exactly
(bench.py asserts it), so rates compare equal work.
"""

from __future__ import annotations

import ctypes

import numpy as np

_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    from hal_tpu_torch.ops import _native_build

    lib = ctypes.CDLL(str(_native_build.build("liftover_baseline.cpp")))
    _tried = True
    lib.lb_new.restype = ctypes.c_void_p
    lib.lb_add_level.restype = None
    lib.lb_add_level.argtypes = [ctypes.c_void_p, ctypes.c_int64, _I64,
                                 ctypes.c_int64, _I64, _U8, _I64,
                                 ctypes.c_int64, _I64, _U8]
    lib.lb_run.restype = ctypes.c_int64
    lib.lb_run.argtypes = [ctypes.c_void_p, _I64, _I64, ctypes.c_int64,
                           _I64]
    lib.lb_free.restype = None
    lib.lb_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class CppBaseline:
    """Single-core per-interval lifter over the src->tgt genome path
    (main chain with paralogy rings at down levels — the same traversal
    the device kernel runs with the default coalescence limit)."""

    def __init__(self, aln, src: str, tgt: str):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.lb_new()
        self._keep = []
        tree = aln.tree
        cur = src
        for nxt in tree.path(src, tgt)[1:]:
            g = aln.open_genome(cur)
            ng = aln.open_genome(nxt)
            up = tree.parent(cur) == nxt
            if up:
                starts = np.ascontiguousarray(g.top_start, np.int64)
                link = np.ascontiguousarray(g.top_parent, np.int64)
                lrev = np.ascontiguousarray(g.top_parent_reversed, np.uint8)
                dst = np.ascontiguousarray(ng.bot_start, np.int64)
                para = prev = None
            else:
                slot = tree.child_index(cur, nxt)
                starts = np.ascontiguousarray(g.bot_start, np.int64)
                nb = g.num_bottom_segments
                link = (np.ascontiguousarray(g.bot_child[:, slot], np.int64)
                        if nb else np.zeros(0, np.int64))
                lrev = (np.ascontiguousarray(g.bot_child_reversed[:, slot],
                                             np.uint8)
                        if nb else np.zeros(0, np.uint8))
                dst = np.ascontiguousarray(ng.top_start, np.int64)
                if ng.top_paralogy.size:
                    para = np.ascontiguousarray(ng.top_paralogy, np.int64)
                    prev = np.ascontiguousarray(ng.top_parent_reversed,
                                                np.uint8)
                else:
                    para = prev = None
            self._keep.extend([starts, link, lrev, dst, para, prev])
            lib.lb_add_level(
                ctypes.c_void_p(self._h), 1 if up else 0,
                starts.ctypes.data_as(_I64), len(starts) - 1,
                link.ctypes.data_as(_I64), lrev.ctypes.data_as(_U8),
                dst.ctypes.data_as(_I64), len(dst) - 1,
                None if para is None else para.ctypes.data_as(_I64),
                None if prev is None else prev.ctypes.data_as(_U8))
            cur = nxt

    def run(self, lo: np.ndarray, hi: np.ndarray):
        """Returns (total fragments, coordinate checksum)."""
        lo = np.ascontiguousarray(lo, np.int64)
        hi = np.ascontiguousarray(hi, np.int64)
        cs = ctypes.c_int64(0)
        total = self._lib.lb_run(ctypes.c_void_p(self._h),
                                 lo.ctypes.data_as(_I64),
                                 hi.ctypes.data_as(_I64), len(lo),
                                 ctypes.byref(cs))
        return int(total), int(cs.value)

    def close(self):
        if self._h:
            self._lib.lb_free(ctypes.c_void_p(self._h))
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
