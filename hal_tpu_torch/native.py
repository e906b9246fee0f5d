"""Port copy of hal_tpu/native.py (numpy only; the same code, imports
pointing at hal_tpu_torch), except that the library it loads is built from
native/haltpu.cpp at first use for the CPU this process runs on
(hal_tpu_torch.ops._native_build), not the tracked native/libhaltpu.so,
which native/Makefile builds with -march=native.  A failed build raises.

ctypes binding to the native runtime (native/haltpu.cpp).

Optional: every entry point has a numpy fallback; `available()` reports
whether the shared library was built.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_tried = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    from hal_tpu_torch.ops import _native_build

    lib = ctypes.CDLL(str(_native_build.build("haltpu.cpp")))
    _tried = True
    lib.ht_parse_bed3.restype = ctypes.c_int64
    lib.ht_format_bed.restype = ctypes.c_int64
    lib.ht_extract_runs_simple.restype = ctypes.c_int64
    lib.ht_substitution_stats.restype = ctypes.c_int64
    lib.ht_unpack_dna.restype = ctypes.c_int64
    for name in ("ht_parse_fixed_values", "ht_parse_varstep_values",
                 "ht_format_wiggle_values", "ht_scatter_values"):
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _p64(a):
    return a.ctypes.data_as(_I64)


def _pu8(a):
    return a.ctypes.data_as(_U8)


def _name_table(names: list[str]):
    blob = b"\x00".join(n.encode() for n in names) + b"\x00"
    offsets = np.zeros(len(names), np.int64)
    pos = 0
    for i, n in enumerate(names):
        offsets[i] = pos
        pos += len(n) + 1
    return blob, offsets


def parse_bed3(text: bytes, seq_names: list[str]):
    """-> (chrom_id, starts, ends) int64 arrays; chrom_id -1 for unknown."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    blob, offsets = _name_table(seq_names)
    cap = text.count(b"\n") + 2
    chrom = np.empty(cap, np.int64)
    starts = np.empty(cap, np.int64)
    ends = np.empty(cap, np.int64)
    n = lib.ht_parse_bed3(text, ctypes.c_int64(len(text)),
                          blob, _p64(offsets), ctypes.c_int64(len(seq_names)),
                          _p64(chrom), _p64(starts), _p64(ends), ctypes.c_int64(cap))
    if n < 0:
        raise ValueError("BED parse error (code %d)" % n)
    return chrom[:n], starts[:n], ends[:n]


def format_bed(chrom_id, starts, ends, seq_names: list[str], strands=None) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    blob, offsets = _name_table(seq_names)
    n = len(chrom_id)
    chrom_id = np.ascontiguousarray(chrom_id, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    sp = None
    if strands is not None:
        sp = _pu8(np.ascontiguousarray(strands, np.uint8))
    cap = max(n * 96 + 1024, 4096)
    while True:
        out = ctypes.create_string_buffer(cap)
        w = lib.ht_format_bed(_p64(chrom_id), _p64(starts), _p64(ends),
                              sp, ctypes.c_int64(n), blob, _p64(offsets),
                              out, ctypes.c_int64(cap))
        if w >= 0:
            return out.raw[:w]
        cap = int(-w) + cap


def extract_runs_simple(s_lo, s_hi, t_lo, t_hi, rev, owner, seq_of):
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    n = len(s_lo)
    arrs = [np.ascontiguousarray(a, np.int64) for a in (s_lo, s_hi, t_lo, t_hi)]
    rev = np.ascontiguousarray(rev, np.uint8)
    owner = np.ascontiguousarray(owner, np.int64)
    seq_of = np.ascontiguousarray(seq_of, np.int64)
    ro = np.empty(n, np.int64)
    rl = np.empty(n, np.int64)
    rh = np.empty(n, np.int64)
    rs = np.empty(n, np.int64)
    rr = np.empty(n, np.uint8)
    m = lib.ht_extract_runs_simple(_p64(arrs[0]), _p64(arrs[1]), _p64(arrs[2]),
                                   _p64(arrs[3]), _pu8(rev), _p64(owner),
                                   _p64(seq_of), ctypes.c_int64(n),
                                   _p64(ro), _p64(rl), _p64(rh), _p64(rs), _pu8(rr))
    return ro[:m], rl[:m], rh[:m], rs[:m], rr[:m]


def substitution_stats(child_packed, parent_packed, c_off, p_off, lens, rev):
    """-> (matches, subs, transitions, transversions)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    out = np.zeros(4, np.int64)
    lib.ht_substitution_stats(
        _pu8(np.ascontiguousarray(child_packed, np.uint8)),
        _pu8(np.ascontiguousarray(parent_packed, np.uint8)),
        _p64(np.ascontiguousarray(c_off, np.int64)),
        _p64(np.ascontiguousarray(p_off, np.int64)),
        _p64(np.ascontiguousarray(lens, np.int64)),
        _pu8(np.ascontiguousarray(rev, np.uint8)),
        ctypes.c_int64(len(lens)), _p64(out))
    return tuple(int(x) for x in out)


def unpack_dna(packed, start: int, length: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    out = np.empty(length, np.uint8)
    lib.ht_unpack_dna(_pu8(np.ascontiguousarray(packed, np.uint8)),
                      ctypes.c_int64(start), ctypes.c_int64(length), _pu8(out))
    return out


def _pf64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_fixed_values(chunk: bytes) -> np.ndarray:
    """Parse a fixedStep numeric chunk (one value per line) -> float64."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    cap = chunk.count(b"\n") + 2
    out = np.empty(cap, np.float64)
    n = lib.ht_parse_fixed_values(chunk, ctypes.c_int64(len(chunk)),
                                  _pf64(out), ctypes.c_int64(cap))
    if n < 0:
        raise ValueError("wiggle value parse error (code %d)" % n)
    return out[:n]


def parse_varstep_values(chunk: bytes):
    """Parse a variableStep chunk ('pos value' lines) -> (pos0based, vals)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    cap = chunk.count(b"\n") + 2
    pos = np.empty(cap, np.int64)
    val = np.empty(cap, np.float64)
    n = lib.ht_parse_varstep_values(chunk, ctypes.c_int64(len(chunk)),
                                    _p64(pos), _pf64(val), ctypes.c_int64(cap))
    if n < 0:
        raise ValueError("wiggle value parse error (code %d)" % n)
    return pos[:n], val[:n]


def format_wiggle_values(vals) -> bytes:
    """'%g\\n'-format a value array (the wiggle emitters' inner loop)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    v = np.ascontiguousarray(vals, np.float64)
    cap = max(len(v) * 24 + 64, 4096)
    while True:
        out = ctypes.create_string_buffer(cap)
        w = lib.ht_format_wiggle_values(_pf64(v), ctypes.c_int64(len(v)),
                                        out, ctypes.c_int64(cap))
        if w >= 0:
            return out.raw[:w]
        cap = int(-w) + cap


def scatter_values(pos, val, tile: np.ndarray, mask: np.ndarray) -> None:
    """Last-writer-wins scatter into a dense tile (WiggleTiles model)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    p = np.ascontiguousarray(pos, np.int64)
    v = np.ascontiguousarray(val, np.float64)
    assert tile.dtype == np.float64 and mask.dtype == np.uint8
    lib.ht_scatter_values(_p64(p), _pf64(v), ctypes.c_int64(len(p)),
                          _pf64(tile), _pu8(mask), ctypes.c_int64(len(tile)))
