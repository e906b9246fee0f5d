"""Port copy of hal_tpu/io/bbi.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Native bigWig / bigBed writers — no kent binaries.

The reference's assemblyHub pipeline shells out to wigToBigWig /
bedToBigBed (reference assemblyHub/*Track.py; hal2assemblyHub.py requires
the kent userApps on PATH), so a hub build fails without UCSC's binaries.
hal_tpu writes the BBI container directly (format per the BigWig/BigBed
paper, Kent et al. 2010, and kent/src/inc/bbiFile.h):

    [common header][zoom headers][total summary][chrom B+ tree]
    [full data: u64 count + sections/items][full R-tree index]
    [per zoom level: u32 count + summary records + R-tree]

Layout choices (all spec-legal):
  * sections zlib-compressed by default (uncompressBufSize = max
    uncompressed section size, kent's contract; compress=False restores
    raw sections).
  * bigWig sections are bedGraph-typed (type 1) — the general encoding;
    fixedStep inputs are expressed as runs.
  * a zoom LADDER (x4 reductions, kent's bbiWrite shape): the finest
    level targets ~10 items per window of the mean item span, coarser
    levels follow until few records remain (browsers pick the level
    matching the view resolution).
  * chromIds are ranks in lexicographic chrom-name order, matching the
    B+ tree's key order; data blocks are written sorted by
    (chromId, start) as the R-tree requires.

tests/test_bbi.py decodes the emitted files with an independent
struct-level reader (the test_mmap_struct_decode pattern) and checks
values, summaries and R-tree bounds against the inputs.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
BIGBED_MAGIC = 0x8789F2EB
BPT_MAGIC = 0x78CA8C91
CIR_MAGIC = 0x2468ACE0
BBI_VERSION = 4
BLOCK_SIZE = 256        # B+ / R-tree fanout
ITEMS_PER_SLOT = 512    # data items per block
ZOOM_PER_SLOT = 512     # zoom records per indexed block


@dataclass
class _Block:
    """Bounds + extent of one written data block (R-tree leaf entry)."""

    start_chrom: int
    start: int
    end_chrom: int
    end: int
    offset: int
    size: int


def _chrom_ids(chrom_sizes: dict) -> dict:
    return {name: i for i, name in enumerate(sorted(chrom_sizes))}


# ------------------------------------------------------------- B+ tree

def _chunk(seq, size):
    return [seq[i:i + size] for i in range(0, len(seq), size)] or [[]]


def _write_chrom_bpt(f, chrom_sizes: dict) -> None:
    """Multi-level B+ tree: leaves hold <= BLOCK_SIZE (key, id, size)
    items, index levels above are keyed by each child's first key, until a
    single root — the same shape kent's bptFileCreate writes top-down
    (ADVICE r4: a single oversized leaf violated the declared blockSize
    for assemblies with > 256 sequences)."""
    names = sorted(chrom_sizes)
    key_size = max(len(n) for n in names) if names else 1
    f.write(struct.pack("<IIIIQQ", BPT_MAGIC, BLOCK_SIZE, key_size, 8,
                        len(names), 0))
    items = [(n.encode(), i, int(chrom_sizes[n])) for i, n in enumerate(names)]
    levels = [_chunk(items, BLOCK_SIZE)]          # bottom-up
    while len(levels[-1]) > 1:
        levels.append(_chunk(levels[-1], BLOCK_SIZE))
    levels.reverse()                              # root level first
    # offsets: nodes are written root-first in level order; every node
    # (leaf item or index entry) costs key_size + 8 bytes per entry
    pos = f.tell()
    offs = []
    for level in levels:
        level_offs = []
        for node in level:
            level_offs.append(pos)
            pos += 4 + len(node) * (key_size + 8)
        offs.append(level_offs)

    def first_key(node):
        while node and isinstance(node[0], list):
            node = node[0]
        return node[0][0] if node else b""

    for li, level in enumerate(levels):
        is_leaf = li == len(levels) - 1
        for ni, node in enumerate(level):
            f.write(struct.pack("<BBH", 1 if is_leaf else 0, 0, len(node)))
            if is_leaf:
                for key, cid, size in node:
                    f.write(key + b"\x00" * (key_size - len(key)))
                    f.write(struct.pack("<II", cid, size))
            else:
                # children of node ni are consecutive in the next level
                for ci, child in enumerate(node):
                    key = first_key(child)
                    f.write(key + b"\x00" * (key_size - len(key)))
                    f.write(struct.pack("<Q",
                                        offs[li + 1][ni * BLOCK_SIZE + ci]))


# -------------------------------------------------------------- R-tree

def _span_bounds(blocks):
    s_cix = min(b.start_chrom for b in blocks)
    e_cix = max(b.end_chrom for b in blocks)
    s_base = min(b.start for b in blocks if b.start_chrom == s_cix)
    e_base = max(b.end for b in blocks if b.end_chrom == e_cix)
    return s_cix, s_base, e_cix, e_base


def _write_rtree(f, blocks: list, end_file_offset: int) -> None:
    n = len(blocks)
    if n:
        s_cix, s_base, e_cix, e_base = _span_bounds(blocks)
    else:
        s_cix = e_cix = s_base = e_base = 0
    # itemsPerSlot = 1: the tree's items ARE the blocks (kent bbiWrite.c
    # passes 1 to cirTreeFileCreate; readers treat it as informational)
    f.write(struct.pack("<IIQIIIIQII", CIR_MAGIC, BLOCK_SIZE, n, s_cix,
                        s_base, e_cix, e_base, end_file_offset, 1, 0))

    # bottom-up level structure (leaf groups, then index levels of
    # <= BLOCK_SIZE children each, up to one root — any data-block count
    # indexes without exceeding the declared fanout; the old 2-level
    # layout overflowed struct 'H' past ~131k blocks, ADVICE r4)
    levels = [_chunk(blocks, BLOCK_SIZE)]
    while len(levels[-1]) > 1:
        levels.append(_chunk(levels[-1], BLOCK_SIZE))
    levels.reverse()  # root level first

    def leaf_blocks(node):
        while node and isinstance(node[0], list):
            node = [b for child in node for b in child]
        return node

    pos = f.tell()
    offs = []
    for li, level in enumerate(levels):
        is_leaf = li == len(levels) - 1
        per = 32 if is_leaf else 24
        level_offs = []
        for node in level:
            level_offs.append(pos)
            pos += 4 + len(node) * per
        offs.append(level_offs)
    for li, level in enumerate(levels):
        is_leaf = li == len(levels) - 1
        for ni, node in enumerate(level):
            f.write(struct.pack("<BBH", 1 if is_leaf else 0, 0, len(node)))
            if is_leaf:
                for b in node:
                    f.write(struct.pack("<IIIIQQ", b.start_chrom, b.start,
                                        b.end_chrom, b.end, b.offset, b.size))
            else:
                for ci, child in enumerate(node):
                    lb = leaf_blocks(child)
                    s_cix, s_base, e_cix, e_base = _span_bounds(lb)
                    f.write(struct.pack("<IIIIQ", s_cix, s_base, e_cix,
                                        e_base,
                                        offs[li + 1][ni * BLOCK_SIZE + ci]))


# ---------------------------------------------------------------- zoom

def _zoom_records(data_by_chrom, ids, reduction, chrom_sizes):
    """(chromId, start, end, valid, min, max, sum, sumsq) per window with
    any covered base, per chrom; window ends clip to the chrom length."""
    out = []
    for name in sorted(data_by_chrom):
        cid = ids[name]
        size = int(chrom_sizes[name])
        for w0, stats in sorted(_windows(data_by_chrom[name],
                                         reduction).items()):
            out.append((cid, w0 * reduction,
                        min((w0 + 1) * reduction, size)) + stats)
    return out


def _windows(runs, reduction):
    wins = {}
    for s, e, v in runs:
        w = s // reduction
        while w * reduction < e:
            lo = max(s, w * reduction)
            hi = min(e, (w + 1) * reduction)
            n = hi - lo
            c, mn, mx, sm, sq = wins.get(w, (0, np.inf, -np.inf, 0.0, 0.0))
            wins[w] = (c + n, min(mn, v), max(mx, v), sm + n * v,
                       sq + n * v * v)
            w += 1
    return wins


def _write_zoom(f, records, compress):
    """Zoom data (u32 count + 32-byte summary records, matching kent's
    bbiWrite zoom writer — ADVICE r4; the full-data count stays u64) + its
    R-tree.  Returns (data_offset, index_offset, max_uncompressed)."""
    data_offset = f.tell()
    f.write(struct.pack("<I", len(records)))
    blocks = []
    max_raw = 0
    for i in range(0, len(records), ZOOM_PER_SLOT):
        grp = records[i:i + ZOOM_PER_SLOT]
        off = f.tell()
        raw = b"".join(struct.pack("<IIIIffff", r[0], r[1], r[2], r[3],
                                   r[4], r[5], r[6], r[7]) for r in grp)
        max_raw = max(max_raw, len(raw))
        f.write(zlib.compress(raw) if compress else raw)
        blocks.append(_Block(grp[0][0], grp[0][1], grp[-1][0],
                             max(r[2] for r in grp), off, f.tell() - off))
    index_offset = f.tell()
    _write_rtree(f, blocks, index_offset)
    return data_offset, index_offset, max_raw


def _depth_runs(intervals):
    """Constant-depth coverage runs (start, end, depth) from possibly
    overlapping half-open intervals, depth > 0 only, adjacent equal-depth
    runs merged."""
    events = []
    for s, e in intervals:
        events.append((s, 1))
        events.append((e, -1))
    events.sort()
    runs = []
    depth = 0
    prev = None
    for pos, d in events:
        if depth > 0 and prev is not None and pos > prev:
            if runs and runs[-1][1] == prev and runs[-1][2] == depth:
                runs[-1] = (runs[-1][0], pos, depth)
            else:
                runs.append((prev, pos, depth))
        depth += d
        prev = pos
    return [(s, e, float(v)) for s, e, v in runs]


# ------------------------------------------------------------- summary

def _total_summary(data_by_chrom):
    c, mn, mx, sm, sq = 0, np.inf, -np.inf, 0.0, 0.0
    for runs in data_by_chrom.values():
        for s, e, v in runs:
            n = e - s
            c += n
            mn = min(mn, v)
            mx = max(mx, v)
            sm += n * v
            sq += n * v * v
    if c == 0:
        mn = mx = 0.0
    return c, mn, mx, sm, sq


def _pick_reduction(chrom_sizes):
    total = sum(int(v) for v in chrom_sizes.values()) or 1
    red = 1
    while total // red > 10000:
        red *= 4
    return max(red, 16)


def _zoom_ladder(data_by_chrom, ids, chrom_sizes, max_levels=8):
    """[(reduction, records), ...] fine -> coarse: the finest level
    targets ~10 mean item spans per window (kent bbiWrite's initial
    reduction), coarser levels multiply by 4 until few records remain."""
    n = sum(len(r) for r in data_by_chrom.values())
    covered = sum(e - s for rs in data_by_chrom.values() for s, e, _v in rs)
    if n == 0:
        return []
    red = max(16, 10 * covered // n)
    ladder = []
    while len(ladder) < max_levels:
        recs = _zoom_records(data_by_chrom, ids, red, chrom_sizes)
        if ladder and len(recs) >= len(ladder[-1][1]):
            break
        ladder.append((red, recs))
        if len(recs) <= 64:
            break
        red *= 4
    return ladder


# ------------------------------------------------------------- bigWig

def write_bigwig(path: str, chrom_sizes: dict, data_by_chrom: dict,
                 compress: bool = True) -> None:
    """data_by_chrom: chrom -> iterable of (start, end, value) runs
    (0-based half-open, non-overlapping, sorted)."""
    ids = _chrom_ids(chrom_sizes)
    data_by_chrom = {c: [(int(s), int(e), float(v))
                         for s, e, v in runs if e > s]
                     for c, runs in data_by_chrom.items()}
    for c, runs in data_by_chrom.items():
        runs.sort()
        for (s0, e0, _v0), (s1, _e1, _v1) in zip(runs, runs[1:]):
            if s1 < e0:
                # overlaps would corrupt the R-tree bounds and the
                # summaries; kent's wigToBigWig rejects them the same way
                raise ValueError(
                    "overlapping wiggle runs on %s at %d < %d" % (c, s1, e0))
    ladder = _zoom_ladder(data_by_chrom, ids, chrom_sizes)
    with open(path, "wb") as f:
        f.write(b"\x00" * (64 + 24 * max(len(ladder), 1)))
        summary_offset = f.tell()
        f.write(b"\x00" * 40)
        chrom_tree_offset = f.tell()
        _write_chrom_bpt(f, chrom_sizes)
        # full data: u64 section count, then bedGraph sections
        full_data_offset = f.tell()
        sections = []
        for name in sorted(data_by_chrom):
            runs = data_by_chrom[name]
            for i in range(0, len(runs), ITEMS_PER_SLOT):
                sections.append((ids[name], runs[i:i + ITEMS_PER_SLOT]))
        f.write(struct.pack("<Q", len(sections)))
        blocks = []
        max_raw = 0
        for cid, runs in sections:
            off = f.tell()
            raw = struct.pack("<IIIIIBBH", cid, runs[0][0], runs[-1][1],
                              0, 0, 1, 0, len(runs))  # type 1 bedGraph
            raw += b"".join(struct.pack("<IIf", s, e, v)
                            for s, e, v in runs)
            max_raw = max(max_raw, len(raw))
            f.write(zlib.compress(raw) if compress else raw)
            blocks.append(_Block(cid, runs[0][0], cid, runs[-1][1], off,
                                 f.tell() - off))
        full_index_offset = f.tell()
        _write_rtree(f, blocks, full_index_offset)
        zooms = []
        for (red, recs) in ladder:
            zd, zi, zraw = _write_zoom(f, recs, compress)
            max_raw = max(max_raw, zraw)
            zooms.append((red, zd, zi))
        # rewrite header + zoom headers + summary
        f.seek(0)
        f.write(struct.pack("<IHHQQQHHQQIQ", BIGWIG_MAGIC, BBI_VERSION,
                            len(zooms), chrom_tree_offset, full_data_offset,
                            full_index_offset, 0, 0, 0, summary_offset,
                            max_raw if compress else 0, 0))
        for (red, zd, zi) in zooms:
            f.write(struct.pack("<IIQQ", red, 0, zd, zi))
        f.seek(summary_offset)
        c, mn, mx, sm, sq = _total_summary(data_by_chrom)
        f.write(struct.pack("<Qdddd", c, mn, mx, sm, sq))


# ------------------------------------------------------------- bigBed

def write_bigbed(path: str, chrom_sizes: dict, beds: list,
                 field_count: int = 3, compress: bool = True) -> None:
    """beds: (chrom, start, end[, rest-string]) tuples; rest joins the
    extra bed columns tab-separated (stored null-terminated per spec)."""
    ids = _chrom_ids(chrom_sizes)
    items = []
    for b in beds:
        chrom, s, e = b[0], int(b[1]), int(b[2])
        rest = b[3] if len(b) > 3 else ""
        items.append((ids[chrom], s, e, rest))
    items.sort(key=lambda t: (t[0], t[1], t[2]))
    # zoom/summary over coverage DEPTH (kent's bedToBigBed summarizes
    # overlap depth: min/max/sum/sumsq reflect how many features cover a
    # base, ADVICE r4); runs are disjoint constant-depth segments, so
    # validCount still counts union bases and never exceeds the span
    cov = {}
    inv = {v: k for k, v in ids.items()}
    for cid, s, e, _ in items:
        cov.setdefault(inv[cid], []).append((s, e))
    cov = {c: _depth_runs(ivs) for c, ivs in cov.items()}
    ladder = _zoom_ladder(cov, ids, chrom_sizes)
    with open(path, "wb") as f:
        f.write(b"\x00" * (64 + 24 * max(len(ladder), 1)))
        summary_offset = f.tell()
        f.write(b"\x00" * 40)
        chrom_tree_offset = f.tell()
        _write_chrom_bpt(f, chrom_sizes)
        full_data_offset = f.tell()
        f.write(struct.pack("<Q", len(items)))
        blocks = []
        max_raw = 0
        i = 0
        while i < len(items):
            j = i
            cid = items[i][0]
            while (j < len(items) and items[j][0] == cid
                   and j - i < ITEMS_PER_SLOT):
                j += 1
            grp = items[i:j]
            off = f.tell()
            raw = b"".join(struct.pack("<III", cid, s, e)
                           + rest.encode() + b"\x00"
                           for _, s, e, rest in grp)
            max_raw = max(max_raw, len(raw))
            f.write(zlib.compress(raw) if compress else raw)
            blocks.append(_Block(cid, grp[0][1], cid,
                                 max(g[2] for g in grp), off,
                                 f.tell() - off))
            i = j
        full_index_offset = f.tell()
        _write_rtree(f, blocks, full_index_offset)
        zooms = []
        for (red, recs) in ladder:
            zd, zi, zraw = _write_zoom(f, recs, compress)
            max_raw = max(max_raw, zraw)
            zooms.append((red, zd, zi))
        f.seek(0)
        f.write(struct.pack("<IHHQQQHHQQIQ", BIGBED_MAGIC, BBI_VERSION,
                            len(zooms), chrom_tree_offset, full_data_offset,
                            full_index_offset, field_count,
                            min(field_count, 12), 0, summary_offset,
                            max_raw if compress else 0, 0))
        for (red, zd, zi) in zooms:
            f.write(struct.pack("<IIQQ", red, 0, zd, zi))
        f.seek(summary_offset)
        c, mn, mx, sm, sq = _total_summary(cov)
        f.write(struct.pack("<Qdddd", c, mn, mx, sm, sq))


# ------------------------------------------------- wiggle-file frontend

def wig_to_bigwig(wig_path: str, chrom_sizes: dict, bw_path: str) -> None:
    """Parse fixedStep/variableStep/bedGraph wiggle text and write the
    bigWig (the wigToBigWig command-line contract)."""
    data: dict = {}
    chrom, span, step, pos, mode = None, 1, 1, 0, None
    with open(wig_path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(("#", "track", "browser")):
                continue
            if line.startswith("fixedStep"):
                kv = dict(p.split("=", 1) for p in line.split()[1:])
                chrom = kv["chrom"]
                pos = int(kv["start"]) - 1
                step = int(kv.get("step", 1))
                span = int(kv.get("span", 1))
                mode = "fixed"
                continue
            if line.startswith("variableStep"):
                kv = dict(p.split("=", 1) for p in line.split()[1:])
                chrom = kv["chrom"]
                span = int(kv.get("span", 1))
                mode = "var"
                continue
            parts = line.split()
            if mode == "fixed":
                data.setdefault(chrom, []).append(
                    (pos, pos + span, float(parts[0])))
                pos += step
            elif mode == "var":
                s = int(parts[0]) - 1
                data.setdefault(chrom, []).append(
                    (s, s + span, float(parts[1])))
            else:  # bedGraph line
                data.setdefault(parts[0], []).append(
                    (int(parts[1]), int(parts[2]), float(parts[3])))
    for runs in data.values():
        runs.sort()
    write_bigwig(bw_path, chrom_sizes, data)


def bed_to_bigbed(bed_path: str, chrom_sizes: dict, bb_path: str) -> None:
    beds = []
    field_count = 3
    with open(bed_path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            p = line.split("\t") if "\t" in line else line.split()
            field_count = max(field_count, len(p))
            beds.append((p[0], int(p[1]), int(p[2]), "\t".join(p[3:])))
    write_bigbed(bb_path, chrom_sizes, beds, field_count=field_count)
