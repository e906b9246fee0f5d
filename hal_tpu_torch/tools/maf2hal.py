"""Port copy of hal_tpu/tools/maf2hal.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

maf2hal — import a MAF into a (star-tree) HAL alignment
(reference maf/impl/maf2hal.cpp + MafScanDimensions/MafWriteGenomes,
maf/inc/halMafScanDimensions.h:24-33, halMafWriteGenomes.h:26-38).

Two passes over the blocks like the reference:
  pass 1 (dimensions): genomes, sequences, lengths; block runs split at
    every row's gap boundaries (each run = one HAL segment column)
  pass 2 (write): segment arrays, child links/paralogy rings, DNA

The output tree is a star: refGenome is the root, every other genome a
leaf (reference README.md:192-206).  Positions not covered by any MAF
block become unaligned filler segments with 'N' bases.  Overlapping target
rows (a leaf position aligned twice at the same root level) are dropped
with a warning (the reference's bad-position set behaves the same way).
"""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.genome import GenomeArrays, SequenceInfo
from hal_tpu_torch.io.maf_io import read_maf_blocks
from hal_tpu_torch.storage import save_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, save_kwargs, tool_main


def _split_name(src, genome_names):
    """MAF srcs are Genome.Sequence (UCSC convention); fall back to treating
    the whole src as both genome and sequence name."""
    if "." in src:
        g, _, s = src.partition(".")
        return g, s
    return src, src


def _block_runs(block):
    """Split a block's columns into runs at any row's gap boundaries.
    Yields (columns slice, rows-present list)."""
    width = len(block[0].text)
    # gap masks per row
    masks = [np.frombuffer(line.text.encode(), np.uint8) != ord("-") for line in block]
    present = np.stack(masks)  # rows x width
    change = np.zeros(width, bool)
    change[0] = True
    change[1:] = (present[:, 1:] != present[:, :-1]).any(axis=0)
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], width)
    for a, b in zip(starts, ends):
        rows = np.flatnonzero(present[:, a])
        yield int(a), int(b), rows.tolist()


def import_maf(stream, ref_genome: str | None = None) -> Alignment:
    blocks = list(read_maf_blocks(stream))
    if not blocks:
        raise HalError("MAF contains no blocks")
    if ref_genome is None:
        ref_genome = _split_name(blocks[0][0].src, None)[0]

    # ---- pass 1: dimensions ------------------------------------------
    seq_sizes: dict[str, dict[str, int]] = defaultdict(dict)
    genome_order: list[str] = []
    for block in blocks:
        for line in block:
            g, s = _split_name(line.src, None)
            if g not in seq_sizes:
                genome_order.append(g)
            if s in seq_sizes[g] and seq_sizes[g][s] != line.src_size:
                raise HalError("inconsistent srcSize for %s" % line.src)
            seq_sizes[g][s] = line.src_size
    if ref_genome not in seq_sizes:
        raise HalError("reference genome %s not found in MAF" % ref_genome)

    leaves = [g for g in genome_order if g != ref_genome]

    # per-genome: sequence name -> (sorted by first appearance)
    aln = Alignment()
    aln.add_root_genome(ref_genome)
    for l in leaves:
        aln.tree.add_child(ref_genome, l, 1.0)

    # sequence offsets within each genome (order of first appearance)
    seq_off: dict[str, dict[str, int]] = {}
    for g in genome_order:
        off = {}
        total = 0
        for s in seq_sizes[g]:
            off[s] = total
            total += seq_sizes[g][s]
        seq_off[g] = off

    # ---- collect segments from block runs ----------------------------
    # per genome: list of (start, length, parent_key|None, reversed, bases)
    # parent_key identifies the root segment a leaf segment aligns to.
    root_segs = {}     # root_start -> (length, bases)
    leaf_segs = defaultdict(list)  # genome -> list of dicts
    covered = defaultdict(list)    # genome -> intervals (for overlap check)

    def row_coords(line, a, b, genome, seq):
        """Forward genome coords + strand of columns [a,b) of a row."""
        text = line.text
        upto_a = text[:a].replace("-", "")
        seg = text[a:b].replace("-", "")
        n = len(seg)
        p = line.start + len(upto_a)
        base = seq_off[genome][seq]
        if line.strand == "+":
            lo = base + p
            return lo, n, False, seg
        else:
            lo = base + line.src_size - (p + n)
            return lo, n, True, seg

    for block in blocks:
        for a, b, rows in _block_runs(block):
            ref_rows = [i for i in rows
                        if _split_name(block[i].src, None)[0] == ref_genome]
            other_rows = [i for i in rows if i not in ref_rows]
            if len(ref_rows) > 1:
                sys.stderr.write("maf2hal: duplicate reference rows in block run; keeping first\n")
                ref_rows = ref_rows[:1]
            parent_key = None
            if ref_rows:
                line = block[ref_rows[0]]
                g, s = _split_name(line.src, None)
                lo, n, rev, seg = row_coords(line, a, b, g, s)
                if rev:
                    raise HalError("maf2hal requires reference rows on + strand")
                if lo in root_segs and root_segs[lo][0] != n:
                    raise HalError("inconsistent reference segmentation at %d" % lo)
                root_segs[lo] = (n, seg)
                parent_key = lo
            for i in other_rows:
                line = block[i]
                g, s = _split_name(line.src, None)
                lo, n, rev, seg = row_coords(line, a, b, g, s)
                leaf_segs[g].append(dict(start=lo, length=n, parent=parent_key,
                                         reversed=rev, bases=seg))

    # ---- build genomes ------------------------------------------------
    root_starts = sorted(root_segs)

    def with_fillers(starts_lengths, seq_bounds):
        """Tile [0, total) with aligned segments + fillers; fillers split at
        sequence boundaries (segments never span sequences)."""
        total = seq_bounds[-1]
        out = []
        pos = 0

        def fill(lo, hi):
            # split [lo, hi) at interior sequence boundaries
            cuts = [b for b in seq_bounds if lo < b < hi]
            prev = lo
            for c in cuts + [hi]:
                if c > prev:
                    out.append((prev, c - prev, True))
                prev = c

        for lo, ln in starts_lengths:
            if lo < pos:
                return None, (lo, pos)  # overlap
            if lo > pos:
                fill(pos, lo)
            out.append((lo, ln, False))
            pos = lo + ln
        if pos < total:
            fill(pos, total)
        return out, None

    root_bounds = _seq_bounds(seq_sizes[ref_genome])
    tiles, overlap = with_fillers([(lo, root_segs[lo][0]) for lo in root_starts], root_bounds)
    if tiles is None:
        raise HalError("overlapping reference rows at %d" % overlap[0])

    n_children = len(leaves)
    root_g = _make_genome(ref_genome, seq_sizes[ref_genome],
                          bot_tiles=tiles, top_tiles=None, n_children=n_children)
    bot_index_of = {}
    for i, (lo, ln, filler) in enumerate(tiles):
        root_g.bot_start[i] = lo
        bot_index_of[lo] = i
        if not filler:
            root_g.set_dna(lo, root_segs[lo][1])
        else:
            root_g.set_dna(lo, "N" * ln)
    aln.set_genome(root_g)

    # leaves
    for slot, g in enumerate(leaves):
        segs = sorted(leaf_segs[g], key=lambda d: (d["start"], d.get("parent") or 0))
        # drop overlapping rows (bad-position behaviour)
        cleaned = []
        pos = 0
        dropped = 0
        for d in segs:
            if d["start"] < pos:
                dropped += 1
                continue
            cleaned.append(d)
            pos = d["start"] + d["length"]
        if dropped:
            sys.stderr.write("maf2hal: dropped %d overlapping rows for %s\n" % (dropped, g))
        tiles_g, _ = with_fillers([(d["start"], d["length"]) for d in cleaned],
                                  _seq_bounds(seq_sizes[g]))
        gg = _make_genome(g, seq_sizes[g], bot_tiles=None, top_tiles=tiles_g, n_children=0)
        seg_iter = iter(cleaned)
        ring_prev = {}
        for i, (lo, ln, filler) in enumerate(tiles_g):
            gg.top_start[i] = lo
            if filler:
                gg.set_dna(lo, "N" * ln)
                continue
            d = next(seg_iter)
            assert d["start"] == lo
            gg.set_dna(lo, d["bases"] if not d["reversed"] else _revcomp(d["bases"]))
            if d["parent"] is not None:
                p = bot_index_of[d["parent"]]
                gg.top_parent[i] = p
                gg.top_parent_reversed[i] = 1 if d["reversed"] else 0
                root_g.bot_child[p, slot] = i
                root_g.bot_child_reversed[p, slot] = 1 if d["reversed"] else 0
                if p in ring_prev:
                    # link into the ring: prev -> i, i -> first
                    first, prev = ring_prev[p]
                    gg.top_paralogy[prev] = i
                    gg.top_paralogy[i] = first
                    ring_prev[p] = (first, i)
                else:
                    ring_prev[p] = (i, i)
        aln.set_genome(gg)

    return aln


def _revcomp(s: str) -> str:
    from hal_tpu_torch import dna as dnacodec

    return dnacodec.reverse_complement(s.encode()).tobytes().decode()


def _seq_bounds(seqs: dict[str, int]):
    bounds = [0]
    for s in seqs:
        bounds.append(bounds[-1] + seqs[s])
    return bounds


def _make_genome(name, seqs: dict[str, int], bot_tiles, top_tiles, n_children: int):
    """Allocate with per-sequence segment counts derived from tile positions."""
    bounds = _seq_bounds(seqs)
    import numpy as _np

    def counts(tiles):
        c = [0] * (len(bounds) - 1)
        if tiles:
            for lo, ln, _f in tiles:
                si = int(_np.searchsorted(bounds, lo, side="right")) - 1
                c[si] += 1
        return c

    nb = counts(bot_tiles)
    nt = counts(top_tiles)
    infos = [SequenceInfo(s, seqs[s], nt[i], nb[i]) for i, s in enumerate(seqs)]
    return GenomeArrays.create(name, infos, num_children=n_children)


def run(argv=None):
    p = make_parser("maf2hal", "import maf into hal database")
    p.add_argument("mafFile", help="input maf (or stdin)")
    p.add_argument("halFile", help="output hal path")
    p.add_argument("--refGenome", default=None, help="name of reference genome "
                   "(first genome in maf if empty)")
    p.add_argument("--targetGenomes", default="", help="restrict to these genomes")
    add_storage_options(p, write=True)
    o = p.parse_args(argv)

    stream = sys.stdin if o.mafFile in ("stdin", "-") else open(o.mafFile)
    aln = import_maf(stream, o.refGenome or None)
    if o.targetGenomes:
        keep = set(o.targetGenomes.split(",")) | {aln.root_name}
        for g in list(aln.genome_names()):
            if g not in keep:
                aln.remove_genome(g)
    save_alignment(aln, o.halFile, **save_kwargs(o))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
