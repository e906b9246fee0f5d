"""Port copy of hal_tpu/tools/hal4dExtract.py (numpy only; imports pointing
at hal_tpu_torch), with one declared divergence: --device {cuda,cpu}
(default cuda).  With --conserved, the candidate codon prefixes of every
gene are collected first, and each leaf maps all of them in one batched
dispatch on that device (tools/_regions.map_by_owner, owner = (site, k)
for the prefix's k-th base), where the original calls the host map_source
twice a site and leaf (the original's _is_4d_site; here _Conserved).
The test reads the fragments as a set (any aligned base that differs
fails the site), so the output is the original's.  Output stays in line order, and a line the original fails on
(not BED12, an unknown sequence, a parse error) raises after the earlier
lines' output, as the original's per-line loop does.  A gene's exon
bases are read a block at a time, where the original reads them one base
at a time: the same sequence, without a Python call a base.  Without
--conserved nothing is mapped.

hal4dExtract — four-fold degenerate codon sites from BED12 genes
(reference extract/impl/hal4dExtract.cpp, extract/inc/hal4dExtract.h:20-35)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch import dna as dnacodec
from hal_tpu_torch.io.bed import BedLine, read_bed
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, out_stream, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device
from hal_tpu_torch.tools._regions import map_by_owner

# codon prefixes whose third position is 4-fold degenerate
# (standard genetic code: Leu CTN, Val GTN, Ser TCN, Pro CCN, Thr ACN,
#  Ala GCN, Arg CGN, Gly GGN)
FOURFOLD_PREFIXES = {"CT", "GT", "TC", "CC", "AC", "GC", "CG", "GG"}


def _upper(b):
    return np.where((b >= 97) & (b <= 122), b - 32, b).astype(np.uint8)


def _bases_at(genome, pos, rev):
    """get_dna_string(p, 1, reversed_=r).upper() for each p, r, as ASCII
    codes (get_dna's error where the genome stores no DNA)."""
    pos = np.asarray(pos, np.int64)
    if not genome.has_dna:
        genome.get_dna(0, 1)
    byte = np.asarray(genome.dna[pos >> 1], np.uint8)
    nib = np.where(pos & 1, byte & 0x0F, byte >> 4)
    b = dnacodec.UNPACK_MAP[nib]
    return _upper(np.where(np.asarray(rev, bool), dnacodec.COMP_MAP[b], b))


class _Conserved:
    """The --conserved test of the original's _is_4d_site for a batch of
    codon-prefix sites: every leaf (other than the genome) maps all sites'
    two prefix bases in one dispatch; a site's outcome is the first
    (leaf, k) in the original's loop order whose aligned base differs
    (False) or lies in a genome without DNA (get_dna's error)."""

    def __init__(self, aln, genome_name, sites, device):
        g = aln.open_genome(genome_name)
        sites = np.asarray(sites, np.int64)
        self.index = {int(p): i for i, p in enumerate(sites.tolist())}
        lo = (sites[:, None] + np.arange(2)[None, :]).reshape(-1)
        ref_b = (_bases_at(g, lo, np.zeros(len(lo), bool)) if len(lo)
                 else np.zeros(0, np.uint8))
        # per (site, leaf, k), in the original's loop order: the leaf's
        # first event (a base that differs, or a fragment without DNA)
        self.leaves, cols, no_dna = [], [], []
        for leaf in aln.genome_names():
            if leaf == genome_name or not aln.tree.is_leaf(leaf):
                continue
            lg = aln.open_genome(leaf)
            frags, bounds = map_by_owner(aln, genome_name, leaf, lo, lo + 1,
                                         device=device, do_dupes=False,
                                         atomize=False)
            cnt = np.diff(bounds)
            event = np.zeros(len(lo), bool)
            if not lg.has_dna:
                event = cnt > 0
            elif len(frags):
                owner = np.repeat(np.arange(len(lo)), cnt)
                b = _bases_at(lg, frags.tgt_lo, frags.rev)
                event[owner[b != ref_b[owner]]] = True
            self.leaves.append(lg)
            cols.append(event.reshape(-1, 2))
            no_dna += [not lg.has_dna] * 2
        events = (np.concatenate(cols, axis=1) if cols
                  else np.zeros((len(sites), 0), bool))
        self.first = np.where(events.any(axis=1), events.argmax(axis=1), -1)
        self.no_dna = np.array(no_dna, bool)

    def __call__(self, pos) -> bool:
        """_is_4d_site(aln, genome_name, pos, True)."""
        j = self.first[self.index[pos]]
        if j < 0:
            return True
        if self.no_dna[j]:
            self.leaves[j // 2].get_dna(0, 1)
        return False


def _candidates(g, bed):
    """The original's per-line work before the conserved test: (base, [(gpos,
    p0), ...]) for each codon whose prefix is 4-fold degenerate."""
    if bed.bed_type < 12 or not bed.blocks:
        raise HalError("hal4dExtract requires BED12 input with blocks")
    si = g.sequence_index(bed.chrom)
    base = int(g.seq_start[si])
    # concatenate exon bases in transcription order
    blocks = sorted(bed.blocks)
    coords = []
    for bs, bl in blocks:
        s = base + bed.start + bs
        coords.extend(range(s, s + bl))
    # one read a block, not a base: the same string
    seq = "".join(g.get_dna_string(base + bed.start + bs, bl)
                  for bs, bl in blocks).upper()
    if bed.strand == "-":
        seq = dnacodec.reverse_complement(seq.encode()).tobytes().decode().upper()
        coords = coords[::-1]
    cands = []
    for c0 in range(0, len(seq) - 2, 3):
        prefix = seq[c0:c0 + 2]
        if prefix in FOURFOLD_PREFIXES:
            gpos = coords[c0 + 2]
            # codon-prefix genome positions for the conserved check
            p0 = min(coords[c0], coords[c0 + 1])
            cands.append((gpos, p0))
    return base, cands


def extract_4d(aln, genome_name, bed_lines, os_, conserved=False, *,
               device="cuda"):
    g = aln.open_genome(genome_name)
    lines, failure = [], None
    it = iter(bed_lines)
    while True:
        try:
            bed = next(it)
        except StopIteration:
            break
        except Exception as e:  # raised below, after the earlier lines
            failure = e
            break
        try:
            lines.append((bed, *_candidates(g, bed)))
        except Exception as e:  # raised below, after the earlier lines
            failure = e
            break
    if conserved:
        sites = sorted({p0 for _b, _base, cands in lines for _gp, p0 in cands})
        is_4d = _Conserved(aln, genome_name, sites, device)
    else:
        def is_4d(_pos):
            return True
    for bed, base, cands in lines:
        out_positions = [gpos for gpos, p0 in cands if is_4d(p0)]
        for gp in sorted(out_positions):
            rel = gp - base
            line = BedLine(chrom=bed.chrom, start=rel, end=rel + 1, bed_type=min(bed.bed_type, 6),
                           name=bed.name, score=bed.score, strand=bed.strand)
            os_.write(line.write())
    if failure is not None:
        raise failure


def run(argv=None):
    p = make_parser("hal4dExtract", "Extract Fourfold-Degenerate codon positions from BED12 genes")
    p.add_argument("halPath")
    p.add_argument("refGenome")
    p.add_argument("inBed")
    p.add_argument("outBed")
    p.add_argument("--append", action="store_true")
    p.add_argument("--conserved", action="store_true")
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)
    aln = open_alignment(o.halPath)
    stream = sys.stdin if o.inBed in ("stdin", "-") else open(o.inBed)
    if o.outBed in ("stdout", "-"):
        os_ = sys.stdout
    else:
        os_ = open(o.outBed, "a" if o.append else "w")
    extract_4d(aln, o.refGenome, read_bed(stream, 12), os_, o.conserved,
               device=o.device)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
