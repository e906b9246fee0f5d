"""Port copy of hal_tpu/tools/halBranchMutations.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

halBranchMutations — BED annotation of mutation events on a branch
(reference mutations/impl/halBranchMutations.cpp; tags :16-30:
V I D DB P U GI GD GDB, substitutions S_<parent><child>)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.ops.rearrangement import (DEFAULT_GAP_THRESHOLD, DEFAULT_N_THRESHOLD,
                                       analyze_branch)
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


BED_HEADER = ("#Sequence\tStart\tEnd\tMutationID\tParentGenome\tChildGenome\n"
              "#I=Insertion D=Deletion GI(D)=GapInsertion(GapDeletion) "
              "V=Inversion P=Transposition U=Duplication "
              "DB=Deletion Breakpoint GDB=Gap Deletion Breakpoint\n")


def _bed_writer(path, opened, headered):
    """Open (or reuse) an output stream and write the reference's two-line
    header once per stream (BranchMutations::writeHeaders,
    mutations/impl/halBranchMutations.cpp:258-265)."""
    if not path:
        return None
    if path in ("stdout", "-"):
        f = sys.stdout
    elif path in opened:
        f = opened[path]
    else:
        f = opened.setdefault(path, open(path, "w"))
    if id(f) not in headered:
        headered.add(id(f))
        f.write(BED_HEADER)
    return f


def run(argv=None):
    p = make_parser("halBranchMutations",
                    "Write mutations on branch above a genome to bed files")
    p.add_argument("halFile")
    p.add_argument("refGenome", help="bottom genome of the branch")
    p.add_argument("--refFile", default="", help="bed for rearrangements in ref coords")
    p.add_argument("--parentFile", default="", help="bed for deletions in parent coords")
    p.add_argument("--snpFile", default="", help="bed for point mutations")
    p.add_argument("--delBreakFile", default="", help="bed for deletion breakpoints")
    p.add_argument("--refSequence", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--maxGap", type=int, default=DEFAULT_GAP_THRESHOLD)
    p.add_argument("--maxNFraction", type=float, default=DEFAULT_N_THRESHOLD)
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    child = o.refGenome
    if child not in aln.tree:
        raise HalError("Reference genome %s not found" % child)
    parent = aln.tree.parent(child)
    if parent is None:
        raise HalError("Reference genome %s is the alignment root" % child)
    g = aln.open_genome(child)
    pg = aln.open_genome(parent)

    opened, headered = {}, set()
    ref_f = _bed_writer(o.refFile or ("stdout" if not (o.parentFile or o.snpFile or o.delBreakFile) else ""),
                        opened, headered)
    par_f = _bed_writer(o.parentFile, opened, headered)
    snp_f = _bed_writer(o.snpFile, opened, headered)
    db_f = _bed_writer(o.delBreakFile, opened, headered)

    res = analyze_branch(aln, child, o.maxGap, o.maxNFraction, do_subs=False)

    def emit(f, genome, lo, hi, tag):
        # column layout: seq start end tag parentGenome childGenome
        # (halBranchMutations.cpp:135-147,175-177,222-225)
        if f is None or lo < 0:
            return
        si = int(np.searchsorted(genome.seq_start, lo, side="right")) - 1
        base = int(genome.seq_start[si])
        f.write("%s\t%d\t%d\t%s\t%s\t%s\n"
                % (genome.seq_names[si], lo - base, hi - base, tag, parent, child))

    # window restriction
    win = None
    if o.refSequence:
        si = g.sequence_index(o.refSequence)
        base = int(g.seq_start[si])
        s = base + o.start
        win = (s, s + (o.length or (g.seq_length(si) - o.start)))

    def in_win(lo, hi):
        return win is None or (lo < win[1] and hi > win[0])

    for e in sorted(res.events, key=lambda e: (e.child_lo if e.child_lo != -1 else e.parent_lo)):
        if e.kind in ("I", "GI", "V", "U", "P", "O", "M"):
            if e.child_lo != -1 and in_win(e.child_lo, e.child_hi):
                emit(ref_f, g, e.child_lo, e.child_hi, e.kind)
        elif e.kind in ("D", "GD"):
            emit(par_f, pg, e.parent_lo, e.parent_hi, e.kind)
        elif e.kind in ("DB", "GDB"):
            if in_win(e.child_lo, e.child_hi):
                emit(db_f, g, e.child_lo, e.child_hi, e.kind)

    # substitutions
    if snp_f is not None:
        t_idx = np.flatnonzero(g.top_parent != NULL_INDEX)
        for k in t_idx:
            lo = int(g.top_start[k])
            hi = int(g.top_start[k + 1])
            if not in_win(lo, hi):
                continue
            cb = g.get_dna(lo, hi - lo)
            pbb = pg.get_dna(int(pg.bot_start[g.top_parent[k]]), hi - lo,
                             reversed_=bool(g.top_parent_reversed[k]))
            cu = np.where((cb >= 97) & (cb <= 122), cb - 32, cb)
            pu = np.where((pbb >= 97) & (pbb <= 122), pbb - 32, pbb)
            ne = (cu != pu) & (cu != ord("N")) & (pu != ord("N"))
            for j in np.flatnonzero(ne):
                pos = lo + int(j)
                emit(snp_f, g, pos, pos + 1, "S_%s%s" % (chr(pu[j]), chr(cu[j])))

    for f in opened.values():
        f.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
