"""Port copy of hal_tpu/tools/halPctId.py (numpy only; the same code,
imports pointing at hal_tpu_torch).  The port's halStats runs it.

halPctId / halStats --percentID — percent identity vs a reference
(reference stats/impl/halStatsMain.cpp:537-640 printPercentID).

Columns counted only when the reference base is not N and the reference is
single-copy in the column; a genome contributes only when it has exactly
one non-N site in the column."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.ops.column import compute_scope
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main

WINDOW = 1 << 20


def _upper(b):
    return np.where((b >= 97) & (b <= 122), b - 32, b)


def print_percent_id(os, aln, ref_name):
    if ref_name not in aln.tree:
        raise HalError("Genome %s does not exist." % ref_name)
    ref = aln.open_genome(ref_name)
    scope, scope_root = compute_scope(aln, ref_name)
    num_id = {g: 0 for g in sorted(scope)}
    num_sites = {g: 0 for g in sorted(scope)}

    pos = 0
    while pos < ref.length:
        end = min(pos + WINDOW, ref.length)
        n = end - pos
        ref_bases = _upper(ref.get_dna(pos, n))
        ref_ok = ref_bases != ord("N")

        # reference single-copy mask (incl. identity row)
        rcount = np.zeros(n, np.int64)
        rfrags = sm.map_source(aln, ref_name, np.array([pos]), np.array([end]),
                               ref_name, do_dupes=True, coalescence_limit=scope_root)
        for i in range(len(rfrags)):
            rcount[int(rfrags.src_lo[i]) - pos: int(rfrags.src_hi[i]) - pos] += 1
        col_ok = ref_ok & (rcount == 1)

        for g in sorted(scope):
            tg = aln.open_genome(g)
            if g == ref_name:
                frags = rfrags
            else:
                frags = sm.map_source(aln, ref_name, np.array([pos]), np.array([end]),
                                      g, do_dupes=True, coalescence_limit=scope_root)
            count = np.zeros(n, np.int64)
            base = np.zeros(n, np.uint8)
            nmask = np.zeros(n, bool)
            for i in range(len(frags)):
                sl = int(frags.src_lo[i]) - pos
                sh = int(frags.src_hi[i]) - pos
                b = _upper(tg.get_dna(int(frags.tgt_lo[i]),
                                      int(frags.tgt_hi[i]) - int(frags.tgt_lo[i]),
                                      reversed_=bool(frags.rev[i])))
                isn = b == ord("N")
                # N sites don't count toward the per-genome site count
                count[sl:sh] += (~isn).astype(np.int64)
                keep = ~isn
                seg = slice(sl, sh)
                base[seg] = np.where(keep, b, base[seg])
            ok = col_ok & (count == 1)
            num_sites[g] += int(ok.sum())
            num_id[g] += int((ok & (base == ref_bases)).sum())
        pos = end

    os.write("Genome, % ID, numID, numSites\n")
    for g in sorted(scope):
        ns = num_sites[g]
        os.write("%s, %s, %d, %d\n" % (g, ("%g" % (num_id[g] / ns)) if ns else "nan",
                                       num_id[g], ns))


def run(argv=None):
    p = make_parser("halPctId", "Print percent identity of genomes vs a reference")
    p.add_argument("halFile")
    p.add_argument("refGenome")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    print_percent_id(sys.stdout, aln, o.refGenome)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
