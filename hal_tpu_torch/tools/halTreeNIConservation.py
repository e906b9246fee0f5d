"""Port copy of hal_tpu/tools/halTreeNIConservation.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

halTreeNIConservation — neutral-indel conserved-interval calls for every
genome below the root (reference
analysis/neutralIndel/halTreeNIConservation.py:46-67)."""

from __future__ import annotations

import os
import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.analysis.neutral_indel import DEFAULT_EVENTS, BedConservation
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main


def run(argv=None):
    p = make_parser("halTreeNIConservation",
                    "Identify conserved intervals from inter-mutation distances")
    p.add_argument("halFile")
    p.add_argument("workDir")
    p.add_argument("--backgroundBedName", default="%%s_bg.bed")
    p.add_argument("--mutationsBedName", default="%%s.bed")
    p.add_argument("--conservedBedName", default="%%s_cons.bed")
    p.add_argument("--root", default=None)
    p.add_argument("--events", default=" ".join(DEFAULT_EVENTS))
    p.add_argument("--pval", type=float, default=0.05)
    p.add_argument("--cutoff", type=float, default=0.5,
                   help="cut <cutoff>*mu^-1 off each side of interval")
    add_storage_options(p)
    o = p.parse_args(argv)
    bg_name = o.backgroundBedName.replace("%%", "%")
    mu_name = o.mutationsBedName.replace("%%", "%")
    cons_name = o.conservedBedName.replace("%%", "%")
    events = o.events.split()

    aln = open_alignment(o.halFile)
    root = o.root or aln.root_name

    def genome_length(name):
        g = aln.open_genome(name)
        return int(g.length)

    def process(child):
        bg = os.path.join(o.workDir, bg_name % child)
        mu = os.path.join(o.workDir, mu_name % child)
        for f, tool in ((bg, "halTreeNIBackground"), (mu, "halTreeMutations")):
            if not os.path.isfile(f):
                raise RuntimeError(
                    "%s not found. Make sure %s has been run and the paths "
                    "are correctly specified" % (f, tool))
        out_path = os.path.join(o.workDir, cons_name % child)
        bc = BedConservation()
        bc.compute_background_rate(mu, bg, events)
        with open(out_path, "w") as out:
            bc.identify_conserved_intervals(mu, out, o.pval, o.cutoff)
        print("%s: %d segments with %d bases (%f pct of genome) found. "
              "bgrate= %f minDist=%d" % (
                  child, bc.written_count, bc.written_bases,
                  float(bc.written_bases) / float(genome_length(child)),
                  bc.rate, bc.min_distance(o.pval) or -1))

    def recurse(node):
        for child in aln.tree.children(node):
            process(child)
            recurse(child)

    recurse(root)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
