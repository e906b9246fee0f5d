"""Port copy of hal_tpu/tools/halTreeNITurnover.py (numpy only; imports
pointing at hal_tpu_torch), with one declared divergence: --device
{cuda,cpu} (default cuda), passed to compare_conservation_over_branch,
whose two liftovers a branch then map on that device; stdout and every
BED it writes are the original's.

halTreeNITurnover — constraint gain/loss/conservation census over every
branch (reference analysis/neutralIndel/halTreeNITurnover.py:33-85), using
in-process liftover + native interval algebra instead of bedtools."""

from __future__ import annotations

import os
import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.analysis.neutral_indel import compare_conservation_over_branch
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device


def run(argv=None):
    p = make_parser("halTreeNITurnover",
                    "Compute constraint turnover stats over the entire tree")
    p.add_argument("halFile")
    p.add_argument("workDir")
    p.add_argument("--conservedBedName", default="%%s_cons.bed")
    p.add_argument("--root", default=None)
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)
    cons_name = o.conservedBedName.replace("%%", "%")

    aln = open_alignment(o.halFile)
    root_name = aln.root_name
    start = o.root or root_name

    def check(path):
        if not os.path.isfile(path):
            raise RuntimeError(
                "Conserved intervals file %s not found. Make sure "
                "halTreeNIConservation has been run and that the paths are "
                "correctly specified" % path)

    def process(parent, child):
        cons = os.path.join(o.workDir, cons_name % child)
        pcons = os.path.join(o.workDir, cons_name % parent)
        check(cons)
        check(pcons)
        out_paths = {
            "mapped_aligned": os.path.join(o.workDir, child + "_pa.bed"),
            "parent_sliced": os.path.join(o.workDir, child + "_pslice.bed"),
            "mapped_genome": os.path.join(o.workDir, child + "_pm.bed"),
            "conservation": os.path.join(o.workDir, child + "_int.bed"),
            "aligned": os.path.join(o.workDir, child + "_al.bed"),
            "gain": os.path.join(o.workDir, child + "_gain.bed"),
            "loss": os.path.join(o.workDir, child + "_loss.bed"),
        }
        con, gain, loss, uncon = compare_conservation_over_branch(
            aln, child, cons, pcons, out_paths, device=o.device)
        gain_rate = float(gain) / (uncon + gain) if uncon + gain > 0 else 0.0
        loss_rate = float(loss) / (con + loss) if con + loss > 0 else 0.0
        bl = aln.get_branch_length(child)
        print("%s: cons %d  ucons %d  gain %d (%f) loss %d (%f) bl %f" % (
            child, con, uncon, gain, gain_rate, loss, loss_rate, bl))

    def recurse(node):
        for child in aln.tree.children(node):
            # the branch needs a conserved bed for the parent too, so skip
            # branches whose parent is the (bedless) alignment root
            if node != root_name:
                process(node, child)
            recurse(child)

    recurse(start)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
