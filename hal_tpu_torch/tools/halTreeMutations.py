"""Port copy of hal_tpu/tools/halTreeMutations.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halTreeMutations — run branch-mutation annotation for every branch of the
tree (reference mutations/impl/halTreeMutations.py:23-51), producing one
sorted BED per genome.

The reference shells out `halBranchMutations ... | sortBed`; here the branch
tool runs in-process and the sort is native (by sequence, start, end) with
the header lines kept on top.
"""

from __future__ import annotations

import os
import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main


def _sort_bed_file(path: str) -> None:
    with open(path) as f:
        lines = f.readlines()
    head = [l for l in lines if l.startswith("#")]
    body = [l for l in lines if not l.startswith("#") and l.strip()]
    body.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1]),
                             int(l.split("\t")[2])))
    with open(path, "w") as f:
        f.writelines(head + body)


def run_branch(hal_path: str, genome: str, out_dir: str, bed_name: str,
               max_gap: int, do_snps: bool, do_parent_deletions: bool,
               no_sort: bool) -> str:
    from hal_tpu_torch.tools import halBranchMutations as hbm

    dest = os.path.join(out_dir, bed_name % genome)
    argv = [hal_path, genome, "--maxGap", str(max_gap),
            "--refFile", dest, "--delBreakFile", dest]
    if do_snps:
        argv += ["--snpFile", dest]
    if do_parent_deletions:
        argv += ["--parentFile", os.path.join(out_dir, "%s_pd.bed" % genome)]
    hbm.run(argv)
    if not no_sort:
        _sort_bed_file(dest)
    return dest


def run(argv=None):
    p = make_parser("halTreeMutations",
                    "Write mutation BEDs for every branch of the tree")
    p.add_argument("halFile")
    p.add_argument("outDir")
    p.add_argument("--bedName", default="%%s.bed",
                   help="name template for output beds (%%s = genome)")
    p.add_argument("--root", default=None)
    p.add_argument("--doSnps", action="store_true", default=False)
    p.add_argument("--doParentDeletions", action="store_true", default=False)
    p.add_argument("--maxGap", type=int, default=10)
    p.add_argument("--noSort", action="store_true", default=False)
    add_storage_options(p)
    o = p.parse_args(argv)
    bed_name = o.bedName.replace("%%", "%")
    os.makedirs(o.outDir, exist_ok=True)

    aln = open_alignment(o.halFile)
    root = o.root or aln.root_name

    def recurse(node):
        for child in aln.tree.children(node):
            run_branch(o.halFile, child, o.outDir, bed_name, o.maxGap,
                       o.doSnps, o.doParentDeletions, o.noSort)
            recurse(child)

    recurse(root)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
