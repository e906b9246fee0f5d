"""Port copy of hal_tpu/tools/halTreeNIBackground.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

halTreeNIBackground — per-genome background-region BEDs for the
neutral-indel pipeline (reference
analysis/neutralIndel/halTreeNIBackground.py:25-38): either whole-genome
sequence BEDs or (with --ar) soft-masked/ancestral-repeat regions."""

from __future__ import annotations

import os
import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def run(argv=None):
    p = make_parser("halTreeNIBackground",
                    "Write background-selection BEDs for every genome")
    p.add_argument("halFile")
    p.add_argument("workDir")
    p.add_argument("--backgroundBedName", default="%%s_bg.bed")
    p.add_argument("--ar", action="store_true", default=False,
                   help="select only repeat-masked regions")
    p.add_argument("--arExtend", type=int, default=0)
    p.add_argument("--arExtendPct", type=float, default=0.0)
    p.add_argument("--root", default=None)
    add_storage_options(p)
    o = p.parse_args(argv)
    name = o.backgroundBedName.replace("%%", "%")
    if o.arExtend and o.arExtendPct:
        raise HalError("--arExtend and --arExtendPct are exclusive")
    ar = o.ar or bool(o.arExtend) or bool(o.arExtendPct)
    os.makedirs(o.workDir, exist_ok=True)

    aln = open_alignment(o.halFile)
    root = o.root or aln.root_name

    def write_bg(genome):
        dest = os.path.join(o.workDir, name % genome)
        if ar:
            from hal_tpu_torch.tools import halMaskExtract
            argv2 = [o.halFile, genome, "--maskFile", dest]
            if o.arExtend:
                argv2 += ["--extend", str(o.arExtend)]
            if o.arExtendPct:
                argv2 += ["--extendPct", str(o.arExtendPct)]
            halMaskExtract.run(argv2)
        else:
            g = aln.open_genome(genome)
            with open(dest, "w") as f:
                for si in range(g.num_sequences):
                    f.write("%s\t0\t%d\n" % (g.seq_names[si], g.seq_length(si)))

    def recurse(node):
        for child in aln.tree.children(node):
            write_bg(child)
            recurse(child)

    recurse(root)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
