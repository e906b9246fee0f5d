"""Port copy of hal_tpu/tools/halTreePhyloP.py (the same code, imports
pointing at hal_tpu_torch), whose per-genome commands run the port's
hal_tpu_torch.tools.halPhyloP and pass --device (default cuda) on.  As in
the original, --subtree is parsed and not passed on.

halTreePhyloP — run halPhyloP for every leaf genome
(reference phyloP/halTreePhyloP.py)."""

from __future__ import annotations

import os
import sys

from hal_tpu_torch.parallel.mp import get_hal_genomes, get_hal_child_names, run_parallel_shell_commands
from hal_tpu_torch.tools import make_parser, tool_main


def run(argv=None):
    p = make_parser("halTreePhyloP", "Compute phyloP wiggles for all leaf genomes")
    p.add_argument("hal")
    p.add_argument("mod", help="phast model file")
    p.add_argument("outDir")
    p.add_argument("--numProc", type=int, default=1)
    p.add_argument("--subtree", default="")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="--device of every halPhyloP run")
    o = p.parse_args(argv)
    os.makedirs(o.outDir, exist_ok=True)
    leaves = [g for g in get_hal_genomes(o.hal)
              if not get_hal_child_names(o.hal, g)]
    cmds = []
    for leaf in leaves:
        wig = os.path.join(o.outDir, "%s_phyloP.wig" % leaf)
        cmds.append("%s -m hal_tpu_torch.tools.halPhyloP %s %s %s %s --device %s"
                    % (sys.executable, o.hal, leaf, o.mod, wig, o.device))
    run_parallel_shell_commands(cmds, o.numProc)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
