"""Port copy of hal_tpu/tools/ancestorsMLMP.py (numpy only; the same code,
imports pointing at hal_tpu_torch), whose commands run the port's
hal_tpu_torch.tools.ancestorsML and pass --device (default cuda) on, as
tools/halPhyloPMP.py passes it to halPhyloP.

ancestorsMLMP — run ancestorsML over all ancestral genomes
(reference modify/ancestorsMLMP.py)."""

from __future__ import annotations

import sys

from hal_tpu_torch.parallel.mp import get_hal_child_names, get_hal_genomes, run_parallel_shell_commands
from hal_tpu_torch.tools import make_parser, tool_main


def run(argv=None):
    p = make_parser("ancestorsMLMP", "Re-estimate all ancestral genomes (bottom-up)")
    p.add_argument("halFile")
    p.add_argument("--model", default="")
    p.add_argument("--numProc", type=int, default=1,
                   help="kept for CLI parity; updates are applied serially "
                        "because each rewrites the shared file")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="--device of every ancestorsML run")
    o = p.parse_args(argv)
    ancestors = [g for g in get_hal_genomes(o.halFile)
                 if get_hal_child_names(o.halFile, g)]
    # children before parents so re-estimates propagate up
    for g in reversed(ancestors):
        cmd = "%s -m hal_tpu_torch.tools.ancestorsML %s %s --device %s" % (
            sys.executable, o.halFile, g, o.device)
        if o.model:
            cmd += " --model %s" % o.model
        run_parallel_shell_commands([cmd], 1)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
