"""Port copy of hal_tpu/tools/halPhyloPMP.py (the same code, imports pointing
at hal_tpu_torch), whose per-sequence commands run the port's
hal_tpu_torch.tools.halPhyloP and pass --device (default cuda) on.

halPhyloPMP — process-parallel halPhyloP (reference phyloP/halPhyloPMP.py)."""

from __future__ import annotations

import os
import sys
import tempfile

from hal_tpu_torch.parallel.mp import get_hal_genome_length, get_hal_sequences, run_parallel_shell_commands
from hal_tpu_torch.tools import make_parser, tool_main


def run(argv=None):
    p = make_parser("halPhyloPMP", "Multi-process wrapper for halPhyloP")
    p.add_argument("halFile")
    p.add_argument("refGenome")
    p.add_argument("modFile")
    p.add_argument("wigFile")
    p.add_argument("--numProc", type=int, default=1)
    p.add_argument("--sliceSize", type=int, default=None)
    p.add_argument("--refSequence", default="")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="--device of every halPhyloP run")
    o = p.parse_args(argv)
    tmpdir = tempfile.mkdtemp(prefix="halPhyloPMP_")
    seqs = [o.refSequence] if o.refSequence else get_hal_sequences(o.halFile, o.refGenome)
    cmds, parts = [], []
    for i, seq in enumerate(seqs):
        part = os.path.join(tmpdir, "part_%05d.wig" % i)
        parts.append(part)
        cmds.append("%s -m hal_tpu_torch.tools.halPhyloP %s %s %s %s --refSequence %s "
                    "--device %s"
                    % (sys.executable, o.halFile, o.refGenome, o.modFile, part, seq,
                       o.device))
    run_parallel_shell_commands(cmds, o.numProc)
    out = sys.stdout if o.wigFile in ("stdout", "-") else open(o.wigFile, "w")
    for part in parts:
        if os.path.exists(part):
            out.write(open(part).read())
            os.unlink(part)
    if out is not sys.stdout:
        out.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
