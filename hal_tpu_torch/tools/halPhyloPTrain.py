"""Port copy of hal_tpu/tools/halPhyloPTrain.py (numpy only; the same code,
imports pointing at hal_tpu_torch), whose hal4dExtract and hal2maf jobs run
the port's hal_tpu_torch.tools modules and take its new --device option
(default cuda), which both port tools need off a card.

halPhyloPTrain — train a phast neutral model from 4d sites
(reference phyloP/halPhyloPTrain.py: hal4dExtract -> hal2maf -> msa_view ->
phyloFit pipeline).  Requires phast binaries on PATH."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

from hal_tpu_torch.parallel.mp import get_hal_tree
from hal_tpu_torch.tools import HalError, make_parser, tool_main


def run(argv=None):
    p = make_parser("halPhyloPTrain", "Train a neutral phyloP model on 4d sites")
    p.add_argument("hal")
    p.add_argument("refGenome")
    p.add_argument("bedFile", help="BED12 genes on the reference genome")
    p.add_argument("outMod")
    p.add_argument("--numProc", type=int, default=1)
    p.add_argument("--noAncestors", action="store_true")
    p.add_argument("--substMod", default="SSREV")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="--device of the hal4dExtract and hal2maf jobs")
    o = p.parse_args(argv)
    for binary in ("phyloFit", "msa_view"):
        if shutil.which(binary) is None:
            raise HalError(
                "halPhyloPTrain requires the phast package (%s not found on "
                "PATH; reference gates this behind ENABLE_PHYLOP)" % binary)
    tmp = tempfile.mkdtemp(prefix="halPhyloPTrain_")
    bed4d = os.path.join(tmp, "4d.bed")
    maf4d = os.path.join(tmp, "4d.maf")
    subprocess.run([sys.executable, "-m", "hal_tpu_torch.tools.hal4dExtract",
                    o.hal, o.refGenome, o.bedFile, bed4d, "--device", o.device],
                   check=True)
    subprocess.run([sys.executable, "-m", "hal_tpu_torch.tools.hal2maf", o.hal, maf4d,
                    "--refGenome", o.refGenome, "--refTargets", bed4d,
                    "--noDupes", "--device", o.device]
                   + (["--noAncestors"] if o.noAncestors else []),
                   check=True)
    tree = get_hal_tree(o.hal)
    proc = subprocess.run(["phyloFit", "--tree", tree, "--subst-mod", o.substMod,
                           "--msa-format", "MAF", "--out-root",
                           os.path.splitext(o.outMod)[0], maf4d],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise HalError("phyloFit failed: " + proc.stderr)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
