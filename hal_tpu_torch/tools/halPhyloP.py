"""halPhyloP on the torch port — the arguments of hal_tpu.tools.halPhyloP
with --device naming the torch device ("cuda", the default, or "cpu") of
the whole scorer: the column engine
(hal_tpu_torch.ops.column_torch.DeviceColumnEngine) and the likelihood fit
(hal_tpu_torch.phylop_torch.DevicePhyloP: the CUDA fit kernel in float32
on the card, the float64 plain version on the CPU).  Scores are phyloP's
per-column likelihood-ratio test, written as a fixedStep wiggle.

    python -m hal_tpu_torch.tools.halPhyloP --device cuda aln.hal Genome_1 \\
        neutral.mod out.wig
"""

from __future__ import annotations

import sys

import torch

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import (HalError, add_storage_options, make_parser,
                                 tool_main)

WINDOW = 1 << 20


def run(argv=None):
    p = make_parser("halPhyloP",
                    "Make PhyloP wiggle of conservation scores for a genome")
    p.add_argument("halPath")
    p.add_argument("refGenome")
    p.add_argument("modFile", help="phyloFit neutral model file (.mod)")
    p.add_argument("wigFile", help="output wiggle (or stdout)")
    p.add_argument("--refSequence", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--dupType", choices=["all", "ambiguous"],
                   default="ambiguous")
    p.add_argument("--dupMask", choices=["soft", "hard"], default="soft")
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--mode", choices=["CONACC", "CON", "ACC", "NNEUT"],
                   default="CONACC")
    p.add_argument("--subtree", default="",
                   help="score lineage-specific rate changes on this node's "
                        "subtree (second scale parameter)")
    p.add_argument("--prec", type=int, default=3,
                   help="wiggle score decimal precision")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the column engine and the fit (cpu "
                        "runs the kernels' plain versions, the fit in "
                        "float64)")
    add_storage_options(p)
    o = p.parse_args(argv)

    if o.device == "cuda" and not torch.cuda.is_available():
        raise HalError("--device cuda: no CUDA device is available "
                       "(--device cpu runs the port on the CPU)")

    from hal_tpu_torch.phylop import NeutralModel, PhyloPScorer

    aln = open_alignment(o.halPath)
    mod = NeutralModel.from_mod_file(o.modFile)
    scorer = PhyloPScorer(aln, mod, mode=o.mode, dup_mask=o.dupMask,
                          dup_type=o.dupType, subtree=o.subtree or None,
                          device=o.device)
    g = aln.open_genome(o.refGenome)
    out = sys.stdout if o.wigFile in ("stdout", "-") else open(o.wigFile, "w")

    if o.refSequence:
        seqs = [g.sequence_index(o.refSequence)]
    else:
        seqs = range(g.num_sequences)
    fmt = "%%.%df" % o.prec
    for si in seqs:
        base = int(g.seq_start[si])
        seq_len = int(g.seq_start[si + 1]) - base
        start = o.start if o.refSequence else 0
        length = o.length if o.refSequence else 0
        length = length or (seq_len - start)
        # wig coordinates are 1-based (halPhyloP.cpp:196)
        out.write("fixedStep chrom=%s start=%d step=%d\n"
                  % (g.seq_names[si], start + 1, o.step))
        pos = base + start
        end = base + start + length
        while pos < end:
            hi = min(pos + WINDOW, end)
            scores = scorer.score_window(o.refGenome, pos, hi)
            out.write("\n".join(fmt % s for s in scores[::o.step]))
            out.write("\n")
            pos = hi
    if out is not sys.stdout:
        out.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
