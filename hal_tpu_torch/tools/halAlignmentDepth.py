"""halAlignmentDepth on the torch port — the arguments of
hal_tpu.tools.halAlignmentDepth, with --device naming the torch device of
the depth engine (hal_tpu_torch.ops.depth.DepthEngine), which always serves
the tool.  Windows of 2^26 columns, as the original's --device path; the
output is the same wiggle bytes.

    python -m hal_tpu_torch.tools.halAlignmentDepth --device cuda \\
        aln.hal refGenome --outWiggle out.wig
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hal_tpu_torch.ops.column import compute_scope
from hal_tpu_torch.ops.depth import depth_counts_device, write_wiggle
from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import (HalError, add_storage_options, make_parser,
                                 out_stream, tool_main)

# the device engine drains RLE runs (bytes ~ runs, not columns), so large
# windows amortize the per-window host sizing; the dense counts vector
# lives on the device (4 B/column)
WINDOW = 1 << 26


def run(argv=None):
    p = make_parser("halAlignmentDepth", "Make alignment depth wiggle plot for a genome")
    p.add_argument("halPath")
    p.add_argument("refGenome")
    p.add_argument("--outWiggle", default="stdout")
    p.add_argument("--refSequence", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--rootGenome", default="")
    p.add_argument("--targetGenomes", default="")
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--countDupes", action="store_true")
    p.add_argument("--noAncestors", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the depth engine (cpu runs the "
                        "kernels' plain versions)")
    add_storage_options(p)
    o = p.parse_args(argv)

    if o.device == "cuda" and not torch.cuda.is_available():
        raise HalError("--device cuda: no CUDA device is available "
                       "(--device cpu runs the port on the CPU)")
    if o.rootGenome and o.targetGenomes:
        raise HalError("--rootGenome and --targetGenomes options are  mutually exclusive")

    aln = open_alignment(o.halPath)
    if aln.num_genomes == 0:
        raise HalError("input hal alignmenet is empty")
    ref = o.refGenome
    if ref not in aln.tree:
        raise HalError("Reference genome, %s, not found in alignment" % ref)
    g = aln.open_genome(ref)
    if aln.tree.children(ref) and o.noAncestors:
        raise HalError("--noAncestors cannot be used when reference genome (%s) is ancetral" % ref)

    targets = [t for t in o.targetGenomes.split(",") if t] or None
    root = o.rootGenome or None
    scope, scope_root = compute_scope(aln, ref, targets, root)

    out = out_stream(o.outWiggle)

    def emit(si, s, ln):
        base = int(g.seq_start[si])
        counts_parts = []
        pos = base + s
        end = base + s + ln
        while pos < end:
            w = min(pos + WINDOW, end)
            counts_parts.append(depth_counts_device(
                aln, ref, pos, w, scope, scope_root, o.countDupes,
                o.noAncestors, device=o.device)[0])
            pos = w
        counts = np.concatenate(counts_parts) if counts_parts else np.zeros(0, np.int64)
        write_wiggle(out, g.seq_names[si], s, counts, o.step)

    if o.refSequence:
        si = g.sequence_index(o.refSequence)
        ln = o.length or (g.seq_length(si) - o.start)
        if o.start + ln > g.seq_length(si):
            raise HalError("Specified range is out of range for sequence %s" % o.refSequence)
        emit(si, o.start, ln)
    else:
        # genome-range scoping clipped per sequence (printGenome,
        # halAlignmentDepth.cpp:319-343)
        gstart = o.start
        glen = o.length or (g.length - gstart)
        gend = gstart + glen
        for si in range(g.num_sequences):
            lo = int(g.seq_start[si])
            hi = int(g.seq_start[si + 1])
            s = max(lo, gstart)
            e = min(hi, gend)
            if s < e:
                emit(si, s - lo, e - s)
    if out is not sys.stdout:
        out.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
