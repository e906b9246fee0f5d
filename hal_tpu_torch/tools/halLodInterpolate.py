"""Port copy of hal_tpu/tools/halLodInterpolate.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

halLodInterpolate — generate a geometric series of LODs + lod.txt manifest
(reference lod/halLodInterpolate.py; manifest format documented in
blockViz/inc/halBlockViz.h:108-118: lines of `minQueryLength halPath`)."""

from __future__ import annotations

import os
import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.lod import extract_lod
from hal_tpu_torch.storage import save_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def max_genome_length(aln):
    return max(aln.open_genome(n).length for n in aln.genome_names())


def get_steps(aln, max_block: int, scale_factor: float, min_lod0: int):
    """Query-length thresholds (reference getSteps, halLodInterpolate.py:97-133)."""
    max_len = max_genome_length(aln)
    steps = [0]
    step = max(max_block * 2, min_lod0, 1)
    while step < max_len * 2:
        steps.append(int(step))
        step *= scale_factor
    return steps


def run(argv=None):
    p = make_parser("halLodInterpolate", "Generate a series of LOD levels and a lod.txt manifest")
    p.add_argument("hal", help="input hal")
    p.add_argument("outLodFile", help="output manifest (lod.txt)")
    p.add_argument("--outHalDir", default=None,
                   help="directory for lod hal files (default: beside manifest)")
    p.add_argument("--maxBlock", type=int, default=223)
    p.add_argument("--scale", type=float, default=2.5)
    p.add_argument("--minLod0", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip LOD levels whose output already exists")
    p.add_argument("--keepSequences", action="store_true")
    p.add_argument("--onlyOrthologs", action="store_true",
                   help="drop paralogous copies instead of retaining rings")
    p.add_argument("--numProc", type=int, default=1)
    p.add_argument("--absPath", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)

    aln = open_alignment(o.hal)
    out_dir = o.outHalDir or os.path.dirname(os.path.abspath(o.outLodFile)) or "."
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(o.hal))[0]

    steps = get_steps(aln, o.maxBlock, o.scale, o.minLod0)
    lines = []
    hal_abs = os.path.abspath(o.hal)
    lines.append("0 %s" % (hal_abs if o.absPath else o.hal))
    for i, step in enumerate(steps[1:], 1):
        scale = max(step // o.maxBlock, 1)
        if scale <= 1:
            continue
        out_path = os.path.join(out_dir, "%s_lod%d.halz" % (base, step))
        if not (o.resume and os.path.exists(out_path)):
            lod = extract_lod(aln, scale=scale, keep_sequences=o.keepSequences,
                              only_orthologs=o.onlyOrthologs)
            save_alignment(lod, out_path, fmt="halz")
        lines.append("%d %s" % (step, os.path.abspath(out_path) if o.absPath else out_path))

    with open(o.outLodFile, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
