"""Port copy of hal_tpu/tools/halLodExtract.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halLodExtract — generate one level-of-detail alignment
(reference lod/impl/halLodExtractMain.cpp)."""

from __future__ import annotations

import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.lod import extract_lod
from hal_tpu_torch.storage import save_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, save_kwargs, tool_main


def run(argv=None):
    p = make_parser("halLodExtract", "Generate a level-of-detail interpolation of a hal file")
    p.add_argument("inHalPath")
    p.add_argument("outHalPath")
    p.add_argument("scale", type=float, help="scale factor for interpolation")
    p.add_argument("--root", default="")
    p.add_argument("--outTree", default="")
    p.add_argument("--probeFrac", type=float, default=0.035)
    p.add_argument("--minSeqFrac", type=float, default=0.0)
    p.add_argument("--keepSequences", action="store_true")
    p.add_argument("--allSequences", action="store_true")
    p.add_argument("--onlyOrthologs", action="store_true",
                   help="drop paralogous copies instead of retaining rings")
    add_storage_options(p, write=True)
    o = p.parse_args(argv)
    aln = open_alignment(o.inHalPath)
    lod = extract_lod(aln, scale=max(int(o.scale), 1), root=o.root or None,
                      keep_sequences=o.keepSequences,
                      only_orthologs=o.onlyOrthologs)
    save_alignment(lod, o.outHalPath, **save_kwargs(o))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
