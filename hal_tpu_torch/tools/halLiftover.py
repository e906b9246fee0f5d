"""halLiftover on the torch port — the arguments of hal_tpu.tools.halLiftover
plus --device.  The BED lines are mapped --batchSize at a time (default
16384; 0 = the whole input in one call) by the torch segment mapper on
--device, so a default run maps on the card.  Output bytes equal the
original's per-line host mapping.

Every flag of the original is served by the batched mapper, with one
exception: a --coalescenceLimit genome that is not an ancestor of the
source and target's MRCA, which the batched path tables cannot express (the
per-line mapper then maps without paralogies under --noDupes, and fails
otherwise, as the original does).  That run prints one stderr line naming
--coalescenceLimit and maps per line on the host.

    python -m hal_tpu_torch.tools.halLiftover --device cuda \\
        aln.hal srcGenome in.bed tgtGenome out.bed
"""

from __future__ import annotations

import sys

import torch

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import (HalError, add_storage_options, make_parser,
                                 tool_main)
from hal_tpu_torch.ops.liftover import Liftover


def _is_ancestor_of_mrca(tree, limit: str, src: str, tgt: str) -> bool:
    """True where limit is the MRCA of src and tgt or above it: the
    coalescence limits the batched path tables (PathData.build) take."""
    node = tree.lca(src, tgt)
    while node is not None and node != limit:
        node = tree.parent(node)
    return node is not None


def run(argv=None):
    p = make_parser("halLiftover", "Map BED or PSL genome interval coordinates between two genomes")
    p.add_argument("halFile")
    p.add_argument("srcGenome")
    p.add_argument("srcBed", help="input bed path, or stdin")
    p.add_argument("tgtGenome")
    p.add_argument("tgtBed", help="output bed path, or stdout")
    p.add_argument("--noDupes", action="store_true",
                   help="do not map between duplications in graph")
    p.add_argument("--append", action="store_true", help="append results to tgtBed")
    p.add_argument("--coalescenceLimit", default="",
                   help="genome at or above the MRCA at which to stop looking for homologies")
    p.add_argument("--outPSL", action="store_true")
    p.add_argument("--outPSLWithName", action="store_true")
    p.add_argument("--bedType", type=int, default=0)
    p.add_argument("--batchSize", type=int, default=16384,
                   help="map this many BED lines per call of the torch "
                        "segment mapper on --device; 0 = the whole input in "
                        "one call")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the batched mapper (cpu runs the "
                        "kernels' plain versions)")
    add_storage_options(p)
    o = p.parse_args(argv)

    if o.device == "cuda" and not torch.cuda.is_available():
        raise HalError("--device cuda: no CUDA device is available "
                       "(--device cpu runs the port on the CPU)")
    if o.bedType and not 3 <= o.bedType <= 12:
        raise HalError("--bedType must be between 3 and 12")
    out_psl = o.outPSL or o.outPSLWithName

    aln = open_alignment(o.halFile)
    if o.srcGenome not in aln.tree or o.tgtGenome not in aln.tree:
        raise HalError("source or target genome not found in alignment")
    coalescence = o.coalescenceLimit or None
    if coalescence and coalescence not in aln.tree:
        raise HalError("coalescence limit genome %s not found" % coalescence)

    lift = Liftover(aln, o.srcGenome, o.tgtGenome,
                    traverse_dupes=not o.noDupes, out_psl=out_psl,
                    psl_with_name=o.outPSLWithName,
                    coalescence_limit=coalescence, device=o.device)

    in_stream = sys.stdin if o.srcBed in ("stdin", "-") else open(o.srcBed)
    if o.tgtBed in ("stdout", "-"):
        out_stream = sys.stdout
    else:
        out_stream = open(o.tgtBed, "a" if o.append else "w")
    if coalescence and not _is_ancestor_of_mrca(aln.tree, coalescence,
                                                o.srcGenome, o.tgtGenome):
        sys.stderr.write("halLiftover: --coalescenceLimit %s is not an "
                         "ancestor of the MRCA; mapping per line on the "
                         "host\n" % coalescence)
        lift.convert(in_stream, out_stream, o.bedType)
    else:
        lift.convert_batched(in_stream, out_stream, o.bedType,
                             batch_size=o.batchSize)
    if out_stream is not sys.stdout:
        out_stream.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
