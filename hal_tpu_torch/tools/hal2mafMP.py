"""Port copy of hal_tpu/tools/hal2mafMP.py (numpy only; the same code,
imports pointing at hal_tpu_torch), whose slices run the port's hal2maf,
with one declared divergence: --device {cuda,cpu} (default cuda) is passed
on to every hal2maf slice.  Each slice runs hal2maf --unique, a flag
outside the device column engine's set, so on either device the slices
take the native host engine, with hal2maf's notice.

hal2mafMP — process-parallel hal2maf (reference maf/hal2mafMP.py).

Slices the reference genome into windows (or splits by sequence / BED
targets), runs one hal2maf --unique per slice in a process pool, and
concatenates the results.  Note: on a single TPU host the sharded device
path is usually faster; this driver exists for workflow parity."""

from __future__ import annotations

import os
import sys
import tempfile

from hal_tpu_torch.parallel.mp import (get_hal_genome_length, get_hal_root_name,
                                 get_hal_sequences, run_parallel_shell_commands)
from hal_tpu_torch.tools import HalError, make_parser, tool_main

PASS_THROUGH = ["refSequence", "rootGenome", "targetGenomes", "maxRefGap",
                "maxBlockLen"]
PASS_FLAGS = ["noDupes", "noAncestors", "onlySequenceNames", "onlyOrthologs",
              "keepEmptyRefBlocks"]


def compute_slices(start: int, length: int, slice_size):
    """reference computeSlices (maf/hal2mafMP.py:63-80): (start, length,
    slice index or None when unsliced)."""
    if length <= 0:
        return
    if slice_size is None or slice_size >= length:
        yield start, length, None
        return
    n = length // slice_size
    for i in range(n):
        yield start + i * slice_size, slice_size, i
    r = length % slice_size
    if r > 0:
        yield start + n * slice_size, r, n


def run(argv=None):
    p = make_parser("hal2mafMP", "Multi-process wrapper for hal2maf")
    p.add_argument("halFile")
    p.add_argument("mafFile")
    p.add_argument("--numProc", type=int, default=1)
    p.add_argument("--sliceSize", type=int, default=None)
    p.add_argument("--splitBySequence", action="store_true")
    p.add_argument("--refGenome", default="")
    p.add_argument("--refTargets", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    for opt in PASS_THROUGH:
        p.add_argument("--" + opt, default=None)
    for flag in PASS_FLAGS:
        p.add_argument("--" + flag, action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="--device of every hal2maf slice")
    o = p.parse_args(argv)

    ref = o.refGenome or get_hal_root_name(o.halFile)
    extra = []
    for opt in PASS_THROUGH:
        v = getattr(o, opt)
        if v is not None:
            extra.append("--%s %s" % (opt, v))
    for flag in PASS_FLAGS:
        if getattr(o, flag):
            extra.append("--" + flag)
    extra = " ".join(extra)

    tmpdir = tempfile.mkdtemp(prefix="hal2mafMP_")
    maf_dir = os.path.dirname(o.mafFile) or "."
    maf_base = os.path.splitext(os.path.basename(o.mafFile))[0]
    maf_ext = ".maf"

    cmds = []
    # groups: final output path -> ordered slice part paths (first keeps the
    # header; later slices append non-# lines — reference concatenateSlices,
    # maf/hal2mafMP.py:81-100)
    groups: dict[str, list[str]] = {}

    def add(final_path, part_idx, args):
        if part_idx is None:
            part = final_path
        else:
            part = os.path.join(tmpdir, "%s_%05d_%s.maf"
                                % (maf_base, len(cmds), os.path.basename(final_path)))
        groups.setdefault(final_path, []).append(part)
        cmds.append("%s -m hal_tpu_torch.tools.hal2maf %s %s --refGenome %s --unique "
                    "--device %s %s"
                    % (sys.executable, o.halFile, part, ref, o.device, args))

    def seq_lengths():
        from hal_tpu_torch.parallel.mp import _hal_stats

        out = _hal_stats(o.halFile, "--chromSizes", ref).strip()
        return [(l.split("\t")[0], int(l.split("\t")[1]))
                for l in out.splitlines() if l.strip()]

    if o.refTargets:
        # split BED lines across processes (hal2mafMP.py:102-124)
        lines = [l for l in open(o.refTargets) if l.strip() and not l.startswith("#")]
        chunk = max(-(-len(lines) // max(o.numProc, 1)), 1)
        n = 0
        for i in range(0, len(lines), chunk):
            bed = os.path.join(tmpdir, "targets_%05d.bed" % i)
            open(bed, "w").writelines(lines[i:i + chunk])
            add(o.mafFile, n if len(lines) > chunk else None,
                "%s --refTargets %s" % (extra, bed))
            n += 1
    elif o.splitBySequence or o.refSequence:
        # per-sequence coordinates; --splitBySequence writes one output MAF
        # per sequence named <mafFile>_<sequence>.maf (hal2mafMP.py:127-146)
        for seq, seq_len in seq_lengths():
            if o.refSequence and seq != o.refSequence:
                continue
            final = (os.path.join(maf_dir, "%s_%s%s" % (maf_base, seq, maf_ext))
                     if o.splitBySequence else o.mafFile)
            start = o.start or 0
            length = o.length or seq_len
            for s, ln, idx in compute_slices(start, min(length, seq_len - start),
                                             o.sliceSize):
                add(final, idx, "%s --refSequence %s --start %d --length %d"
                    % (extra, seq, s, ln))
    else:
        # genome coordinates (hal2mafMP.py:148-172)
        stats = seq_lengths()
        slice_size = o.sliceSize
        if slice_size is None and o.numProc > 1:
            import math
            import statistics

            ref_len = o.length or int(statistics.median([ln for _, ln in stats]))
            slice_size = math.ceil(ref_len / o.numProc)
        for seq, seq_len in stats:
            start = o.start or 0
            for s, ln, idx in compute_slices(start,
                                             min(o.length or seq_len,
                                                 seq_len - start), slice_size):
                add(o.mafFile, idx, "%s --refSequence %s --start %d --length %d"
                    % (extra, seq, s, ln))

    run_parallel_shell_commands(cmds, o.numProc)

    for final, parts in groups.items():
        if len(parts) == 1 and parts[0] == final:
            continue
        first = True
        for part in parts:
            if not os.path.exists(part):
                continue
            if first:
                os.replace(part, final)
                first = False
                continue
            with open(final, "a") as tgt, open(part) as src:
                for line in src:
                    if not line.startswith("#"):
                        tgt.write(line)
            os.unlink(part)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
