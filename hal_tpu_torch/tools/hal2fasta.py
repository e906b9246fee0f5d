"""Port copy of hal_tpu/tools/hal2fasta.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

hal2fasta — DNA export (reference fasta/hal2fasta.cpp:28-46).

Vectorized: whole-sequence unpack + bulk line-wrapping via numpy reshape
instead of the reference's 1 KiB buffered per-base loop.
"""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, out_stream, tool_main


def _wrap(seq: np.ndarray, width: int) -> bytes:
    """Insert newlines every `width` bases, bulk (no per-line Python loop)."""
    n = len(seq)
    if n == 0:
        return b"\n"
    n_full = n // width
    body = b""
    if n_full:
        block = np.empty((n_full, width + 1), np.uint8)
        block[:, :-1] = seq[: n_full * width].reshape(n_full, width)
        block[:, -1] = ord("\n")
        body = block.tobytes()
    tail = seq[n_full * width :]
    if tail.size:
        body += tail.tobytes() + b"\n"
    return body


def write_fasta(os, g, sequence=None, start=0, length=0, line_width=80,
                full_names=False, upper=False):
    seq_ids = range(g.num_sequences)
    if sequence is not None:
        seq_ids = [g.sequence_index(sequence)]
    for si in seq_ids:
        seq_len = g.seq_length(si)
        s = int(start) if sequence is not None else 0
        ln = int(length) if (sequence is not None and length) else seq_len - s
        if sequence is None and (start or length):
            # start/length relative to genome when no sequence given:
            # clip this sequence against [start, start+length)
            gs, ge = int(g.seq_start[si]), int(g.seq_start[si + 1])
            qs = int(start)
            qe = qs + int(length) if length else ge
            cs, ce = max(gs, qs), min(ge, qe)
            if cs >= ce:
                continue
            s, ln = cs - gs, ce - cs
        if s >= seq_len:
            raise HalError("start position %d out of range for sequence %s" % (s, g.seq_names[si]))
        ln = min(ln, seq_len - s)
        name = ("%s.%s" % (g.name, g.seq_names[si])) if full_names else g.seq_names[si]
        os.write(">%s\n" % name)
        bases = g.get_dna(int(g.seq_start[si]) + s, ln)
        if upper:
            bases = np.where((bases >= 97) & (bases <= 122), bases - 32, bases).astype(np.uint8)
        os.buffer.write(_wrap(bases, line_width)) if hasattr(os, "buffer") else os.write(_wrap(bases, line_width).decode())


def run(argv=None):
    p = make_parser("hal2fasta", "Export sequences of genome or subtree from hal to fasta")
    p.add_argument("inHalPath")
    p.add_argument("genome")
    p.add_argument("--outFaPath", default="stdout")
    p.add_argument("--ucscSequenceNames", action="store_true")
    p.add_argument("--lineWidth", type=int, default=80)
    p.add_argument("--sequence", default=None)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--subtree", action="store_true")
    p.add_argument("--upper", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    if o.subtree and (o.start or o.length or o.sequence):
        raise HalError("--start/--length/--sequence cannot be used with --subtree")

    aln = open_alignment(o.inHalPath)
    if aln.num_genomes == 0:
        raise HalError("input hal alignmenet is empty")
    os = out_stream(o.outFaPath)
    queue = [o.genome]
    while queue:
        name = queue.pop(0)
        g = aln.open_genome(name)
        write_fasta(os, g, sequence=o.sequence, start=o.start, length=o.length,
                    line_width=o.lineWidth, full_names=o.ucscSequenceNames, upper=o.upper)
        if o.subtree:
            queue.extend(aln.get_child_names(name))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
