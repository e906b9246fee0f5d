"""Port copy of hal_tpu/tools/mafMutations.py (numpy only; the same code,
imports pointing at hal_tpu_torch, and the docstring names the reference's
source without a local path).

mafMutations — count substitutions in a MAF, the reference's quick
benchmark-baseline tool (reference benchmarks/mafMutations.cpp).

Semantics preserved exactly: '-'-strand rows get the gap-preserving
reverse complement (gap columns stay in place, the non-gap bases reverse
and complement around them — mafMutations.cpp:95-122), then every row is
compared to the block's first row; positions where both are ungapped and
differ case-insensitively count one mutation.  Implementation is
vectorized numpy instead of the per-character C++ loop."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.tools import make_parser, tool_main

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"acgtACGT", b"tgcaTGCA"):
    _COMP[_a] = _b
_UP = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    _UP[_c] = _c - 32
_GAP = ord("-")


def _rc_keep_gaps(row: np.ndarray) -> np.ndarray:
    out = row.copy()
    m = row != _GAP
    out[m] = _COMP[row[m][::-1]]
    return out


def count_block(rows: list[np.ndarray]) -> int:
    if len(rows) < 2:
        return 0
    a = _UP[rows[0]]
    count = 0
    for r in rows[1:]:
        if len(r) != len(a):
            raise ValueError("block parse error")
        b = _UP[r]
        count += int(((a != _GAP) & (b != _GAP) & (a != b)).sum())
    return count


def count_maf(stream) -> int:
    total = 0
    rows: list[np.ndarray] = []
    for line in stream:
        if line.startswith("a"):
            total += count_block(rows)
            rows = []
        elif line.startswith("s"):
            parts = line.split()
            text = np.frombuffer(parts[6].encode(), np.uint8)
            if parts[4] == "-":
                text = _rc_keep_gaps(text)
            rows.append(text)
    total += count_block(rows)
    return total


def run(argv=None):
    p = make_parser("mafMutations", "Count substitutions in a maf file")
    p.add_argument("mafFile")
    o = p.parse_args(argv)
    with (sys.stdin if o.mafFile in ("-", "stdin") else open(o.mafFile)) as f:
        print("count = %d" % count_maf(f))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
