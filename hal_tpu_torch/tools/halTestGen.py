"""Port copy of hal_tpu/tools/halTestGen.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

halTestGen — write a small hand-specified test alignment
(reference randgen/halTestGen.cpp): the 3-genome fixture with an
inversion, a duplication ring, an insertion and deletions."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.genome import GenomeArrays, SequenceInfo
from hal_tpu_torch.storage import save_alignment
from hal_tpu_torch.tools import add_storage_options, make_parser, save_kwargs, tool_main


def build_test_alignment() -> Alignment:
    aln = Alignment()
    aln.add_root_genome("Anc", [SequenceInfo("Anc_seq", 30, 0, 6)])
    aln.tree.add_child("Anc", "A", 0.1)
    aln.tree.add_child("Anc", "B", 0.2)
    anc = aln.open_genome("Anc")
    anc.bot_start[:-1] = np.arange(6) * 5
    anc.bot_child = np.full((6, 2), -1, np.int64)
    anc.bot_child_reversed = np.zeros((6, 2), np.uint8)

    a = GenomeArrays.create("A", [SequenceInfo("A_seq", 25, 5, 0)])
    a.top_start[:-1] = np.arange(5) * 5
    a.top_parent = np.array([0, 1, 2, -1, 4], np.int64)
    a.top_parent_reversed = np.array([0, 1, 0, 0, 0], np.uint8)
    aln.set_genome(a)

    b = GenomeArrays.create("B", [SequenceInfo("B_seq", 25, 5, 0)])
    b.top_start[:-1] = np.arange(5) * 5
    b.top_parent = np.array([0, 1, 2, 2, 5], np.int64)
    b.top_parent_reversed = np.array([0, 0, 0, 0, 1], np.uint8)
    b.top_paralogy = np.array([-1, -1, 3, 2, -1], np.int64)
    aln.set_genome(b)

    anc.bot_child[:, 0] = [0, 1, 2, -1, 4, -1]
    anc.bot_child_reversed[:, 0] = [0, 1, 0, 0, 0, 0]
    anc.bot_child[:, 1] = [0, 1, 3, -1, -1, 4]
    anc.bot_child_reversed[:, 1] = [0, 0, 0, 0, 0, 1]

    rng = np.random.default_rng(0)
    DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
    anc.set_dna(0, DNA[rng.integers(0, 4, 30)])
    for g in (a, b):
        out = np.empty(25, np.uint8)
        for i in range(5):
            par = g.top_parent[i]
            if par == -1:
                out[i * 5:(i + 1) * 5] = DNA[rng.integers(0, 4, 5)]
            else:
                out[i * 5:(i + 1) * 5] = anc.get_dna(int(par) * 5, 5,
                                                     reversed_=bool(g.top_parent_reversed[i]))
        g.set_dna(0, out)
    return aln


def run(argv=None):
    p = make_parser("halTestGen", "Generate a small hand-specified test alignment")
    p.add_argument("halFile")
    add_storage_options(p, write=True)
    o = p.parse_args(argv)
    save_alignment(build_test_alignment(), o.halFile, **save_kwargs(o))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
