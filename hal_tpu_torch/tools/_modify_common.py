"""Port copy of hal_tpu/tools/_modify_common.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

Shared helpers for the alignment-surgery tools (reference modify/)."""

from __future__ import annotations

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.storage import detect_format, save_alignment


def open_for_update(path):
    """Open fully materialized (in-place updates rewrite the file)."""
    aln = open_alignment(path)
    for n in aln.genome_names():
        g = aln.open_genome(n)
        # materialize mmap-backed arrays so the source can be overwritten
        import numpy as np

        for f in ("seq_start", "seq_top", "seq_bot", "top_start", "top_parent",
                  "top_parent_reversed", "top_bottom_parse", "top_paralogy",
                  "bot_start", "bot_top_parse", "bot_child", "bot_child_reversed", "dna"):
            setattr(g, f, np.array(getattr(g, f), copy=True))
    aln._loader = None
    return aln, detect_format(path)


def save_back(aln, path, fmt):
    save_alignment(aln, path, fmt=fmt)


def mark_ancestors_for_update(aln, node: str) -> None:
    """Flag all ancestors of `node` dirty (reference modify/markAncestors.cpp:
    metadata 'needsUpdate' = 'true' on every ancestor)."""
    parent = aln.tree.parent(node)
    while parent is not None:
        aln.open_genome(parent).metadata["needsUpdate"] = "true"
        parent = aln.tree.parent(parent)
