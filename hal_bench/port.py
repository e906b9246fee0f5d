"""The port's view of the benchmark's inputs: the generator's arrays handed
to hal_tpu_torch's public in-memory constructors, not copied."""

from __future__ import annotations

ARRAY_FIELDS = ("seq_start", "seq_top", "seq_bot", "top_start", "top_parent",
                "top_parent_reversed", "top_bottom_parse", "top_paralogy",
                "bot_start", "bot_top_parse", "bot_child",
                "bot_child_reversed", "dna")


def port_alignment(model):
    """hal_tpu_torch.alignment.Alignment over the arrays of `model` (a
    hal_bench.reference.alignment.Alignment), the tree in the same child
    order."""
    from hal_tpu_torch.alignment import Alignment
    from hal_tpu_torch.genome import GenomeArrays

    aln = Alignment()
    tree = model.tree
    for name in tree.preorder():
        parent = tree.parent(name)
        if parent is None:
            aln.add_root_genome(name)
        else:
            aln.add_leaf_genome(name, parent, tree.branch_length(name))
    for name in tree.preorder():
        g = model.open_genome(name)
        aln.set_genome(GenomeArrays(
            name=name, seq_names=list(g.seq_names),
            **{f: getattr(g, f) for f in ARRAY_FIELDS}))
    return aln
