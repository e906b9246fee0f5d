"""The reference's in-memory alignment: a tree and one Genome of plain numpy
arrays per node, as the benchmark's generator (hal_bench.gen) makes them.

It offers the part of the port's Alignment that the frozen copies
(column_exact, maf_builder, segmap_host) and the reference mapper read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hal_bench.reference.genome import GenomeArrays
from hal_bench.reference.tree import Tree


@dataclass
class Alignment:
    tree: Tree = field(default_factory=Tree)
    genomes: dict[str, GenomeArrays] = field(default_factory=dict)

    @property
    def root_name(self) -> str | None:
        return self.tree.root

    @property
    def num_genomes(self) -> int:
        return len(self.tree.names())

    def genome_names(self) -> list[str]:
        return self.tree.names()

    def get_newick_tree(self) -> str:
        return self.tree.to_newick()

    def open_genome(self, name: str) -> GenomeArrays:
        return self.genomes[name]

    def child_index(self, parent: str, child: str) -> int:
        return self.tree.child_index(parent, child)
