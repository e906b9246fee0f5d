"""Port copy of hal_tpu/alignment.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

In-memory Alignment container: tree + genomes + metadata.

Capability-parity with hal::Alignment (reference api/inc/halAlignment.h:29-162):
tree surgery (add/insert/remove genomes), newick access, metadata, and lazy
per-genome loading (storage drivers may attach a loader callback so genomes
are only materialized when first touched, mirroring Alignment::openGenome).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from hal_tpu_torch.constants import HAL_VERSION
from hal_tpu_torch.genome import GenomeArrays, SequenceInfo
from hal_tpu_torch.tree import Tree


class GenomeNotFoundError(KeyError):
    """Reference GenomeNotFoundException (api/inc/halAlignment.h:17)."""


@dataclass
class Alignment:
    tree: Tree = field(default_factory=Tree)
    metadata: dict[str, str] = field(default_factory=dict)
    version: str = HAL_VERSION
    _genomes: dict[str, GenomeArrays] = field(default_factory=dict)
    # storage drivers set this to lazy-load genomes on first access
    _loader: Callable[[str], GenomeArrays] | None = None
    # file path this alignment came from (None for purely in-memory)
    path: str | None = None

    # ----------------------------------------------------------------- tree
    @property
    def root_name(self) -> str | None:
        return self.tree.root

    def genome_names(self) -> list[str]:
        return self.tree.names()

    @property
    def num_genomes(self) -> int:
        return len(self.tree.names())

    def get_newick_tree(self) -> str:
        return self.tree.to_newick()

    def get_parent_name(self, name: str) -> str | None:
        self._check(name)
        return self.tree.parent(name)

    def get_child_names(self, name: str) -> list[str]:
        self._check(name)
        return self.tree.children(name)

    def get_branch_length(self, child: str) -> float:
        self._check(child)
        return self.tree.branch_length(child)

    def _check(self, name: str) -> None:
        if name not in self.tree:
            raise GenomeNotFoundError(name)

    # -------------------------------------------------------------- genomes
    def open_genome(self, name: str) -> GenomeArrays:
        self._check(name)
        g = self._genomes.get(name)
        if g is None:
            if self._loader is None:
                raise GenomeNotFoundError("genome %s has no data" % name)
            g = self._loader(name)
            self._genomes[name] = g
        return g

    def close_genome(self, name: str) -> None:
        """Drop a genome's arrays from memory (lazy storage will reload)."""
        if self._loader is not None:
            self._genomes.pop(name, None)

    def add_root_genome(self, name: str, sequences: list[SequenceInfo] | None = None) -> GenomeArrays | None:
        self.tree.set_root(name)
        if sequences is not None:
            g = GenomeArrays.create(name, sequences, num_children=0)
            self._genomes[name] = g
            return g
        self._genomes[name] = GenomeArrays(name=name)
        return self._genomes[name]

    def add_leaf_genome(self, name: str, parent: str, branch_length: float = 1.0) -> GenomeArrays:
        self._check(parent)
        self.tree.add_child(parent, name, branch_length)
        g = GenomeArrays(name=name)
        self._genomes[name] = g
        return g

    def insert_genome(self, name: str, parent: str, child: str, upper_branch_length: float) -> GenomeArrays:
        """Insert `name` on the branch parent->child
        (reference Alignment::insertGenome, halAlignment.h:75-88)."""
        self._check(parent)
        self._check(child)
        old_bl = self.tree.branch_length(child)
        kids = self.tree._children[parent]
        idx = kids.index(child)
        # splice: parent -> name -> child
        self.tree._children[name] = [child]
        kids[idx] = name
        self.tree._parent[name] = parent
        self.tree._parent[child] = name
        self.tree._branch_length[name] = upper_branch_length
        self.tree._branch_length[child] = max(old_bl - upper_branch_length, 0.0)
        g = GenomeArrays(name=name)
        self._genomes[name] = g
        return g

    def remove_genome(self, name: str) -> None:
        """Remove a leaf genome (reference Alignment::removeGenome)."""
        self._check(name)
        if self.tree.children(name):
            raise ValueError("can only remove leaf genomes: %s" % name)
        parent = self.tree.parent(name)
        if parent is not None:
            # drop the child column from the parent's bottoms
            import numpy as np
            pg = self._genomes.get(parent) or (self._loader and self.open_genome(parent))
            ci = self.tree.child_index(parent, name)
            if pg is not None and pg.bot_child.size:
                pg.bot_child = np.delete(pg.bot_child, ci, axis=1)
                pg.bot_child_reversed = np.delete(pg.bot_child_reversed, ci, axis=1)
        self.tree.remove_leaf(name)
        self._genomes.pop(name, None)

    def remove_subtree(self, name: str) -> None:
        for n in self.tree.remove_subtree(name):
            self._genomes.pop(n, None)

    def rename_genome(self, old: str, new: str) -> None:
        self._check(old)
        self.tree.rename(old, new)
        g = self._genomes.pop(old, None)
        if g is not None:
            g.name = new
            self._genomes[new] = g

    def set_genome(self, g: GenomeArrays) -> None:
        """Attach/replace a fully-built genome's arrays."""
        if g.name not in self.tree:
            raise GenomeNotFoundError(g.name)
        self._genomes[g.name] = g

    # ------------------------------------------------------------- routing
    def child_index(self, parent: str, child: str) -> int:
        return self.tree.child_index(parent, child)

    def copy(self) -> "Alignment":
        a = Alignment(tree=self.tree.copy(), metadata=dict(self.metadata), version=self.version)
        for name in self.genome_names():
            a._genomes[name] = self.open_genome(name).copy()
        return a
