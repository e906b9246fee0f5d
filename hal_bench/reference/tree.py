"""Frozen copy of hal_tpu_torch/tree.py for the benchmark's plain reference (numpy
only; the same code, imports pointing at hal_bench.reference).  It is the
yardstick: the port may change, this copy does not.

Phylogenetic tree: newick parse/serialize + routing queries.

Replaces the reference's use of sonLib stTree plus the tree helpers in
reference api/impl/halCommon.cpp (getLowestCommonAncestor
halCommon.h:158, getGenomesInSpanningTree halCommon.h:162) and the
tree-editing operations on hal::Alignment (api/inc/halAlignment.h:62-118).

The tree is tiny (tens of nodes) and lives on the host; all routing for the
device kernels (genome paths, spanning trees) is precomputed here.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Tree:
    """Rooted phylogeny over genome names with branch lengths.

    Child order is significant: a bottom segment's child slot i corresponds to
    children(parent)[i], matching Genome::getChildIndex semantics
    (reference api/inc/halGenome.h, api/impl/halGenome.cpp).
    """

    root: str | None = None
    _parent: dict[str, str] = field(default_factory=dict)
    _children: dict[str, list[str]] = field(default_factory=dict)
    _branch_length: dict[str, float] = field(default_factory=dict)  # keyed by child

    # ------------------------------------------------------------- structure
    def add_root(self, name: str) -> None:
        if self.root is not None:
            raise ValueError("tree already has a root: %s" % self.root)
        self.root = name
        self._children.setdefault(name, [])

    def add_child(self, parent: str, child: str, branch_length: float = 1.0) -> None:
        if parent not in self._children:
            raise KeyError("unknown parent genome: %s" % parent)
        if child in self._children:
            raise ValueError("genome already in tree: %s" % child)
        self._children[parent].append(child)
        self._children[child] = []
        self._parent[child] = parent
        self._branch_length[child] = branch_length

    def set_root(self, name: str) -> None:
        """Insert a new root above the current root (halAlignment insertGenome-root case)."""
        if self.root is None:
            self.add_root(name)
            return
        old = self.root
        self.root = name
        self._children[name] = [old]
        self._parent[old] = name
        self._branch_length[old] = 1.0

    def remove_leaf(self, name: str) -> None:
        if self._children.get(name):
            raise ValueError("%s is not a leaf" % name)
        p = self._parent.pop(name, None)
        if p is not None:
            self._children[p].remove(name)
        self._children.pop(name, None)
        self._branch_length.pop(name, None)
        if self.root == name:
            self.root = None

    def remove_subtree(self, name: str) -> list[str]:
        """Remove `name` and all its descendants; returns removed names."""
        removed = list(self.postorder(name))
        for n in removed:
            self._children.pop(n, None)
            self._branch_length.pop(n, None)
            self._parent.pop(n, None)
        p = self._parent.get(name)
        for parent, kids in self._children.items():
            if name in kids:
                kids.remove(name)
        if self.root == name:
            self.root = None
        return removed

    def rename(self, old: str, new: str) -> None:
        if new in self._children:
            raise ValueError("genome already in tree: %s" % new)
        self._children[new] = self._children.pop(old)
        if old in self._parent:
            self._parent[new] = self._parent.pop(old)
            self._branch_length[new] = self._branch_length.pop(old)
        for child in self._children[new]:
            self._parent[child] = new
        for parent, kids in self._children.items():
            self._children[parent] = [new if k == old else k for k in kids]
        if self.root == old:
            self.root = new

    # --------------------------------------------------------------- queries
    def __contains__(self, name: str) -> bool:
        return name in self._children

    def parent(self, name: str) -> str | None:
        return self._parent.get(name)

    def children(self, name: str) -> list[str]:
        return list(self._children.get(name, []))

    def child_index(self, parent: str, child: str) -> int:
        return self._children[parent].index(child)

    def branch_length(self, child: str) -> float:
        return self._branch_length.get(child, 0.0)

    def set_branch_length(self, child: str, bl: float) -> None:
        self._branch_length[child] = bl

    def names(self) -> list[str]:
        return list(self.postorder()) if self.root else []

    def leaves(self, start: str | None = None) -> list[str]:
        return [n for n in self.postorder(start) if not self._children[n]]

    def is_leaf(self, name: str) -> bool:
        return not self._children.get(name)

    def num_children(self, name: str) -> int:
        return len(self._children.get(name, []))

    def preorder(self, start: str | None = None):
        start = start or self.root
        if start is None:
            return
        stack = [start]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(reversed(self._children[n]))

    def postorder(self, start: str | None = None):
        start = start or self.root
        if start is None:
            return
        out, stack = [], [start]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(self._children[n])
        yield from reversed(out)

    def depth(self, name: str) -> int:
        d = 0
        while name in self._parent:
            name = self._parent[name]
            d += 1
        return d

    def path_to_root(self, name: str) -> list[str]:
        out = [name]
        while name in self._parent:
            name = self._parent[name]
            out.append(name)
        return out

    def lca(self, a: str, b: str) -> str:
        """Lowest common ancestor (reference getLowestCommonAncestor, halCommon.h:158)."""
        anc = set(self.path_to_root(a))
        for n in self.path_to_root(b):
            if n in anc:
                return n
        raise ValueError("no common ancestor of %s and %s" % (a, b))

    def path(self, src: str, dst: str) -> list[str]:
        """Genome path src -> ... -> lca -> ... -> dst (inclusive both ends)."""
        l = self.lca(src, dst)
        up = []
        n = src
        while n != l:
            up.append(n)
            n = self._parent[n]
        down = []
        n = dst
        while n != l:
            down.append(n)
            n = self._parent[n]
        return up + [l] + list(reversed(down))

    def spanning_tree(self, names: list[str]) -> set[str]:
        """All genomes on paths between any pair of `names`
        (reference getGenomesInSpanningTree, halCommon.h:162)."""
        if not names:
            return set()
        out: set[str] = {names[0]}
        for n in names[1:]:
            out.update(self.path(names[0], n))
            # paths between other pairs route through lca(names[0], n)'s subtree
        # complete closure: union of pairwise paths == union of paths to the
        # LCA of the whole set plus each name's path to it
        top = names[0]
        for n in names[1:]:
            top = self.lca(top, n)
        for n in names:
            out.update(self.path(n, top))
        return out

    # --------------------------------------------------------------- newick
    def to_newick(self, branch_lengths: bool = True) -> str:
        if self.root is None:
            return "";

        def fmt_bl(x: float) -> str:
            # match stTree's printf("%g") style used by the reference
            return ("%g" % x)

        def rec(n: str) -> str:
            kids = self._children[n]
            label = _quote_newick_label(n)
            if kids:
                inner = ",".join(rec(k) for k in kids)
                s = "(%s)%s" % (inner, label)
            else:
                s = label
            if branch_lengths and n in self._branch_length:
                s += ":" + fmt_bl(self._branch_length[n])
            return s

        return rec(self.root) + ";"

    @classmethod
    def from_newick(cls, text: str) -> "Tree":
        t = cls()
        text = text.strip()
        if text.endswith(";"):
            text = text[:-1]
        if not text:
            return t
        pos = [0]

        def parse_label() -> tuple[str, float | None]:
            i = pos[0]
            name = ""
            if i < len(text) and text[i] in "'\"":
                q = text[i]
                i += 1
                j = text.index(q, i)
                name = text[i:j]
                i = j + 1
            else:
                j = i
                while j < len(text) and text[j] not in ",():;":
                    j += 1
                name = text[i:j]
                i = j
            bl = None
            if i < len(text) and text[i] == ":":
                j = i + 1
                while j < len(text) and text[j] not in ",()":
                    j += 1
                bl = float(text[i + 1 : j])
                i = j
            pos[0] = i
            return name, bl

        def parse_node() -> tuple[str, float | None, list]:
            kids = []
            if pos[0] < len(text) and text[pos[0]] == "(":
                pos[0] += 1
                while True:
                    kids.append(parse_node())
                    if text[pos[0]] == ",":
                        pos[0] += 1
                        continue
                    if text[pos[0]] == ")":
                        pos[0] += 1
                        break
            name, bl = parse_label()
            return name, bl, kids

        _anon = [0]

        def attach(node, parent):
            name, bl, kids = node
            if not name:
                name = "Anc%02d" % _anon[0]
                _anon[0] += 1
            if parent is None:
                t.add_root(name)
            else:
                t.add_child(parent, name, bl if bl is not None else 1.0)
                if bl is None:
                    t._branch_length.pop(name, None)
            for k in kids:
                attach(k, name)

        attach(parse_node(), None)
        return t

    def copy(self) -> "Tree":
        t = Tree(root=self.root)
        t._parent = dict(self._parent)
        t._children = {k: list(v) for k, v in self._children.items()}
        t._branch_length = dict(self._branch_length)
        return t


def _quote_newick_label(name: str) -> str:
    if any(c in name for c in " ,():;'\""):
        return "'" + name.replace("'", "''") + "'"
    return name
