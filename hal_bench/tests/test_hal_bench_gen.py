"""The frozen generator against the port's: the same arrays at a small
size, and the content seed moving only the content."""

import numpy as np
import pytest

from hal_bench import gen
from hal_bench.port import ARRAY_FIELDS

KW = dict(max_genomes=8, min_genomes=6, mean_degree=1.5,
          max_branch_length=0.4, min_segment_length=20,
          max_segment_length=40, min_segments=50, max_segments=80)


@pytest.mark.parametrize("dna", ["none", "loop"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_copy_gives_the_originals_arrays(seed, dna):
    from hal_tpu_torch.randgen import create_random_alignment

    kw = dict(KW, store_dna=dna != "none")
    a = gen.create_random_alignment(seed=seed, **kw)
    b = create_random_alignment(seed=seed, **kw)
    assert a.genome_names() == b.genome_names()
    assert a.get_newick_tree() == b.get_newick_tree()
    for n in a.genome_names():
        ga, gb = a.open_genome(n), b.open_genome(n)
        assert ga.seq_names == gb.seq_names
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f), f)


def test_content_seed_keeps_tree_and_sizes():
    a = gen.create_random_alignment(seed=3, content_seed=1, **KW)
    b = gen.create_random_alignment(seed=3, content_seed=2, **KW)
    assert a.get_newick_tree() == b.get_newick_tree()
    assert any((a.open_genome(n).top_parent != b.open_genome(n).top_parent)
               .any() for n in a.genome_names())
    for n in a.genome_names():
        np.testing.assert_array_equal(a.open_genome(n).top_start,
                                      b.open_genome(n).top_start)


def test_from_config_arrays_are_read_only():
    from hal_bench import harness

    cfg = dict(harness.load_json("configs", "mammal10-2k"),
               min_segments=50, max_segments=60)
    aln = gen.from_config(cfg, 11)
    g = aln.open_genome(aln.genome_names()[0])
    with pytest.raises(ValueError):
        g.top_start[0] = 1


def _child_and_parent(aln):
    for n in aln.genome_names():
        p = aln.tree.parent(n)
        if p is not None and aln.open_genome(n).length:
            return aln.open_genome(n), aln.open_genome(p), aln.tree.branch_length(n)
    raise AssertionError("no child genome")


def test_device_dna_follows_the_links():
    """The device fill: the same seed gives the same bases, another seed
    others; a child's base equals its parent's (complemented when the top
    segment is inverted) at about the rate the branch length keeps."""
    from hal_bench.reference.dna import COMP_MAP, unpack_dna

    kw = dict(KW, max_branch_length=0.3, store_dna=True, dna_device="cpu")
    a = gen.create_random_alignment(seed=4, content_seed=9, **kw)
    b = gen.create_random_alignment(seed=4, content_seed=9, **kw)
    c = gen.create_random_alignment(seed=4, content_seed=10, **kw)
    name = a.genome_names()[1]
    np.testing.assert_array_equal(a.open_genome(name).dna,
                                  b.open_genome(name).dna)
    assert (a.open_genome(name).dna != c.open_genome(name).dna).any()
    g, pg, bl = _child_and_parent(a)
    seq = unpack_dna(g.dna, 0, g.length)
    pseq = unpack_dna(pg.dna, 0, pg.length)
    assert set(np.unique(seq).tobytes()) <= set(b"ACGT")
    same = total = 0
    for i in range(g.num_top_segments):
        p = int(g.top_parent[i])
        if p < 0:
            continue
        s, e = int(g.top_start[i]), int(g.top_start[i + 1])
        ps = int(pg.bot_start[p])
        want = pseq[ps:ps + e - s]
        if g.top_parent_reversed[i]:
            want = COMP_MAP[want[::-1]]
        same += int((seq[s:e] == want).sum())
        total += e - s
    kept = np.exp(-bl) + (1 - np.exp(-bl)) / 4
    assert total > 1000
    assert abs(same / total - kept) < 0.05
