"""The port's copies of hal_tpu's host modules (hal_tpu_torch.{alignment,
genome, tree, dna, randgen, storage, io.bed, ops.segmap_host, ops.liftover,
ops.liftover_bulk, tools}) against their originals on seeded fixtures.
Tolerance: exact equality (arrays, trees, records and bytes)."""

import dataclasses
import io

import numpy as np
import pytest

from hal_tpu.io import bed as jax_bed
from hal_tpu.ops import liftover as jax_liftover
from hal_tpu.ops import liftover_bulk as jax_bulk
from hal_tpu.ops import segmap_host as jax_sm
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.storage import open_alignment as jax_open
from hal_tpu.storage import save_alignment as jax_save
from hal_tpu_torch.io import bed as port_bed
from hal_tpu_torch.ops import liftover as port_liftover
from hal_tpu_torch.ops import liftover_bulk as port_bulk
from hal_tpu_torch.ops import segmap_host as port_sm
from hal_tpu_torch.randgen import create_random_alignment
from hal_tpu_torch.storage import open_alignment, save_alignment

FIXTURE = dict(seed=21, max_genomes=7, min_genomes=5, mean_degree=1.4,
               min_segments=8, max_segments=50, min_segment_length=3,
               max_segment_length=15)


def _assert_same_alignment(a, b):
    assert a.tree.to_newick() == b.tree.to_newick()
    assert a.genome_names() == b.genome_names()
    assert a.root_name == b.root_name
    for name in a.genome_names():
        ga, gb = a.open_genome(name), b.open_genome(name)
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            if isinstance(x, np.ndarray):
                y = np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), (name, f.name)
            else:
                assert x == y, (name, f.name)


def test_create_random_alignment_equals_original():
    for seed, store_dna in ((21, True), (4, False)):
        opts = dict(FIXTURE, seed=seed, store_dna=store_dna)
        _assert_same_alignment(create_random_alignment(**opts),
                               jax_random_alignment(**opts))


@pytest.mark.parametrize("fmt,name", [("halz", "aln.halz"),
                                      ("mmap", "aln.mmap"),
                                      ("hdf5", "aln.hal")])
def test_storage_equals_original(tmp_path, fmt, name):
    """One alignment saved by either package in each format loads to
    equal arrays and tree through both packages."""
    aln = jax_random_alignment(**FIXTURE)
    a = str(tmp_path / ("jax_" + name))
    b = str(tmp_path / ("port_" + name))
    jax_save(aln, a, fmt=fmt)
    save_alignment(create_random_alignment(**FIXTURE), b, fmt=fmt)
    for path in (a, b):
        got = open_alignment(path)
        assert type(got).__module__ == "hal_tpu_torch.alignment"
        _assert_same_alignment(got, jax_open(path))
        _assert_same_alignment(got, aln)
    with pytest.raises(ValueError, match="not supported"):
        open_alignment("https://example.invalid/aln.hal")


def _pairs(aln):
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    return [(leaves[0], leaves[-1]), (leaves[-1], aln.root_name),
            (aln.root_name, leaves[0])]


def _intervals(aln, src, n, seed):
    g = aln.open_genome(src)
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, max(g.length - 3, 1), n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 30, n), g.length)
    return lo, hi


def _same_fragments(x, y):
    for f in ("src_lo", "src_hi", "tgt_lo", "tgt_hi", "rev"):
        u, v = getattr(x, f), getattr(y, f)
        assert u.dtype == v.dtype and np.array_equal(u, v), f


@pytest.mark.parametrize("opts", [{}, dict(do_dupes=False),
                                  dict(min_length=4), dict(coalescence="root")],
                         ids=["default", "noDupes", "minLength", "coalescence"])
def test_segmap_host_equals_original(opts):
    aln = jax_random_alignment(**FIXTURE)
    opts = dict(opts)
    if opts.pop("coalescence", None):
        opts["coalescence_limit"] = aln.root_name
    for k, (src, tgt) in enumerate(_pairs(aln)):
        lo, hi = _intervals(aln, src, 40, k)
        got = port_sm.map_source(aln, src, lo, hi, tgt, **opts)
        want = jax_sm.map_source(aln, src, lo, hi, tgt, **opts)
        assert len(want)
        _same_fragments(got, want)
        _same_fragments(port_sm.atomize(got), jax_sm.atomize(want))


def test_read_bed_equals_original():
    text = ("chr1\t5\t20\n"
            "chr2\t0\t9\tname\t7\t-\n"
            "chr1\t3\t40\tn2\t0\t+\t5\t30\t255,0,0\t2\t4,6,\t0,31,\n"
            "chr3\t1\t8\tn3\t0\t.\t1\t8\t0\t1\t7,\t0,\textra\tmore\n"
            "#comment\n\n"
            "chr1\t8\t9\tn4\n")
    bed6 = "chr2\t0\t9\tname\t7\t-\nchr1\t4\t6\tx\t1\t+\textra\n"
    for t, bed_type in ((text, 0), (bed6, 3), (bed6, 6)):
        got = list(port_bed.read_bed(io.StringIO(t), bed_type))
        want = list(jax_bed.read_bed(io.StringIO(t), bed_type))
        assert got and [vars(g) for g in got] == [vars(w) for w in want]
        assert [g.write() for g in got] == [w.write() for w in want]
        assert ([g.write_psl(True) for g in got if g.psl]
                == [w.write_psl(True) for w in want if w.psl])


def _bed_text(aln, src, n, seed):
    g = aln.open_genome(src)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, g.num_sequences))
        slen = g.seq_length(k)
        a = int(rng.integers(0, max(slen - 10, 1)))
        b = min(a + int(rng.integers(1, 12)), slen)
        out.append("%s\t%d\t%d\tn%d\t0\t%s\n"
                   % (g.seq_names[k], a, b, i, "+-."[a % 3]))
    return "".join(out)


@pytest.mark.parametrize("opts", [{}, dict(traverse_dupes=False),
                                  dict(out_psl=True)],
                         ids=["default", "noDupes", "psl"])
def test_liftover_convert_equals_original(opts):
    """Liftover.convert (the per-line path, --batchSize 0) of the merged
    port module emits the original's bytes."""
    aln = jax_random_alignment(**FIXTURE)
    src, tgt = _pairs(aln)[0]
    text = _bed_text(aln, src, 200, 3)
    o1, o2 = io.StringIO(), io.StringIO()
    jax_liftover.Liftover(aln, src, tgt, **opts).convert(io.StringIO(text), o1)
    port_liftover.Liftover(aln, src, tgt, device="cpu", **opts).convert(
        io.StringIO(text), o2)
    assert o2.getvalue() == o1.getvalue() and o1.getvalue()


def test_bulk_host_halves_equal_original():
    """bulk_map(use_device=False), atomize_by_owner and extract_runs_bulk
    (its numpy branch; the original may take its native helper) equal the
    originals, for disjoint and overlapping intervals."""
    aln = jax_random_alignment(**FIXTURE)
    src, tgt = _pairs(aln)[0]
    sg, tg = aln.open_genome(src), aln.open_genome(tgt)
    scale = int(max(sg.length, tg.length) + 2)
    lo, hi = _intervals(aln, src, 60, 9)
    starts = np.arange(0, sg.length - 6, 9)
    for a, b in ((lo, hi), (starts, starts + 6)):
        got = port_bulk.bulk_map(aln, src, tgt, a, b, use_device=False,
                                 device="cpu")
        want = jax_bulk.bulk_map(aln, src, tgt, a, b, use_device=False)
        assert all(x.dtype == y.dtype and np.array_equal(x, y)
                   for x, y in zip(got, want))
        got = port_bulk.atomize_by_owner(
            *[np.asarray(x, np.int64) if x.dtype != np.uint8 else x
              for x in got], scale)
        want = jax_bulk.atomize_by_owner(
            *[np.asarray(x, np.int64) if x.dtype != np.uint8 else x
              for x in want], scale)
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
        runs = port_bulk.extract_runs_bulk(tg, *got, scale)
        assert len(runs[0])
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in
                   zip(runs, jax_bulk.extract_runs_bulk(tg, *want, scale)))
