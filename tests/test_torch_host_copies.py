"""The port's copies of hal_tpu's host modules (hal_tpu_torch.{alignment,
genome, tree, dna, randgen, storage, io.bed, io.maf_io, io.wiggle, native,
ops.segmap_host, ops.liftover, ops.liftover_bulk, ops.column, ops.poscache,
ops.column_native, tools} and the host half of ops.column_torch, and the
functions of the export and mutation tools) against their originals on
seeded fixtures.  Tolerance: exact equality (arrays,
trees, records and bytes)."""

import dataclasses
import io
import os

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    # URLs open through storage.remote (tests/test_torch_remote.py); a
    # write mode is refused before any request is made
    with pytest.raises(ValueError, match="read-only"):
        open_alignment("https://example.invalid/aln.hal", mode="w")


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


# ------------------------------------------------ column / MAF / wiggle

MAF_FIXTURE = dict(seed=11, max_genomes=7, min_genomes=5, min_segments=6,
                   max_segments=30, min_segment_length=3, max_segment_length=12)


def _maf_text(pkg_column, pkg_maf, aln, ref, slice_kw, builder_kw):
    out = io.StringIO()
    pkg_maf.write_header(out, aln)
    b = pkg_maf.MafBlockBuilder(aln, ref, ucsc_names=True, **builder_kw)
    g = aln.open_genome(ref)
    for gs in range(0, int(g.length), 40):  # windows through one builder
        ge = min(gs + 40, int(g.length))
        for block in b.feed(pkg_column.iter_slices_exact(aln, ref, gs, ge,
                                                         **slice_kw)):
            out.write(block + "\n")
    t = b.flush_end()
    if t:
        out.write(t + "\n")
    return out.getvalue()


@pytest.mark.parametrize("slice_kw,builder_kw", [
    ({}, {}), (dict(no_dupes=True), {}), (dict(unique=True), {}),
    (dict(max_ref_gap=5), dict(keep_empty_ref_blocks=False)),
    (dict(only_orthologs=True, no_ancestors=True), dict(max_block_len=9)),
    ({}, dict(print_tree=True))],
    ids=["default", "noDupes", "unique", "maxRefGap", "orthologs",
         "printTree"])
def test_exact_column_engine_and_maf_equal_original(slice_kw, builder_kw):
    """ops.column (iter_slices_exact, its position cache ops.poscache, the
    gene trees of --printTree) with io.maf_io's builder and header emit the
    originals' MAF text, leaf and root references."""
    from hal_tpu.io import maf_io as jax_maf
    from hal_tpu.ops import column as jax_column
    from hal_tpu_torch.io import maf_io as port_maf
    from hal_tpu_torch.ops import column as port_column

    port = create_random_alignment(**MAF_FIXTURE)
    ref_aln = jax_random_alignment(**MAF_FIXTURE)
    leaves = [n for n in port.genome_names() if port.tree.is_leaf(n)]
    for ref in (leaves[0], port.root_name):
        got = _maf_text(port_column, port_maf, port, ref, slice_kw,
                        builder_kw)
        want = _maf_text(jax_column, jax_maf, ref_aln, ref, slice_kw,
                         builder_kw)
        assert got == want and "\ns\t" in got, ref
    assert port_column.compute_scope(port, leaves[0], leaves[1:3]) == \
        jax_column.compute_scope(ref_aln, leaves[0], leaves[1:3])


def test_position_cache_equals_original():
    from hal_tpu.ops.poscache import PositionCache as JaxCache
    from hal_tpu_torch.ops.poscache import PositionCache

    rng = np.random.default_rng(6)
    a, b = PositionCache(), JaxCache()
    for _ in range(300):
        lo = int(rng.integers(0, 500))
        hi = lo + int(rng.integers(1, 20))
        a.add(lo, hi)
        b.add(lo, hi)
        p = int(rng.integers(0, 520))
        assert (len(a), a.num_intervals()) == (len(b), b.num_intervals())
        assert a.covers(lo, hi + 1) == b.covers(lo, hi + 1)
        assert a.contains(p) == b.contains(p)
        assert a.interval_at(p) == b.interval_at(p)
        assert list(a.overlaps(p, p + 9)) == list(b.overlaps(p, p + 9))
        assert a.free_run(p, True) == b.free_run(p, True)
        assert a.free_run(p, False) == b.free_run(p, False)


def test_column_host_twin_equals_original():
    """column_torch's host half (build_programs, ColumnHostSim with its
    sizing totals and key spaces, _target_frags_host) equals
    column_jax's."""
    from hal_tpu.ops import column_jax as jc
    from hal_tpu_torch.ops import column_torch as ct

    port = create_random_alignment(**MAF_FIXTURE)
    ref_aln = jax_random_alignment(**MAF_FIXTURE)
    ref = [n for n in port.genome_names() if port.tree.is_leaf(n)][0]
    scope = set(port.genome_names())
    root = port.root_name
    ge = int(port.open_genome(ref).length)
    progs = ct.build_programs(port, ref, scope, root)
    sim, jsim = ct.ColumnHostSim(port), jc.ColumnHostSim(ref_aln)
    for specs in progs.values():
        for spec in specs:
            got, tot = sim.run(spec, 3, ge, with_totals=True)
            want, wtot = jsim.run(spec, 3, ge, with_totals=True)
            assert tot == wtot and sim.key_space(spec) == jsim.key_space(spec)
            for f in ("s_lo", "t_lo", "ln", "rev", "key"):
                assert np.array_equal(getattr(got, f), getattr(want, f))
    got = ct._target_frags_host(sim, progs, 0, ge)
    want = jc._target_frags_host(jsim, jc.build_programs(ref_aln, ref, scope,
                                                         root), 0, ge)
    assert got.keys() == want.keys()
    for t in got:
        assert len(got[t]) == len(want[t])
        for (o, a), (p, b) in zip(got[t], want[t]):
            assert o == p and np.array_equal(a.key, b.key)
            assert np.array_equal(a.t_lo, b.t_lo)


WIGGLE = ("track type=wiggle_0\n"
          "fixedStep chrom=chrA start=11 step=3 span=2\n1.5\n-2\n0.25\n"
          "variableStep chrom=chrB span=3\n5 7\n20 1e-3\n"
          "fixedStep chrom=chrA start=100\n4\n5\n6\n7\n")


def test_wiggle_io_equals_original():
    """io.wiggle (whole-buffer and line readers, the runs writer) and the
    native runtime's parse / format entries equal the originals'."""
    from hal_tpu import native as jax_native
    from hal_tpu.io import wiggle as jax_wiggle
    from hal_tpu_torch import native
    from hal_tpu_torch.io import wiggle

    assert native.available() == jax_native.available()
    for got, want in (
            (list(wiggle.read_wiggle(io.StringIO(WIGGLE))),
             list(jax_wiggle.read_wiggle(io.StringIO(WIGGLE)))),
            (list(wiggle._read_wiggle_lines(io.StringIO(WIGGLE))),
             list(jax_wiggle._read_wiggle_lines(io.StringIO(WIGGLE))))):
        assert len(got) == len(want) == 3
        for (s, p, v), (s2, p2, v2) in zip(got, want):
            assert s == s2 and np.array_equal(p, p2) and np.array_equal(v, v2)
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 60, 80)
    vals = np.round(rng.normal(size=80), 4)
    a, b = io.StringIO(), io.StringIO()
    wiggle.write_wiggle_runs(a, "chrA", pos, vals)
    jax_wiggle.write_wiggle_runs(b, "chrA", pos, vals)
    assert a.getvalue() == b.getvalue() and a.getvalue()
    if native.available():
        chunk = b"1.5\n-2\n3e2\n"
        assert np.array_equal(native.parse_fixed_values(chunk),
                              jax_native.parse_fixed_values(chunk))
        assert native.format_wiggle_values(vals) == \
            jax_native.format_wiggle_values(vals)
        text = b"chrA\t5\t9\nchrB\t1\t3\nchrZ\t0\t1\n"
        assert all(np.array_equal(x, y) for x, y in zip(
            native.parse_bed3(text, ["chrA", "chrB"]),
            jax_native.parse_bed3(text, ["chrA", "chrB"])))


@pytest.mark.parametrize("opts", [{}, dict(max_ref_gap=4), dict(unique=True),
                                  dict(no_dupes=True, max_block_len=7),
                                  dict(shared_visit={})],
                         ids=["default", "maxRefGap", "unique", "noDupes",
                              "global"])
def test_native_column_exporter_equals_original(opts):
    """ops.column_native's NativeMafExporter (export, finish, and
    export_frags from the host twin's keyed fragments) emits the original
    binding's bytes; under --global (shared_visit) two leaves in turn
    through set_ref, each exported whole, as hal2maf --global does."""
    from hal_tpu.ops import column_native as jax_cn
    from hal_tpu_torch.ops import column_native as port_cn
    from hal_tpu_torch.ops import column_torch as ct

    if not (port_cn.available() and jax_cn.available()):
        pytest.skip("native column engine not built")
    port = create_random_alignment(**MAF_FIXTURE)
    ref_aln = jax_random_alignment(**MAF_FIXTURE)
    ref = [n for n in port.genome_names() if port.tree.is_leaf(n)][0]
    ge = int(port.open_genome(ref).length)
    ex = port_cn.maybe_native_exporter(port, ref, **opts)
    jex = jax_cn.maybe_native_exporter(ref_aln, ref, **opts)
    if "shared_visit" in opts:
        got, want = [], []
        for leaf in [n for n in sorted(port.genome_names())
                     if port.tree.is_leaf(n)][:2]:
            n = int(port.open_genome(leaf).length)
            ex.set_ref(leaf)
            jex.set_ref(leaf)
            got.append(ex.export(0, n) + ex.finish())
            want.append(jex.export(0, n) + jex.finish())
        assert got == want and all(got)
    else:
        got = ex.export(0, ge // 2) + ex.export(ge // 2, ge) + ex.finish()
        want = jex.export(0, ge // 2) + jex.export(ge // 2, ge) + \
            jex.finish()
        assert got == want and got
    if not opts:
        frags = ct._target_frags_host(
            ct.ColumnHostSim(port),
            ct.build_programs(port, ref, set(port.genome_names()),
                              port.root_name), 0, ge)
        assert ex.export_frags(0, ge, frags) + ex.finish() == \
            jex.export_frags(0, ge, frags) + jex.finish()
    ex.close()
    jex.close()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("tree", ["binary", "multifurcating"])
def test_phylop_host_copy_equals_original(tmp_path, tree):
    """hal_tpu_torch.phylop against hal_tpu.phylop on one seeded GTR .mod:
    the parser, the eigenbasis (U, lam, Uinv), pmatrix,
    column_log_likelihood (with and without a subtree scale),
    score_patterns in every mode and scores_from_lrt, bit-equal."""
    from hal_tpu import phylop as jax_phylop
    from hal_tpu_torch import phylop as port_phylop
    from test_torch_phylop import BINARY8, MULTI, gtr_mod_text

    p = tmp_path / "m.mod"
    p.write_text(gtr_mod_text(BINARY8 if tree == "binary" else MULTI, 51))
    pm = port_phylop.NeutralModel.from_mod_file(str(p))
    jm = jax_phylop.NeutralModel.from_mod_file(str(p))
    assert pm.tree.to_newick() == jm.tree.to_newick()
    assert pm.branch_length == jm.branch_length
    for name in ("background", "rate_matrix", "_U", "_lam", "_Uinv"):
        assert _same(getattr(pm, name), getattr(jm, name)), name
    t = np.array([0.0, 1e-3, 0.1, 1.0, 7.5])
    assert _same(pm.pmatrix(t), jm.pmatrix(t))
    leaves = [n for n in pm.tree.names() if pm.tree.is_leaf(n)]
    li = {n: i for i, n in enumerate(leaves)}
    rng = np.random.default_rng(52)
    pats = rng.integers(0, 5, (120, len(leaves))).astype(np.int64)
    scale = rng.uniform(1e-3, 4.0, 120)
    sub_nodes = frozenset(pm.tree.preorder(
        [n for n in pm.tree.names() if not pm.tree.is_leaf(n)][1]))
    assert _same(port_phylop.column_log_likelihood(pm, li, pats, scale),
                 jax_phylop.column_log_likelihood(jm, li, pats, scale))
    assert _same(
        port_phylop.column_log_likelihood(pm, li, pats, scale, sub_nodes, 1.7),
        jax_phylop.column_log_likelihood(jm, li, pats, scale, sub_nodes, 1.7))
    for mode in ("CONACC", "CON", "ACC", "NNEUT"):
        assert _same(port_phylop.score_patterns(pm, li, pats[:40], mode),
                     jax_phylop.score_patterns(jm, li, pats[:40], mode)), mode
        delta = rng.normal(0, 3, 200)
        delta[:20] = 0.0
        delta[20:30] = 1e-12
        sign = rng.uniform(0.0, 3.0, 200)
        inf = rng.random(200) < 0.8
        assert _same(port_phylop.scores_from_lrt(delta, sign, inf, mode),
                     jax_phylop.scores_from_lrt(delta, sign, inf, mode))
    assert _same(port_phylop.score_patterns(pm, li, pats[:30], "CONACC",
                                            sub_nodes=sub_nodes),
                 jax_phylop.score_patterns(jm, li, pats[:30], "CONACC",
                                           sub_nodes=sub_nodes))
    bad = tmp_path / "bad.mod"
    bad.write_text(p.read_text().replace("ORDER: 0", "ORDER: 2"))
    for mod in (port_phylop, jax_phylop):
        with pytest.raises(ValueError, match="ORDER 0"):
            mod.NeutralModel.from_mod_file(str(bad))


@pytest.fixture(scope="module")
def stats_halz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stats") / "aln.halz")
    jax_save(jax_random_alignment(**FIXTURE), path, fmt="halz")
    return path


def test_halStats_copy_equals_original(stats_halz, capsys):
    """The port's halStats prints the original's bytes in every mode;
    --percentID here, and with --coverage and --allCoverage as CLIs in
    test_halStats_cli_copy_equals_original."""
    from hal_tpu.tools import halStats as jax_stats
    from hal_tpu_torch.tools import halStats as port_stats

    aln = jax_open(stats_halz)
    leaf = [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    root = aln.root_name
    for flags in ([], ["--genomes"], ["--sequences", leaf], ["--tree"],
                  ["--sequenceStats", leaf], ["--bedSequences", leaf],
                  ["--span", "%s,%s" % (leaf, root)],
                  ["--spanRoot", "%s,%s" % (leaf, root)], ["--branches"],
                  ["--children", root], ["--parent", leaf], ["--root"],
                  ["--branchLength", leaf], ["--numSegments", leaf],
                  ["--baseComp", "%s,3" % leaf], ["--metaData"],
                  ["--chromSizes", leaf], ["--topSegments", leaf],
                  ["--bottomSegments", root], ["--percentID", leaf],
                  ["--percentID", root]):
        capsys.readouterr()
        jax_stats.run([stats_halz] + flags)
        want = capsys.readouterr().out
        port_stats.run([stats_halz] + flags)
        assert capsys.readouterr().out == want, flags
        assert want or flags == ["--metaData"], flags


@pytest.mark.parametrize("flags", [["--percentID", 0], ["--coverage", 0],
                                   ["--allCoverage"]])
def test_halStats_cli_copy_equals_original(stats_halz, flags):
    """python -m hal_tpu_torch.tools.halStats prints the bytes of python -m
    hal_tpu.tools.halStats for the three modes that run the copied
    halPctId and halCoverage; both run as __main__ with the clock held
    fixed (--coverage seeds its sampler from it)."""
    import subprocess
    import sys

    aln = jax_open(stats_halz)
    leaf = [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    argv = [stats_halz] + [leaf if a == 0 else a for a in flags]
    out = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        code = ("import runpy, sys, time\n"
                "time.time = lambda: 1_700_000_000.0\n"
                "sys.argv = ['halStats'] + sys.argv[1:]\n"
                "runpy.run_module(%r, run_name='__main__')\n"
                % (pkg + ".tools.halStats"))
        r = subprocess.run([sys.executable, "-c", code] + argv,
                           capture_output=True, timeout=300, cwd=REPO)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        out[pkg] = r.stdout
    assert out["hal_tpu"] and out["hal_tpu_torch"] == out["hal_tpu"]


def test_halPctId_and_halCoverage_copies_equal_original(stats_halz):
    """The copied halPctId and halCoverage modules print the original's
    bytes: percent identity against every genome, coverage by genome and
    by sequence at two seeds, and all-coverage."""
    from hal_tpu.tools import halCoverage as jax_cov
    from hal_tpu.tools import halPctId as jax_pct
    from hal_tpu_torch.tools import halCoverage as port_cov
    from hal_tpu_torch.tools import halPctId as port_pct

    jaln = jax_open(stats_halz)
    paln = open_alignment(stats_halz)

    def text(fn, aln, *args, **kw):
        buf = io.StringIO()
        fn(buf, aln, *args, **kw)
        return buf.getvalue()

    for name in jaln.genome_names():
        want = text(jax_pct.print_percent_id, jaln, name)
        assert text(port_pct.print_percent_id, paln, name) == want, name
    leaf = [n for n in jaln.genome_names() if jaln.tree.is_leaf(n)][0]
    for seed, by_seq in ((0, False), (5, True)):
        want = text(jax_cov.print_coverage, jaln, leaf, 2000, seed, by_seq)
        assert want
        assert text(port_cov.print_coverage, paln, leaf, 2000, seed,
                    by_seq) == want, (seed, by_seq)
    want = text(jax_cov.print_all_coverage, jaln, 3000, 2)
    assert want and text(port_cov.print_all_coverage, paln, 3000, 2) == want


def test_parallel_mp_copy_equals_original(stats_halz):
    """parallel.mp's helpers (each a halStats subprocess of the port's
    tool) return the original's values; the shell pool returns each
    command's output in order."""
    from hal_tpu.parallel import mp as jax_mp
    from hal_tpu_torch.parallel import mp as port_mp

    aln = jax_open(stats_halz)
    leaf = [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    for fn, args in (("get_hal_genomes", ()), ("get_hal_stats", ()),
                     ("get_hal_child_names", (aln.root_name,)),
                     ("get_hal_sequences", (leaf,))):
        got = getattr(port_mp, fn)(stats_halz, *args)
        assert got == getattr(jax_mp, fn)(stats_halz, *args) and got, fn
    cmds = ["echo %d" % k for k in range(5)]
    assert port_mp.run_parallel_shell_commands(cmds, 3) == \
        jax_mp.run_parallel_shell_commands(cmds, 3) == \
        ["%d\n" % k for k in range(5)]
    with pytest.raises(RuntimeError, match="failed"):
        port_mp.run_shell_command("exit 3")


# ------------------------------------------- the assembly-hub path's copies

def _bbi_inputs(rng, n_chroms, n_runs):
    sizes = {"chr%d" % i: 50 * n_runs + 100 for i in range(n_chroms)}
    data, beds = {}, []
    for c in sizes:
        pos, runs = int(rng.integers(0, 20)), []
        for _ in range(n_runs):
            ln = int(rng.integers(1, 30))
            runs.append((pos, pos + ln, float(rng.normal())))
            beds.append((c, pos, pos + ln + int(rng.integers(0, 40)),
                         "f%d\t%d" % (len(beds), int(rng.integers(0, 1000)))))
            pos += ln + int(rng.integers(0, 15))
        data[c] = runs
    return sizes, data, beds


@pytest.mark.parametrize("multilevel", [False, True], ids=["flat", "multilevel"])
def test_bbi_writers_equal_original(tmp_path, monkeypatch, multilevel):
    """The copied bigWig and bigBed writers write the original's bytes for
    the same runs and BED lines, from the Python API and from wiggle / BED
    files; `multilevel` shrinks the blocks (as tests/test_bbi.py does) so
    that the R-tree and the chrom B+ tree need internal levels."""
    from hal_tpu.io import bbi as jax_bbi
    from hal_tpu_torch.io import bbi as port_bbi

    if multilevel:
        for mod in (jax_bbi, port_bbi):
            monkeypatch.setattr(mod, "ITEMS_PER_SLOT", 4)
            monkeypatch.setattr(mod, "BLOCK_SIZE", 4)
            monkeypatch.setattr(mod, "ZOOM_PER_SLOT", 4)
    sizes, data, beds = _bbi_inputs(np.random.default_rng(7),
                                    23 if multilevel else 3, 150)
    wig = tmp_path / "in.wig"
    wig.write_text("".join(
        "variableStep chrom=%s span=1\n" % c
        + "".join("%d %.4f\n" % (s + 1, v) for s, _e, v in runs)
        for c, runs in data.items())
        + "fixedStep chrom=chr0 start=%d step=3 span=2\n1\n2.5\n-3\n"
        % (sizes["chr0"] - 40))
    bed = tmp_path / "in.bed"
    bed.write_text("".join("%s\t%d\t%d\t%s\n" % b for b in beds[::-1]))
    for name, mod in (("jax", jax_bbi), ("port", port_bbi)):
        mod.write_bigwig(str(tmp_path / (name + ".bw")), sizes, data)
        mod.write_bigwig(str(tmp_path / (name + "_raw.bw")), sizes, data,
                         compress=False)
        mod.write_bigbed(str(tmp_path / (name + ".bb")), sizes, beds,
                         field_count=5)
        mod.wig_to_bigwig(str(wig), sizes, str(tmp_path / (name + "_wig.bw")))
        mod.bed_to_bigbed(str(bed), sizes, str(tmp_path / (name + "_bed.bb")))
    for suffix in (".bw", "_raw.bw", ".bb", "_wig.bw", "_bed.bb"):
        want = (tmp_path / ("jax" + suffix)).read_bytes()
        assert (tmp_path / ("port" + suffix)).read_bytes() == want, suffix
    if multilevel:  # the R-tree's root is an internal node
        buf = (tmp_path / "port.bw").read_bytes()
        (index,) = np.frombuffer(buf[24:32], "<u8")
        assert buf[index + 48] == 0


def test_assemblyhub_tracks_equal_original():
    """gc_percent_wig and masked_bed of every genome, and the trackDb
    writers, print the original's text."""
    from hal_tpu import assemblyhub as jax_ah
    from hal_tpu_torch import assemblyhub as port_ah

    opts = dict(FIXTURE, seed=22, max_segment_length=60)
    jaln = jax_random_alignment(**opts)
    paln = create_random_alignment(**opts)
    n = 0
    for name in jaln.genome_names():
        for fn, args in (("gc_percent_wig", ()), ("gc_percent_wig", (3,)),
                         ("masked_bed", ())):
            want, got = io.StringIO(), io.StringIO()
            getattr(jax_ah, fn)(jaln.open_genome(name), want, *args)
            getattr(port_ah, fn)(paln.open_genome(name), got, *args)
            assert got.getvalue() == want.getvalue(), (name, fn, args)
            n += bool(want.getvalue())
    assert n
    for fn, args in (("trackdb_gc", ("g", True)),
                     ("trackdb_alignability", ("g", 7, False)),
                     ("trackdb_conservation", ("g", True)),
                     ("trackdb_rmsk", ("g", False)),
                     ("trackdb_bed", ("t", "p.bb", True)),
                     ("trackdb_wig", ("t", "p.wig", False)),
                     ("trackdb_snake", ("o", "../lod.txt"))):
        want, got = io.StringIO(), io.StringIO()
        getattr(jax_ah, fn)(want, *args)
        getattr(port_ah, fn)(got, *args)
        assert got.getvalue() == want.getvalue() and want.getvalue(), fn


@pytest.mark.parametrize("opts", [{}, dict(gap_threshold=3),
                                  dict(just_subs=True), dict(do_subs=False)],
                         ids=["default", "gap3", "just_subs", "no_subs"])
def test_analyze_branch_equals_original(opts):
    """ops.rearrangement.analyze_branch: the same events, runs and
    substitution counts on every branch (the native substitution counter
    on both sides, or none with do_subs=False)."""
    from hal_tpu.ops import rearrangement as jax_rea
    from hal_tpu_torch.ops import rearrangement as port_rea

    fixture = dict(FIXTURE, seed=23, min_segments=20, max_segments=80)
    jaln = jax_random_alignment(**fixture)
    paln = create_random_alignment(**fixture)
    events = 0
    for name in jaln.genome_names():
        if jaln.tree.parent(name) is None:
            continue
        want = jax_rea.analyze_branch(jaln, name, **opts)
        got = port_rea.analyze_branch(paln, name, **opts)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        events += len(want.events)
    assert events or opts.get("just_subs")


@pytest.mark.parametrize("fn", ["genome_to_paf", "stats_row", "clean",
                                "count_block", "parse_coverage"])
def test_export_tool_functions_equal_original(tmp_path, fn):
    """The functions of the host-only export and mutation tools that take
    plain inputs: hal2paf.genome_to_paf (every child, both name modes),
    halSummarizeMutations._stats_row / _other_count (every branch),
    halIndels._clean (every window of 9 bases with N runs), mafMutations'
    count_block / _rc_keep_gaps (random gapped rows) and
    halCoverageTable.parse_coverage: equal to their originals."""
    import contextlib

    from hal_tpu.ops import rearrangement as jax_rea
    from hal_tpu.tools import hal2paf as jax_paf
    from hal_tpu.tools import halCoverageTable as jax_ct
    from hal_tpu.tools import halIndels as jax_ind
    from hal_tpu.tools import halSummarizeMutations as jax_sum
    from hal_tpu.tools import mafMutations as jax_mm
    from hal_tpu_torch.ops import rearrangement as port_rea
    from hal_tpu_torch.tools import hal2paf as port_paf
    from hal_tpu_torch.tools import halCoverageTable as port_ct
    from hal_tpu_torch.tools import halIndels as port_ind
    from hal_tpu_torch.tools import halSummarizeMutations as port_sum
    from hal_tpu_torch.tools import mafMutations as port_mm

    fixture = dict(FIXTURE, seed=23, min_segments=20, max_segments=80)
    jaln = jax_random_alignment(**fixture)
    paln = create_random_alignment(**fixture)
    for aln in (jaln, paln):
        for name in aln.genome_names():
            g = aln.open_genome(name)
            for s in range(0, g.length - 3, 97):
                g.set_dna(s, "NnN")
    children = [n for n in jaln.genome_names() if jaln.tree.parent(n)]
    rng = np.random.default_rng(4)
    if fn == "genome_to_paf":
        for name in children:
            for full in (False, True):
                want, got = io.StringIO(), io.StringIO()
                with contextlib.redirect_stderr(io.StringIO()):
                    jax_paf.genome_to_paf(want, jaln, name, full)
                    port_paf.genome_to_paf(got, paln, name, full)
                assert got.getvalue() == want.getvalue(), name
    elif fn == "stats_row":
        for name in children:
            want = jax_rea.analyze_branch(jaln, name)
            got = port_rea.analyze_branch(paln, name)
            assert port_sum._stats_row(paln, name, got) == \
                jax_sum._stats_row(jaln, name, want)
            assert port_sum._other_count(got) == jax_sum._other_count(want)
    elif fn == "clean":
        for name in jaln.genome_names():
            jg, pg = jaln.open_genome(name), paln.open_genome(name)
            flags = [(port_ind._clean(pg, lo, lo + 9),
                      jax_ind._clean(jg, lo, lo + 9))
                     for lo in range(-3, jg.length + 3, 4)]
            assert all(a == b for a, b in flags)
            assert {a for a, _ in flags} == {True, False}
    elif fn == "count_block":
        for _ in range(40):
            rows = [rng.choice(np.frombuffer(b"ACGTacgtN-", np.uint8), 30)
                    for _ in range(int(rng.integers(1, 5)))]
            assert port_mm.count_block(rows) == jax_mm.count_block(rows)
            assert np.array_equal(port_mm._rc_keep_gaps(rows[0]),
                                  jax_mm._rc_keep_gaps(rows[0]))
    else:
        path = tmp_path / "cov.txt"
        path.write_text("Genome, sites, sites\nA, 10, 1\nB , 7, 2\n"
                        "Coverage on A_seq\nA, 5, 0\nB, 3, 1\nnoise\n")
        assert port_ct.parse_coverage(str(path)) == \
            jax_ct.parse_coverage(str(path)) == \
            {"Total": {"A": 10, "B": 7}, "A_seq": {"A": 5, "B": 3}}


@pytest.mark.parametrize("scale,kw", [(2, {}), (9, {}),
                                      (9, dict(only_orthologs=True)),
                                      (4, dict(keep_sequences=True))])
def test_extract_lod_equals_original(scale, kw):
    """ops.lod.extract_lod: every array, the tree and the metadata of the
    coarse alignment equal the original's."""
    from hal_tpu.ops.lod import extract_lod as jax_lod
    from hal_tpu_torch.ops.lod import extract_lod as port_lod

    fixture = dict(FIXTURE, seed=24, min_segments=30, max_segments=90)
    want = jax_lod(jax_random_alignment(**fixture), scale, **kw)
    got = port_lod(create_random_alignment(**fixture), scale, **kw)
    _assert_same_alignment(got, want)
    assert got.metadata == want.metadata == {"lodScale": str(scale)}


def test_blockviz_queries_equal_original(tmp_path):
    """blockviz: species, chroms, DNA and get_blocks_in_target_range in
    every dupe and sequence mode equal the original's, on an alignment
    and on a LOD manifest."""
    import dataclasses as dc

    from hal_tpu import blockviz as jax_bv
    from hal_tpu.ops.lod import extract_lod as jax_lod
    from hal_tpu_torch import blockviz as port_bv

    fixture = dict(FIXTURE, seed=25, min_segments=20, max_segments=60)
    aln = jax_random_alignment(**fixture)
    hal = str(tmp_path / "aln.halz")
    jax_save(aln, hal, fmt="halz")
    jax_save(jax_lod(aln, 6), str(tmp_path / "lod6.halz"), fmt="halz")
    (tmp_path / "lod.txt").write_text("0 aln.halz\n40 lod6.halz\n")
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    t_sp = leaves[0]
    g = aln.open_genome(t_sp)
    chrom, clen = g.seq_names[0], int(g.seq_length(0))
    n_blocks = 0
    for path in (hal, str(tmp_path / "lod.txt")):
        hj, hp = jax_bv.hal_open(path), port_bv.hal_open(path)
        assert port_bv.get_genome_names(hp) == jax_bv.get_genome_names(hj)
        assert port_bv.get_chroms(hp, t_sp) == jax_bv.get_chroms(hj, t_sp)
        assert port_bv.get_dna(hp, t_sp, chrom, 1, clen - 1) == \
            jax_bv.get_dna(hj, t_sp, chrom, 1, clen - 1)
        assert port_bv.get_max_lod_query_length(hp) == \
            jax_bv.get_max_lod_query_length(hj)
        for q_sp in aln.genome_names():
            if q_sp == t_sp:
                continue
            for dup, seq, adj in ((jax_bv.HAL_NO_DUPS, jax_bv.HAL_NO_SEQUENCE,
                                   False),
                                  (jax_bv.HAL_QUERY_DUPS,
                                   jax_bv.HAL_LOD0_SEQUENCE, False),
                                  (jax_bv.HAL_QUERY_AND_TARGET_DUPS,
                                   jax_bv.HAL_FORCE_LOD0_SEQUENCE, True)):
                args = (q_sp, t_sp, chrom, 0, clen)
                kw = dict(dup_mode=dup, seq_mode=seq,
                          map_back_adjacencies=adj)
                wb, wd = jax_bv.get_blocks_in_target_range(hj, *args, **kw)
                gb, gd = port_bv.get_blocks_in_target_range(hp, *args, **kw)
                assert [dc.asdict(b) for b in gb] == \
                    [dc.asdict(b) for b in wb], (path, q_sp, dup)
                assert [dc.asdict(d) for d in gd] == \
                    [dc.asdict(d) for d in wd], (path, q_sp, dup)
                n_blocks += len(wb)
    assert n_blocks


@pytest.mark.parametrize("flags", [[], ["--subtree", "--upper",
                                        "--lineWidth", "7"],
                                   ["--ucscSequenceNames", "--start", "3",
                                    "--length", "40"]],
                         ids=["default", "subtree-upper-7", "ucsc-range"])
def test_hal2fasta_copy_equals_original(stats_halz, capsys, flags):
    """tools.hal2fasta prints the original's FASTA: the root with its
    subtree, upper-cased at a line width, and a genome-coordinate range."""
    from hal_tpu.tools import hal2fasta as jax_fa
    from hal_tpu_torch.tools import hal2fasta as port_fa

    aln = jax_open(stats_halz)
    genome = aln.root_name if "--subtree" in flags else \
        [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    capsys.readouterr()
    jax_fa.run([stats_halz, genome] + flags)
    want = capsys.readouterr().out
    port_fa.run([stats_halz, genome] + flags)
    assert capsys.readouterr().out == want and want.startswith(">")
    if "--subtree" in flags:
        assert want.count(">") == sum(
            aln.open_genome(n).num_sequences for n in aln.genome_names())
        body = "".join(x for x in want.splitlines() if not x.startswith(">"))
        assert body and body == body.upper()


def test_liftover_baseline_copy_equals_original():
    """ops.liftover_baseline: the port's library, built from
    native/liftover_baseline.cpp, gives the fragment count and checksum of
    the original's tracked native/libhalbaseline.so on every genome pair."""
    from hal_tpu.ops import liftover_baseline as jax_lb
    from hal_tpu_torch.ops import liftover_baseline as port_lb

    if not jax_lb.available():
        pytest.skip("the original's tracked native/libhalbaseline.so (a "
                    "-march=native build) does not load on this CPU")
    assert port_lb.available()
    aln = jax_random_alignment(**dict(FIXTURE, seed=26))
    pairs = _pairs(aln)
    assert pairs
    total = 0
    for src, tgt in pairs:
        lo, hi = _intervals(aln, src, 300, 5)
        want = jax_lb.CppBaseline(aln, src, tgt)
        got = port_lb.CppBaseline(aln, src, tgt)
        w = want.run(lo, hi)
        assert got.run(lo, hi) == w, (src, tgt)
        total += w[0]
        want.close()
        got.close()
    assert total
