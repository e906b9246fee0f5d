"""The port's copies of hal_tpu's host modules (hal_tpu_torch.{alignment,
genome, tree, dna, randgen, storage, io.bed, io.maf_io, io.wiggle, native,
ops.segmap_host, ops.liftover, ops.liftover_bulk, ops.column, ops.poscache,
ops.column_native, tools} and the host half of ops.column_torch) against
their originals on seeded fixtures.  Tolerance: exact equality (arrays,
trees, records and bytes)."""

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
                                  dict(no_dupes=True, max_block_len=7)],
                         ids=["default", "maxRefGap", "unique", "noDupes"])
def test_native_column_exporter_equals_original(opts):
    """ops.column_native's NativeMafExporter (export, finish, and
    export_frags from the host twin's keyed fragments) emits the original
    binding's bytes."""
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
    got = ex.export(0, ge // 2) + ex.export(ge // 2, ge) + ex.finish()
    want = jex.export(0, ge // 2) + jex.export(ge // 2, ge) + jex.finish()
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
    """The port's halStats prints the original's bytes in every mode the
    port has; the three modes whose modules are not in the port raise."""
    from hal_tpu.tools import halStats as jax_stats
    from hal_tpu_torch.tools import HalError
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
                  ["--bottomSegments", root]):
        capsys.readouterr()
        jax_stats.run([stats_halz] + flags)
        want = capsys.readouterr().out
        port_stats.run([stats_halz] + flags)
        assert capsys.readouterr().out == want, flags
        assert want or flags == ["--metaData"], flags
    for flags in (["--coverage", leaf], ["--percentID", leaf],
                  ["--allCoverage"]):
        with pytest.raises(HalError, match="not in the port"):
            port_stats.run([stats_halz] + flags)


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
