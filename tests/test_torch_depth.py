"""The port's alignment-depth engine (hal_tpu_torch.ops.depth) and its
halAlignmentDepth / halWiggleLiftover CLIs on the CPU, held against the JAX
package on the same seeded inputs.  Tolerance: exact equality (counts, RLE
runs, mean depth as float64, CLI bytes)."""

import io

import numpy as np
import pytest
import torch

from hal_tpu.ops import depth as jax_depth
from hal_tpu.ops.column import compute_scope as jax_scope
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.storage import save_alignment
from hal_tpu_torch.ops import depth
from hal_tpu_torch.ops.column import compute_scope
from hal_tpu_torch.randgen import create_random_alignment
from hal_tpu_torch.tools import HalError

# tests/test_depth_snps.py::test_depth_device_matches_host's fixture
FIXTURE = dict(seed=11, max_genomes=6, min_genomes=5, min_segments=4,
               max_segments=24, min_segment_length=3, max_segment_length=9)


@pytest.fixture(scope="module")
def alns():
    return create_random_alignment(**FIXTURE), jax_random_alignment(**FIXTURE)


def _scopes(port, ref_aln, ref):
    """(scope, scope root) from both packages' compute_scope: the whole
    tree (its root lies above the MRCA of the reference and most genomes)
    and the spanning tree of the reference and two other leaves."""
    leaves = [n for n in port.genome_names() if port.tree.is_leaf(n)]
    out = []
    for targets in (None, leaves[-2:]):
        got = compute_scope(port, ref, targets)
        assert got == jax_scope(ref_aln, ref, targets)
        out.append(got)
    return out


@pytest.mark.parametrize("count_dupes", [False, True], ids=["unique", "dupes"])
@pytest.mark.parametrize("window", [(0, 160), (37, 151)],
                         ids=["from0", "offset"])
def test_depth_engine_equals_jax(alns, count_dupes, window):
    """run / run_runs / run_device_only of the port's DepthEngine equal the
    JAX package's on the seed-11 fixture, for a scope whose root lies
    above the MRCA and a spanning-tree scope, both count modes."""
    port, ref_aln = alns
    ref = [n for n in port.genome_names() if port.tree.is_leaf(n)][0]
    gs, ge = window
    ge = min(ge, int(port.open_genome(ref).length))
    for scope, root in _scopes(port, ref_aln, ref):
        eng = depth.DepthEngine(port, ref, gs, ge, scope, root,
                                count_dupes=count_dupes, device="cpu")
        want_eng = jax_depth.DepthEngine(ref_aln, ref, gs, ge, scope, root,
                                         count_dupes=count_dupes)
        counts, cols = eng.run()
        want, want_cols = want_eng.run()
        assert cols == want_cols == ge - gs
        assert counts.dtype == want.dtype and np.array_equal(counts, want)
        assert np.array_equal(counts, jax_depth.depth_counts(
            ref_aln, ref, gs, ge, scope, root, count_dupes))
        starts, vals, w = eng.run_runs()
        ws, wv, ww = want_eng.run_runs()
        assert w == ww and np.array_equal(starts, ws) and np.array_equal(vals, wv)
        mean, cols2, dev = eng.run_device_only()
        wmean, _c, wdev = want_eng.run_device_only()
        assert cols2 == cols and mean == wmean
        assert np.array_equal(dev.numpy(), np.asarray(wdev))
        got, cols3 = depth.depth_counts_device(port, ref, gs, ge, scope, root,
                                               count_dupes, device="cpu")
        assert cols3 == cols and np.array_equal(got, want)


def test_depth_engines_build_each_ring_csr_once(monkeypatch):
    """DepthEngines over two windows of one alignment, with a scope root
    above the MRCA (paralogy branches): the sizer and every path's down
    levels, main and branch, read one ring CSR a genome, built once; the
    counts equal the JAX package's."""
    from test_torch_column import count_ring_builds

    port = create_random_alignment(**FIXTURE)
    ref_aln = jax_random_alignment(**FIXTURE)
    ref = [n for n in port.genome_names() if port.tree.is_leaf(n)][0]
    scope, root = compute_scope(port, ref)
    assert any(port.tree.lca(ref, g) != root for g in scope)
    built = count_ring_builds(monkeypatch, port)
    ge = int(port.open_genome(ref).length)
    for gs, we in ((0, ge // 2), (ge // 2, ge)):
        got = depth.DepthEngine(port, ref, gs, we, scope, root,
                                device="cpu").run()[0]
        want = jax_depth.DepthEngine(ref_aln, ref, gs, we, scope,
                                     root).run()[0]
        assert np.array_equal(got, want)
    assert built and sorted(built) == sorted(set(built))


def test_depth_engine_no_ancestors_equals_jax(alns):
    port, ref_aln = alns
    ref = [n for n in port.genome_names() if port.tree.is_leaf(n)][-1]
    ge = min(int(port.open_genome(ref).length), 200)
    scope, root = compute_scope(port, ref)
    for dupes in (False, True):
        got = depth.DepthEngine(port, ref, 0, ge, scope, root, dupes, True,
                                device="cpu").run()[0]
        want = jax_depth.DepthEngine(ref_aln, ref, 0, ge, scope, root, dupes,
                                     True).run()[0]
        assert np.array_equal(got, want)


def _runs_vectors():
    rng = np.random.default_rng(7)
    out = []
    for n in (1, 2, 17, 1000, 70000):
        lengths = rng.integers(1, 40, n)
        vals = rng.integers(-3, 6, n).astype(np.int32)
        out.append(np.repeat(vals, lengths)[:n])
    out.append(np.full(300, 5, np.int32))
    return out


def test_rle_encode_device_equals_jax():
    """Runs of seeded vectors (equal neighbouring values included, a vector
    of one run, one of length 1) equal the JAX package's; the empty vector,
    on which the JAX package fails, gives empty arrays."""
    for x in _runs_vectors():
        got = depth.rle_encode_device(torch.from_numpy(x))
        want = jax_depth.rle_encode_device(jax_depth_array(x))
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want)), len(x)
        assert np.array_equal(depth.rle_decode(*got, len(x)), x)
    s, v = depth.rle_encode_device(torch.zeros(0, dtype=torch.int32))
    assert s.dtype == v.dtype == np.int64 and len(s) == len(v) == 0


def jax_depth_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_rle_pack_overflow(monkeypatch):
    """_pack flags a wire too small for the runs, and rle_encode_device
    raises instead of returning a truncated wire."""
    x = torch.from_numpy(_runs_vectors()[3])
    k = int(depth._n_runs(x))
    wire, total, ovf = depth._pack(x, k - 1)
    assert int(total) == k and bool(ovf) and wire.shape == (2, k - 1)
    wire, total, ovf = depth._pack(x, k)
    assert not bool(ovf)
    monkeypatch.setattr(depth.tables, "_bucket_cap", lambda n: n - 1)
    with pytest.raises(RuntimeError, match="overflow"):
        depth.rle_encode_device(x)


def test_spare_index_drops_into_the_spare_region():
    from hal_tpu_torch.ops import segmap_torch as st

    keep = torch.tensor([True, False, True, False, False])
    idx = torch.tensor([3, 9, 0, 9, 9], dtype=torch.int32)
    got = st.spare_index(keep, idx, 10)
    assert got.dtype == torch.int64
    assert got.tolist() == [3, 11, 0, 13, 14]
    assert st.spare_width(5) == 8 and st.spare_width(1 << 30) == st.SPARE


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def halz(tmp_path_factory):
    aln = jax_random_alignment(seed=9, max_genomes=7, min_genomes=5,
                               mean_degree=1.4, min_segments=10,
                               max_segments=60, min_segment_length=4,
                               max_segment_length=20)
    d = tmp_path_factory.mktemp("port_depth_cli")
    path = str(d / "aln.halz")
    save_alignment(aln, path, fmt="halz")
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    return path, aln, leaves, d


@pytest.mark.parametrize("flags", [[], ["--countDupes"], ["--step", "3"],
                                   ["--noAncestors"], ["--targets"],
                                   ["--start", "5", "--length", "70"]],
                         ids=["default", "countDupes", "step", "noAncestors",
                              "targets", "range"])
def test_halAlignmentDepth_cli_equals_jax(halz, flags):
    """--device cpu bytes equal hal_tpu's halAlignmentDepth, with and
    without its --device engine."""
    from hal_tpu.tools import halAlignmentDepth as jax_cli
    from hal_tpu_torch.tools import halAlignmentDepth as port_cli

    path, _aln, leaves, d = halz
    if flags == ["--targets"]:
        flags = ["--targetGenomes", ",".join(leaves[1:3])]
    name = "_".join(f.strip("-") for f in flags) or "default"
    outs = {}
    for who, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                            ("jax_dev", jax_cli, ["--device"]),
                            ("jax_host", jax_cli, [])):
        out = str(d / ("depth_%s_%s.wig" % (name, who)))
        cli.run([path, leaves[0], "--outWiggle", out] + flags + extra)
        outs[who] = open(out, "rb").read()
    assert outs["port"] and outs["port"] == outs["jax_dev"] == outs["jax_host"]


def _wiggle_text(aln, genome, seed):
    """fixedStep and variableStep blocks (span 1 and 2) over the genome's
    sequences, values from a seeded generator."""
    g = aln.open_genome(genome)
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(g.num_sequences):
        slen = g.seq_length(k)
        if slen < 12:
            continue
        a = int(rng.integers(0, slen // 3))
        n = int(rng.integers(5, slen - a))
        lines.append("fixedStep chrom=%s start=%d step=1"
                     % (g.seq_names[k], a + 1))
        lines += ["%g" % v for v in np.round(rng.normal(size=n), 3)]
        pos = np.sort(rng.choice(slen - 2, min(15, slen - 2), replace=False))
        lines.append("variableStep chrom=%s span=2" % g.seq_names[k])
        lines += ["%d %g" % (p + 1, v)
                  for p, v in zip(pos, np.round(rng.random(len(pos)), 2))]
    lines.append("fixedStep chrom=noSuchSeq start=1 step=1")
    lines.append("1")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("flags", [[], ["--noDupes"]], ids=["default", "noDupes"])
def test_halWiggleLiftover_cli_equals_jax(halz, flags, capsys):
    """The port's --device cpu bytes equal hal_tpu's halWiggleLiftover,
    leaf to leaf and leaf to root, at the default --batchSize, at 4 runs a
    call (a block's runs split over several calls) and at 0 (a whole block
    per call)."""
    from hal_tpu.tools import halWiggleLiftover as jax_cli
    from hal_tpu_torch.tools import halWiggleLiftover as port_cli

    path, aln, leaves, d = halz
    wig = d / "in.wig"
    wig.write_text(_wiggle_text(aln, leaves[0], 3))
    name = "_".join(f.strip("-") for f in flags) or "default"
    for tgt in (leaves[-1], aln.root_name):
        outs = []
        for k, (cli, extra) in enumerate((
                (jax_cli, []),
                (port_cli, ["--device", "cpu"]),
                (port_cli, ["--device", "cpu", "--batchSize", "4"]),
                (port_cli, ["--device", "cpu", "--batchSize", "0"]))):
            out = str(d / ("wig_%s_%s_%d.wig" % (name, tgt, k)))
            cli.run(flags + extra + [path, leaves[0], str(wig), tgt, out])
            outs.append(open(out, "rb").read())
        assert outs[0] and outs[1:] == [outs[0]] * 3, tgt
    assert "noSuchSeq" in capsys.readouterr().err


@pytest.mark.parametrize("tool", ["halAlignmentDepth", "halWiggleLiftover",
                                  "hal2maf"])
def test_cli_device_cuda_without_card_raises(halz, tool, monkeypatch, capsys):
    """The new CLIs default to --device cuda and raise without a card; no
    output is written."""
    import importlib

    cli = importlib.import_module("hal_tpu_torch.tools." + tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _aln, leaves, d = halz
    out = d / ("never_%s.out" % tool)
    argv = {"halAlignmentDepth": [path, leaves[0], "--outWiggle", str(out)],
            "halWiggleLiftover": [path, leaves[0], str(d / "in.wig"),
                                  leaves[1], str(out)],
            "hal2maf": [path, str(out)]}[tool]
    with pytest.raises(HalError, match="no CUDA device"):
        cli.run(argv)
    assert cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_depth_host_copies_equal_original():
    """The host half of ops.depth (depth_counts, rle_decode, write_wiggle,
    write_wiggle_runs) equals the original's."""
    port = create_random_alignment(**FIXTURE)
    ref_aln = jax_random_alignment(**FIXTURE)
    ref = [n for n in port.genome_names() if port.tree.is_leaf(n)][0]
    scope, root = compute_scope(port, ref)
    ge = min(int(port.open_genome(ref).length), 120)
    for dupes in (False, True):
        got = depth.depth_counts(port, ref, 3, ge, scope, root, dupes)
        want = jax_depth.depth_counts(ref_aln, ref, 3, ge, scope, root, dupes)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    rng = np.random.default_rng(4)
    vals = np.repeat(rng.integers(-1, 5, 30), rng.integers(1, 6, 30))
    starts = np.flatnonzero(np.concatenate([[True], vals[1:] != vals[:-1]]))
    assert np.array_equal(depth.rle_decode(starts, vals[starts], len(vals)),
                          jax_depth.rle_decode(starts, vals[starts], len(vals)))
    for step in (1, 3):
        for fn, args in ((("write_wiggle"), ("s", 4, vals, step)),
                         (("write_wiggle_runs"),
                          ("s", 4, starts, vals[starts], len(vals), step))):
            a, b = io.StringIO(), io.StringIO()
            getattr(depth, fn)(a, *args)
            getattr(jax_depth, fn)(b, *args)
            assert a.getvalue() == b.getvalue() and a.getvalue()
