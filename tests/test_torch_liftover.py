"""The port's liftover surface (hal_tpu_torch.ops.liftover_bulk,
hal_tpu_torch.ops.liftover, hal_tpu_torch.tools.halLiftover) on the CPU:
BED text and CLI output bytes equal the JAX package's.  Tolerance: exact
byte equality."""

import ast
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hal_tpu.ops import liftover_bulk as jax_bulk
from hal_tpu.ops.liftover import Liftover as HostLiftover
from hal_tpu.randgen import create_random_alignment
from hal_tpu.storage import save_alignment
from hal_tpu_torch.tools import HalError
from hal_tpu_torch.ops import liftover_bulk as bulk
from hal_tpu_torch.ops.liftover import Liftover
from test_reference_goldens import LIFTOVER_CASES, REF, _golden, small_hal  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runs_fixture():
    """test_liftover_bulk.py's device-runs fixture: leaf pair, intervals."""
    aln = create_random_alignment(seed=27, max_genomes=7, min_genomes=5,
                                  mean_degree=1.4, min_segment_length=5,
                                  max_segment_length=30, min_segments=20,
                                  max_segments=90, store_dna=False)
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 40]
    src, tgt = leaves[0], leaves[-1]
    sg = aln.open_genome(src)
    rng = np.random.default_rng(5)
    lo = rng.integers(0, max(sg.length - 20, 1), 128).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 20, 128), sg.length)
    chroms = [sg.seq_names[int(np.searchsorted(sg.seq_start, p, side="right")) - 1]
              for p in lo]
    base = np.array([sg.seq_start[sg.sequence_index(c)] for c in chroms])
    strands = rng.choice(np.array(["+", "-", "."]), len(lo))
    return aln, src, tgt, chroms, lo - base, hi - base, lo, hi, strands


def test_bulk_liftover_bed3_equals_jax():
    aln, src, tgt, chroms, starts, ends, lo, hi, strands = _runs_fixture()
    for st_ in (None, strands):
        want = jax_bulk.bulk_liftover_bed3(aln, src, tgt, chroms, starts,
                                           ends, strands=st_, use_device=True)
        got = bulk.bulk_liftover_bed3(aln, src, tgt, chroms, starts, ends,
                                      strands=st_, device="cpu")
        assert got == want and got
        host = bulk.bulk_liftover_bed3(aln, src, tgt, chroms, starts, ends,
                                       strands=st_, use_device=False,
                                       device="cpu")
        assert host == want
    out = io.StringIO()
    bulk.bulk_liftover_bed3(aln, src, tgt, chroms, starts, ends, out=out,
                            device="cpu")
    assert out.getvalue() == jax_bulk.bulk_liftover_bed3(
        aln, src, tgt, chroms, starts, ends, use_device=True)


def test_bulk_runs_and_map_equal_jax():
    aln, src, tgt, _c, _s, _e, lo, hi, _st = _runs_fixture()
    tg = aln.open_genome(tgt)
    got = bulk.bulk_runs_device(aln, src, tgt, lo, hi, tg, device="cpu")
    want = jax_bulk.bulk_runs_device(aln, src, tgt, lo, hi, tg)
    assert got is not None and want is not None
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want))
    # intervals past 255 bp do not fit the wire on either package
    assert bulk.bulk_runs_device(aln, src, tgt, lo[:1], lo[:1] + 300, tg,
                                 device="cpu") is None
    got = bulk.bulk_map(aln, src, tgt, lo, hi, device="cpu")
    want = jax_bulk.bulk_map(aln, src, tgt, lo, hi, use_device=True)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_bulk_per_line_fixture_equals_jax():
    """test_liftover_bulk.py::test_bulk_device_equals_per_line's fixture."""
    aln = create_random_alignment(seed=3, max_genomes=5, min_segments=5,
                                  max_segments=25, min_segment_length=4,
                                  max_segment_length=12)
    names = aln.genome_names()
    leaves = [n for n in names if aln.tree.is_leaf(n)]
    src = leaves[0]
    tgt = leaves[-1] if leaves[-1] != src else names[-1]
    g = aln.open_genome(src)
    starts = list(range(0, g.seq_length(0) - 12, 17))[:15]
    ends = [s + 10 for s in starts]
    chroms = [g.seq_names[0]] * len(starts)
    assert starts
    want = jax_bulk.bulk_liftover_bed3(aln, src, tgt, chroms, starts, ends,
                                       use_device=True)
    assert bulk.bulk_liftover_bed3(aln, src, tgt, chroms, starts, ends,
                                   device="cpu") == want


def _bed_lines(aln, src, n, seed, bed6=False):
    g = aln.open_genome(src)
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        k = int(rng.integers(0, g.num_sequences))
        slen = g.seq_length(k)
        a = int(rng.integers(0, max(slen - 10, 1)))
        b = min(a + int(rng.integers(1, 12)), slen)
        if bed6:
            lines.append("%s\t%d\t%d\tn%d\t0\t%s\n"
                         % (g.seq_names[k], a, b, len(lines), "+-."[a % 3]))
        else:
            lines.append("%s\t%d\t%d\n" % (g.seq_names[k], a, b))
    return "".join(lines)


@pytest.mark.parametrize("opts", [{}, dict(traverse_dupes=False),
                                  dict(coalescence_limit="root"),
                                  dict(out_psl=True)],
                         ids=["default", "noDupes", "coalescence", "psl"])
def test_convert_batched_bytes_equal_convert(opts):
    """convert_batched on the torch BatchMapper (dispatch k+1 before
    decoding k) emits convert()'s bytes across many chunks."""
    aln = create_random_alignment(seed=5, max_genomes=8, min_genomes=6,
                                  mean_degree=1.4, min_segments=10,
                                  max_segments=40, min_segment_length=4,
                                  max_segment_length=12)
    names = aln.genome_names()
    leaves = [n for n in names if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    if opts.get("coalescence_limit") == "root":
        src, tgt = next((s, t) for s in names for t in names
                        if s != t and aln.tree.lca(s, t) != aln.root_name)
        opts = dict(coalescence_limit=aln.root_name)
    bed = _bed_lines(aln, src, 300, 2, bed6=True)
    o1, o2 = io.StringIO(), io.StringIO()
    HostLiftover(aln, src, tgt, **opts).convert(io.StringIO(bed), o1)
    Liftover(aln, src, tgt, device="cpu", **opts).convert_batched(
        io.StringIO(bed), o2, batch_size=64)
    assert o2.getvalue() == o1.getvalue() and o1.getvalue()


@pytest.mark.parametrize("opts", [{}, dict(traverse_dupes=False),
                                  dict(coalescence_limit="root"),
                                  dict(out_psl=True)],
                         ids=["default", "noDupes", "coalescence", "psl"])
@pytest.mark.parametrize("kind", ["bed6", "bed12"])
def test_convert_batched_maps_nothing_on_the_host(monkeypatch, opts, kind):
    """convert_batched with the port's segmap_host.map_source refused:
    every interval a line lifts (a BED12 line's blocks too) comes from the
    batched mapper's cache, and the bytes equal hal_tpu's per-line
    convert."""
    from hal_tpu_torch.ops import segmap_host as port_sm

    aln = create_random_alignment(seed=5, max_genomes=8, min_genomes=6,
                                  mean_degree=1.4, min_segments=10,
                                  max_segments=40, min_segment_length=4,
                                  max_segment_length=12)
    names = aln.genome_names()
    leaves = [n for n in names if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    if opts.get("coalescence_limit") == "root":
        src, tgt = next((s, t) for s in names for t in names
                        if s != t and aln.tree.lca(s, t) != aln.root_name)
        opts = dict(coalescence_limit=aln.root_name)
    bed = (_bed_lines(aln, src, 200, 3, bed6=True) if kind == "bed6"
           else _bed12_lines(aln, src, 200, 8))
    want = io.StringIO()
    HostLiftover(aln, src, tgt, **opts).convert(io.StringIO(bed), want)

    def refuse(*a, **k):
        raise AssertionError("host map_source called")

    monkeypatch.setattr(port_sm, "map_source", refuse)
    got = io.StringIO()
    Liftover(aln, src, tgt, device="cpu", **opts).convert_batched(
        io.StringIO(bed), got, batch_size=64)
    assert got.getvalue() == want.getvalue() and want.getvalue()


@pytest.mark.parametrize("out_psl", [False, True], ids=["bed", "psl"])
def test_convert_batched_coalescence_deep_chain_equals_convert(out_psl):
    """--coalescenceLimit at the root where the chain from the MRCA to it
    holds three genomes or more (a four-level tree): convert_batched's
    paralogy branches bring paralogs down without rings, as map_source
    does, so its bytes equal hal_tpu's per-line convert for every such
    pair (segmap_jax's branches, which ring-expand at every down hop, add
    fragments there)."""
    aln = create_random_alignment(seed=3, max_genomes=8, min_segments=30,
                                  max_segments=80)
    names, root = aln.genome_names(), aln.root_name
    pairs = [(s, t) for s in names for t in names if s != t
             and len(aln.tree.path(aln.tree.lca(s, t), root)) >= 3]
    assert len(pairs) >= 10
    for src, tgt in pairs:
        bed = _bed_lines(aln, src, 120, 2, bed6=True)
        want, got = io.StringIO(), io.StringIO()
        HostLiftover(aln, src, tgt, coalescence_limit=root,
                     out_psl=out_psl).convert(io.StringIO(bed), want)
        Liftover(aln, src, tgt, device="cpu", coalescence_limit=root,
                 out_psl=out_psl).convert_batched(io.StringIO(bed), got,
                                                  batch_size=64)
        assert got.getvalue() == want.getvalue() and want.getvalue(), \
            (src, tgt)


def test_batched_cache_miss_raises():
    """While the batched fragment cache is set, a line whose interval the
    batch did not map raises RuntimeError naming the interval; nothing is
    mapped on the host behind it."""
    from hal_tpu_torch.io.bed import read_bed

    aln = create_random_alignment(seed=5, max_genomes=8, min_genomes=6,
                                  mean_degree=1.4, min_segments=10,
                                  max_segments=40, min_segment_length=4,
                                  max_segment_length=12)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    text = _bed_lines(aln, src, 6, 3, bed6=True)
    lifter = Liftover(aln, src, tgt, device="cpu")
    lifter.map_lines(read_bed(io.StringIO(text[:text.index("\n") + 1])))
    first, second = list(read_bed(io.StringIO(text)))[:2]
    assert lifter.visit_line(first) is not None
    with pytest.raises(RuntimeError, match="%s:%d-%d of %s was not mapped"
                       % (second.chrom, second.start, second.end, src)):
        lifter.visit_line(second)


@pytest.fixture(scope="module")
def halz_fixture(tmp_path_factory):
    aln = create_random_alignment(seed=9, max_genomes=7, min_genomes=5,
                                  mean_degree=1.4, min_segments=10,
                                  max_segments=60, min_segment_length=4,
                                  max_segment_length=20)
    d = tmp_path_factory.mktemp("port_cli")
    path = str(d / "aln.halz")
    save_alignment(aln, path, fmt="halz")
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    bed = d / "in.bed"
    bed.write_text(_bed_lines(aln, leaves[0], 400, 4))
    return path, leaves[0], str(bed), leaves[-1], d


@pytest.mark.parametrize("flags", [[], ["--noDupes"], ["--outPSL"]],
                         ids=["bed", "noDupes", "psl"])
def test_cli_device_cpu_bytes_equal_host(halz_fixture, flags):
    from hal_tpu.tools import halLiftover as host_cli
    from hal_tpu_torch.tools import halLiftover as port_cli

    hal, src, bed, tgt, d = halz_fixture
    name = "_".join(flags) or "bed"
    host_out = str(d / ("host_%s.out" % name))
    port_out = str(d / ("port_%s.out" % name))
    host_cli.run(flags + [hal, src, bed, tgt, host_out])
    port_cli.run(flags + ["--device", "cpu", "--batchSize", "128",
                          hal, src, bed, tgt, port_out])
    want = open(host_out, "rb").read()
    assert want and open(port_out, "rb").read() == want


def _bed12_lines(aln, src, n, seed):
    """BED12 lines of 1-3 blocks over the source's sequences."""
    g = aln.open_genome(src)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        k = int(rng.integers(0, g.num_sequences))
        slen = g.seq_length(k)
        nb = int(rng.integers(1, 4))
        sizes = rng.integers(1, 8, nb)
        gaps = rng.integers(0, 6, nb)
        starts = np.concatenate([[0], np.cumsum(sizes + gaps)[:-1]])
        span = int(starts[-1] + sizes[-1])
        if slen <= span + 1:
            continue
        a = int(rng.integers(0, slen - span))
        lines.append("%s\t%d\t%d\tb%d\t0\t%s\t%d\t%d\t0\t%d\t%s,\t%s,\n"
                     % (g.seq_names[k], a, a + span, i, "+-"[i % 2], a,
                        a + span, nb, ",".join(map(str, sizes)),
                        ",".join(map(str, starts))))
    return "".join(lines)


@pytest.mark.parametrize("kind,flags", [("bed3", []), ("bed12", []),
                                        ("bed3", ["--noDupes"]),
                                        ("bed12", ["--outPSL"]),
                                        ("bed3", ["--batchSize", "0"])],
                         ids=["bed3", "bed12", "noDupes", "psl", "batch0"])
def test_cli_default_maps_batched_bytes_equal_host(halz_fixture, monkeypatch,
                                                   kind, flags):
    """A default run of the port's CLI (no --batchSize) maps through the
    batched torch mapper, never the per-line host mapper, and its bytes
    equal hal_tpu's default (per-line) run."""
    from hal_tpu.tools import halLiftover as host_cli
    from hal_tpu_torch.ops import liftover as port_liftover
    from hal_tpu_torch.tools import halLiftover as port_cli

    hal, src, bed, tgt, d = halz_fixture
    if kind == "bed12":
        from hal_tpu_torch.storage import open_alignment

        bed = str(d / "in12.bed")
        with open(bed, "w") as f:
            f.write(_bed12_lines(open_alignment(hal), src, 200, 6))
    name = kind + "_".join(flags)
    host_out = str(d / ("host_default_%s.out" % name))
    port_out = str(d / ("port_default_%s.out" % name))
    host_cli.run([f for f in flags if f not in ("--batchSize", "0")]
                 + [hal, src, bed, tgt, host_out])

    def per_line(*a, **k):
        raise AssertionError("the default run mapped per line")

    monkeypatch.setattr(port_liftover.Liftover, "convert", per_line)
    port_cli.run(flags + ["--device", "cpu", hal, src, bed, tgt, port_out])
    want = open(host_out, "rb").read()
    assert want and open(port_out, "rb").read() == want


def test_cli_coalescence_limit_below_mrca_maps_per_line(halz_fixture, capsys):
    """--coalescenceLimit naming a genome that is not an ancestor of the
    MRCA is the one flag the batched mapper cannot serve: one stderr line,
    per-line mapping, the original's bytes (under --noDupes, where the
    per-line mapper skips the paralogy climb that the limit would stop)."""
    from hal_tpu.tools import halLiftover as host_cli
    from hal_tpu_torch.storage import open_alignment
    from hal_tpu_torch.tools import halLiftover as port_cli

    hal, src, bed, tgt, d = halz_fixture
    tree = open_alignment(hal).tree
    limit = next(n for n in tree.names()
                 if n not in tree.path_to_root(tree.lca(src, tgt)))
    flags = ["--noDupes", "--coalescenceLimit", limit]
    host_out, port_out = str(d / "host_coal.out"), str(d / "port_coal.out")
    host_cli.run(flags + [hal, src, bed, tgt, host_out])
    capsys.readouterr()
    port_cli.run(flags + ["--device", "cpu", hal, src, bed, tgt, port_out])
    err = capsys.readouterr().err
    assert err.count("--coalescenceLimit") == 1 and "per line" in err
    want = open(host_out, "rb").read()
    assert want and open(port_out, "rb").read() == want


def test_cli_device_cuda_without_card_raises(halz_fixture, monkeypatch,
                                             capsys):
    from hal_tpu_torch.tools import halLiftover as port_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hal, src, bed, tgt, d = halz_fixture
    argv = [hal, src, bed, tgt, str(d / "never.out")]
    with pytest.raises(HalError, match="no CUDA device"):
        port_cli.run(argv)
    assert port_cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (d / "never.out").exists()


@pytest.fixture
def golden_hal(request):
    if not os.path.isdir(REF):
        pytest.skip("reference checkout not available")
    return request.getfixturevalue("small_hal")


@pytest.mark.parametrize("golden,bed,flags", LIFTOVER_CASES[:4],
                         ids=[c[0] + "-torch" for c in LIFTOVER_CASES[:4]])
def test_halLiftover_goldens_torch(golden_hal, tmp_path, golden, bed, flags):
    """The port's CLI on --device cpu --batchSize 512 is byte-equal to the
    reference's liftover goldens (as test_reference_goldens.py checks the
    JAX package)."""
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "hal_tpu_torch.tools.halLiftover", "--device",
         "cpu", "--batchSize", "512"] + flags +
        [golden_hal, "Genome_0", REF + "/liftover/tests/input/" + bed,
         "Genome_2", str(out)], cwd=REPO, capture_output=True, timeout=900)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert out.read_bytes() == _golden(REF + "/liftover/tests/expected/" + golden)


def test_port_imports_no_jax():
    """Every hal_tpu_torch module — the depth and column engines, the
    phyloP fit, the sharded steps, remote storage, their CLIs, benchOverlap,
    the assembly-hub path's tools and host copies, the analysis tools, their
    copies, the region, SNP, export and mutation tools, the editing, import
    and generation tools and the tool dispatcher included —
    imports without jax or any module of the JAX package (hal_tpu,
    hal_tpu.*) entering the process: the port keeps its own copies of the
    host code it needs."""
    code = ("import sys, pkgutil, importlib, hal_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "hal_tpu_torch.__path__, 'hal_tpu_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "assert len(mods) >= 20, mods\n"
            "need = {'hal_tpu_torch.' + m for m in ("
            "'ops.depth ops.column_torch ops.column ops.column_native "
            "ops.poscache ops._native_build io.maf_io io.wiggle native "
            "tools.hal2maf tools.halAlignmentDepth "
            "tools.halWiggleLiftover phylop phylop_torch ops.phylop_fit "
            "parallel.mp tools.halStats tools.halPhyloP tools.halPhyloPMP "
            "tools.halTreePhyloP tools.halPctId tools.halCoverage "
            "parallel.mesh parallel.sharded parallel.ring_sharded "
            "parallel.distributed graft_entry tools.benchScaling "
            "storage.remote tools.benchOverlap io.bbi assemblyhub "
            "tools.hal2fasta ops.rearrangement ops.lod tools.halLodExtract "
            "tools.halLodInterpolate tools.hal2assemblyHub "
            "tools.halGenerateComparisonHub blockviz tools.blockVizTest "
            "tools.blockVizBenchmark tools.halLodBenchmark tools.hal2mafMP "
            "ops.liftover_baseline __main__ analysis analysis.intervals "
            "analysis.turnover_model analysis.neutral_indel ops.validate "
            "randgen_exact tools.halValidate tools.halLiftoverStatus "
            "tools.halSynteny tools.syntenyRates tools.halAlignedExtract "
            "tools.halMaskExtract tools.halBranchMutations "
            "tools.halTreeMutations tools.halTreeNIBackground "
            "tools.halTreeNIConservation tools.estimateTurnoverParams "
            "tools.halTreeNITurnover tools.runDotplot tools._regions "
            "tools.findRegionsExclusivelyInGroup "
            "tools.halSingleCopyRegionsExtract tools.hal4dExtract "
            "tools.halSnps tools.halContiguousRegions tools.hal2chain "
            "tools.hal2paf tools.halCoverageTable "
            "tools.halSummarizeMutations tools.mafMutations "
            "tools.halIndels tools.getInsertionStats tools._modify_common "
            "tools.halAddToBranch tools.halAppendSubtree "
            "tools.halRemoveGenome tools.halRemoveSubtree "
            "tools.halRenameGenomes tools.halRenameSequences "
            "tools.halReplaceGenome tools.halSetMetadata "
            "tools.halUpdateBranchLengths tools.halWriteNucleotides "
            "tools.halExtract tools.maf2hal tools.halTestGen "
            "tools.halRandGen tools.ancestorsML tools.ancestorsMLMP "
            "tools.halPhyloPTrain tools.benchMark "
            "tools.runAndGetResources').split()}\n"
            "assert need <= set(mods), need - set(mods)\n"
            "bad = [k for k in sys.modules if k in ('jax', 'hal_tpu')"
            " or k.startswith(('jax.', 'hal_tpu.'))]\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.strip()) >= 20


def test_port_strings_name_no_jax_module():
    """No string in hal_tpu_torch/ (docstrings aside) names a module of the
    JAX package, as an import path or a `-m` target: a job the port starts
    cannot run the JAX package's tools."""
    pattern = re.compile(r"\bhal_tpu\.[A-Za-z_]|-m\s+hal_tpu\b(?!_)")
    root = os.path.join(REPO, "hal_tpu_torch")
    seen = bad = 0
    for dp, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dp, f)).read())
            docs = {id(n.body[0].value) for n in ast.walk(tree)
                    if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and n.body and isinstance(n.body[0], ast.Expr)
                    and isinstance(n.body[0].value, ast.Constant)}
            for n in ast.walk(tree):
                if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                        and id(n) not in docs:
                    seen += 1
                    if pattern.search(n.value):
                        bad += 1
                        print(os.path.relpath(os.path.join(dp, f), REPO),
                              n.lineno, n.value)
    assert seen > 1000 and bad == 0
    assert pattern.search("python -m hal_tpu.tools.halStats")
    assert pattern.search("%s -m hal_tpu --help")
    assert not pattern.search("-m hal_tpu_torch.tools.halStats")
    assert not pattern.search("by hal_tpu hal2assemblyHub from")


def _names_hal_tpu(text: str) -> bool:
    """True where text names the JAX package (hal_tpu as a module or path
    word, not hal_tpu_torch)."""
    return re.search(r"\bhal_tpu\b", text) is not None


def test_chip_smoke_imports_and_runs_no_hal_tpu():
    """chip_smoke.py neither imports hal_tpu nor jax, nor names hal_tpu in
    the arguments of any subprocess it starts (read with ast); it imports
    the port's depth and column engines, remote storage, the phyloP CLI,
    the editing tools and the other CLIs, and runs the port's
    benchOverlap."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    assert "torch" in imported and "hal_tpu_torch.ops" in imported
    # phases 5-6 drive the depth and column engines and their CLIs, phase
    # 6b the CLIs on remote alignments and benchOverlap
    for mod in ("hal_tpu_torch.ops.column_torch",
                "hal_tpu_torch.ops.column_native", "hal_tpu_torch.tools",
                "hal_tpu_torch.storage.remote"):
        assert mod in imported, mod
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             for a in n.names}
    assert {"depth", "halAlignmentDepth", "halWiggleLiftover", "hal2maf",
            "_native_build", "halPhyloP", "ancestorsML", "maf2hal",
            "halAppendSubtree"} <= names, names
    assert not [m for m in imported
                if m.split(".")[0] in ("hal_tpu", "jax")], imported
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and isinstance(n.func.value, ast.Name)
             and n.func.value.id == "subprocess"]
    assert calls
    assert "hal_tpu_torch.tools.benchOverlap" in {
        c.value for call in calls for c in ast.walk(call)
        if isinstance(c, ast.Constant)}
    for call in calls:
        for arg in list(call.args) + [k.value for k in call.keywords]:
            for c in ast.walk(arg):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    assert not _names_hal_tpu(c.value), c.value
    assert _names_hal_tpu("python -m hal_tpu.tools.halLiftover")
    assert not _names_hal_tpu("python -m hal_tpu_torch.tools.halLiftover")
