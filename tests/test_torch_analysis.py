"""The port's comparative-analysis family on the CPU, held to the JAX
package on seeded fixtures: the copies (analysis.intervals,
analysis.turnover_model, analysis.neutral_indel's host functions,
ops.validate, randgen_exact) against their originals; the batched
Liftover.visit_lines_batched / map_lines against per-line visit_line; and
every ported CLI (halValidate, halSynteny, halLiftoverStatus,
syntenyRates, halAlignedExtract, halMaskExtract, halBranchMutations, the
neutral-indel pipeline halTreeMutations -> halTreeNIBackground ->
halTreeNIConservation -> halTreeNITurnover -> estimateTurnoverParams,
runDotplot) with --device cpu where it has the flag, its out files,
stdout and stderr byte-equal to hal_tpu's CLI on the same inputs.
Tolerance: exact equality throughout."""

import contextlib
import copy
import io
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from hal_tpu.analysis import intervals as jax_iv
from hal_tpu.analysis import neutral_indel as jax_ni
from hal_tpu.analysis import turnover_model as jax_tm
from hal_tpu.io.bed import read_bed as jax_read_bed
from hal_tpu.ops import liftover as jax_liftover
from hal_tpu.ops import validate as jax_validate
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.randgen_exact import \
    create_preset_alignment_exact as jax_preset_exact
from hal_tpu.storage import save_alignment as jax_save
from hal_tpu_torch.analysis import intervals as port_iv
from hal_tpu_torch.analysis import neutral_indel as port_ni
from hal_tpu_torch.analysis import turnover_model as port_tm
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.io.bed import read_bed
from hal_tpu_torch.ops import validate as port_validate
from hal_tpu_torch.ops.liftover import Liftover
from hal_tpu_torch.randgen import create_random_alignment
from hal_tpu_torch.randgen_exact import create_preset_alignment_exact
from hal_tpu_torch.storage import open_alignment
from test_torch_host_copies import _assert_same_alignment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a DNA alignment with a three-level tree (Genome_3 -> Genome_7 is a branch
# below an internal node, the one halTreeNITurnover reports) and enough
# indels for the neutral-indel calls; halSynteny finds anchors on it
FIXTURE = dict(seed=5, max_genomes=8, min_genomes=6, mean_degree=1.0,
               max_branch_length=0.5, min_segment_length=20,
               max_segment_length=80, min_segments=400, max_segments=800)
# halTreeNIConservation flags that call conserved intervals on every
# genome of this fixture, so that halTreeNITurnover lifts
NI_CONS_FLAGS = ["--pval", "0.5", "--cutoff", "0.1"]


def run_tool(pkg, tool, args, device=False):
    argv = [sys.executable, "-m", "%s.tools.%s" % (pkg, tool)]
    argv += [str(a) for a in args]
    if device and pkg == "hal_tpu_torch":
        argv += ["--device", "cpu"]
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(halz path, alignment, a leaf pair, BED12 / BED6 gene files)."""
    d = tmp_path_factory.mktemp("analysis")
    hal = str(d / "a.halz")
    made = jax_random_alignment(**FIXTURE)
    for name in made.genome_names():  # soft-mask 37 of every 500 bases
        g = made.open_genome(name)
        for s in range(0, g.length - 37, 500):
            g.set_dna(s, g.get_dna_string(s, 37).lower())
    jax_save(made, hal, fmt="halz")
    aln = open_alignment(hal)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    rng = np.random.default_rng(7)
    rows12, rows6 = [], []
    for k in range(120):
        si = int(rng.integers(0, g.num_sequences))
        length = g.seq_length(si)
        span = int(rng.integers(30, min(900, length - 1)))
        st = int(rng.integers(0, length - span))
        nb = int(rng.integers(1, 5))
        cuts = np.sort(rng.choice(np.arange(1, span), 2 * nb - 2,
                                  replace=False))
        edges = np.concatenate([[0], cuts, [span]])
        starts, ends = edges[0::2], edges[1::2]
        rows12.append("%s\t%d\t%d\tg%d\t0\t%s\t%d\t%d\t0\t%d\t%s,\t%s,\n" % (
            g.seq_names[si], st, st + span, k, "+-"[k % 2], st, st + span,
            nb, ",".join(str(int(e - s)) for s, e in zip(starts, ends)),
            ",".join(str(int(s)) for s in starts)))
        st = int(rng.integers(0, length - 300))
        rows6.append("%s\t%d\t%d\tg%d\t0\t%s\n" % (
            g.seq_names[si], st, st + int(rng.integers(20, 300)), k,
            "+-"[int(rng.integers(0, 2))]))
    # a sequence the genome lacks (twice), a line past its sequence's end
    # (twice) and a comment; for the liftover's own tests also a BED12 line
    # with no blocks (halLiftoverStatus's read_bed12 refuses it)
    past = "%s\t0\t%d\tpast\t0\t+\n" % (g.seq_names[0], g.seq_length(0) + 9)
    odd = ["chrMissing\t0\t100\tmiss1\t0\t+\n", past,
           "chrMissing\t5\t50\tmiss2\t0\t-\n", past, "# a comment\n"]
    noblk = "%s\t10\t20\tnoblk\t0\t+\t10\t20\t0\t0\t,\t,\n" % g.seq_names[0]
    paths = {}
    for name, rows in (("bed12", rows12[:60] + odd + rows12[60:]),
                       ("bed12_lift", rows12[:60] + odd + [noblk]
                        + rows12[60:]),
                       ("bed6", rows6 + odd[:4]), ("bed6_plain", rows6)):
        paths[name] = str(d / (name + ".bed"))
        with open(paths[name], "w") as f:
            f.writelines(rows)
    return dict(hal=hal, aln=aln, src=src, tgt=tgt, dir=d, **paths)


# ---------------------------------------------------------------- copies

def _random_sets(seed, mod):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        names, starts, ends = [], [], []
        for _ in range(80):
            names.append("chr%d" % rng.integers(0, 3))
            s = int(rng.integers(0, 2000))
            starts.append(s)
            ends.append(s + int(rng.integers(1, 60)))
        out.append(mod.IntervalSet.from_rows(names, starts, ends))
    return out


def _set_rows(s):
    return {k: v.tolist() for k, v in s.data.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interval_set_algebra_equals_original(seed):
    """intersect, subtract, union, total_length, overlap_counts, BED
    writing and reading of the copied IntervalSet equal the original's."""
    pa, pb = _random_sets(seed, port_iv)
    ja, jb = _random_sets(seed, jax_iv)
    for op in ("intersect", "subtract", "union"):
        got = getattr(pa, op)(pb)
        want = getattr(ja, op)(jb)
        assert _set_rows(got) == _set_rows(want), op
        assert got.total_length() == want.total_length()
        bp, bj = io.StringIO(), io.StringIO()
        got.write_bed(bp)
        want.write_bed(bj)
        assert bp.getvalue() == bj.getvalue() and bp.getvalue()
        bp.seek(0)
        assert _set_rows(port_iv.IntervalSet.from_bed(bp)) == _set_rows(want)
    rng = np.random.default_rng(seed + 10)
    names = ["chr%d" % i for i in rng.integers(0, 4, 50)]
    s = rng.integers(0, 2000, 50)
    e = s + rng.integers(1, 100, 50)
    assert np.array_equal(pa.overlap_counts(names, s, e),
                          ja.overlap_counts(names, s, e))
    iv = np.stack([s, e], axis=1)
    assert np.array_equal(port_iv.merge_intervals(iv),
                          jax_iv.merge_intervals(iv))


def test_turnover_model_equals_original():
    """The CTMC model's matrices, its generated data, the randomized
    descent and the parameter estimate equal the original's on one seed."""
    for lr, gr, t in ((0.3, 0.2, 0.5), (0.01, 0.04, 1.7)):
        assert port_tm.compute_p_matrix(lr, gr, t) == \
            jax_tm.compute_p_matrix(lr, gr, t)
        assert port_tm.compute_stationary_dist(lr, gr, t) == \
            jax_tm.compute_stationary_dist(lr, gr, t)
    data = port_tm.generate_data(20, (0.1, 1.0), 0.3, 0.2, 0.05,
                                 random.Random(4))
    assert data == jax_tm.generate_data(20, (0.1, 1.0), 0.3, 0.2, 0.05,
                                        random.Random(4))
    assert port_tm.diff_sq_many_points(0.2, 0.1, data) == \
        jax_tm.diff_sq_many_points(0.2, 0.1, data)
    assert port_tm.grad_descent(0.05, 0.05, data, 500, 0.005,
                                random.Random(9)) == \
        jax_tm.grad_descent(0.05, 0.05, data, 500, 0.005, random.Random(9))
    assert port_tm.estimate_params_from_list(data, 200, 0.01, 3,
                                             random.Random(2)) == \
        jax_tm.estimate_params_from_list(data, 200, 0.01, 3, random.Random(2))


def test_neutral_indel_host_functions_equal_original(fixture, tmp_path):
    """read_mutations, background_rate and BedConservation's calls on one
    branch's mutation BED equal the original's."""
    hal, src = fixture["hal"], fixture["src"]
    r = run_tool("hal_tpu_torch", "halBranchMutations",
                 [hal, src, "--refFile", tmp_path / "mu.bed"])
    assert r.returncode == 0, r.stderr
    mu = str(tmp_path / "mu.bed")
    g = fixture["aln"].open_genome(src)
    bg = tmp_path / "bg.bed"
    bg.write_text("".join("%s\t0\t%d\n" % (g.seq_names[i], g.seq_length(i))
                          for i in range(g.num_sequences)))
    got = port_ni.read_mutations(mu)
    want = jax_ni.read_mutations(mu)
    assert got[0] == want[0] and got[3:] == want[3:] and got[0]
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    assert port_ni.background_rate(mu, str(bg)) == \
        jax_ni.background_rate(mu, str(bg))
    outs = []
    for mod in (port_ni, jax_ni):
        bc = mod.BedConservation()
        bc.compute_background_rate(mu, str(bg))
        buf = io.StringIO()
        bc.identify_conserved_intervals(mu, buf, 0.5, 0.1)
        outs.append((buf.getvalue(), bc.rate, bc.written_count,
                     bc.written_bases, bc.min_distance(0.05)))
    assert outs[0] == outs[1] and outs[0][0]


def _corrupt(aln, how):
    """One structural fault of tests/test_randgen_validate.py's kinds in
    the first genome where it applies; False where none does."""
    for name in aln.genome_names():
        g = aln.open_genome(name)
        mapped = np.flatnonzero(g.top_parent != NULL_INDEX) \
            if g.num_top_segments else []
        if how == "parent_link" and len(mapped):
            g.top_parent[int(mapped[0])] = 10 ** 9
            return True
        if how == "segment_start" and g.num_top_segments > 2:
            g.top_start[1] += 1
            return True
        if how == "bottom_child" and g.num_bottom_segments and \
                (g.bot_child != NULL_INDEX).any():
            i, j = map(int, np.argwhere(g.bot_child != NULL_INDEX)[0])
            g.bot_child[i, j] = 10 ** 9
            return True
        if how == "paralogy_ring" and g.num_top_segments and \
                (g.top_paralogy != NULL_INDEX).any():
            i = int(np.flatnonzero(g.top_paralogy != NULL_INDEX)[0])
            g.top_paralogy[i] = i
            return True
    return False


@pytest.mark.parametrize("how", [None, "parent_link", "segment_start",
                                 "bottom_child", "paralogy_ring"])
def test_validate_equals_original(how):
    """validate_alignment of the copy passes a valid alignment as the
    original does, and on each corruption raises ValidationError with the
    original's message; validate_genome likewise on every genome."""
    opts = dict(seed=0, max_genomes=6, min_segments=5, max_segments=30,
                min_segment_length=2, max_segment_length=20)
    port, jax = create_random_alignment(**opts), jax_random_alignment(**opts)
    if how is not None:
        assert _corrupt(port, how) and _corrupt(jax, how)

    def outcome(mod, aln, fn, *args):
        try:
            getattr(mod, fn)(aln, *args)
        except mod.ValidationError as e:
            return str(e)
        return None

    got = outcome(port_validate, port, "validate_alignment")
    assert got == outcome(jax_validate, jax, "validate_alignment")
    assert (got is None) == (how is None)
    for name in port.genome_names():
        assert outcome(port_validate, port, "validate_genome", name) == \
            outcome(jax_validate, jax, "validate_genome", name)


@pytest.mark.parametrize("preset,overrides", [
    ("small", {}), ("medium", {}),
    ("small", dict(min_segment_length=3000, max_segment_length=5000)),
    ("big", dict(max_genomes=20, max_segments=410,
                 max_segment_length=1200))])
def test_randgen_exact_equals_original(preset, overrides):
    """The bit-exact reference generator's copy builds the original's
    alignment (every array, the tree and the DNA) across presets."""
    _assert_same_alignment(create_preset_alignment_exact(preset, 0,
                                                         **overrides),
                           jax_preset_exact(preset, 0, **overrides))


# ------------------------------------------------------- batched liftover

def _beds(path):
    with open(path) as f:
        return list(read_bed(f))


def aln_jax(fixture):
    from hal_tpu.storage import open_alignment as jax_open

    return jax_open(fixture["hal"])


def _per_line(lifter, beds):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = [lifter.visit_line(b) for b in copy.deepcopy(beds)]
    return out, err.getvalue()


@pytest.mark.parametrize("out_psl", [False, True])
@pytest.mark.parametrize("dupes", [True, False])
@pytest.mark.parametrize("batch_size", [0, 7])
def test_visit_lines_batched_equals_visit_line(fixture, out_psl, dupes,
                                               batch_size):
    """visit_lines_batched (on the CPU mapper) yields per-line visit_line's
    BedLines, PSL records included, and its stderr warnings, for BED12
    lines, lines on a missing sequence, past a sequence's end and with no
    blocks, with and without paralogies, in one chunk and in chunks of 7;
    the written lines equal the JAX package's per-line visit_line."""
    aln, src, tgt = fixture["aln"], fixture["src"], fixture["tgt"]
    beds = _beds(fixture["bed12_lift"])

    def lifter():
        return Liftover(aln, src, tgt, traverse_dupes=dupes, out_psl=out_psl,
                        device="cpu")

    want, want_err = _per_line(lifter(), beds)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = list(lifter().visit_lines_batched(copy.deepcopy(beds),
                                                batch_size))
    assert got == want and err.getvalue() == want_err
    assert want_err.count("Unable to find sequence chrMissing") == 1
    assert want_err.count("Skipping interval with endpoint") == 2
    assert "Skipping input line with 0 blocks" in want_err
    assert sum(len(x) for x in got) > len(beds) // 2

    jl = jax_liftover.Liftover(aln_jax(fixture), src, tgt,
                               traverse_dupes=dupes, out_psl=out_psl)
    with open(fixture["bed12_lift"]) as f, \
            contextlib.redirect_stderr(io.StringIO()):
        jax_out = [jl.visit_line(b) for b in jax_read_bed(f)]

    def text(results):
        return ["".join(x.write_psl() if out_psl else x.write() for x in r)
                for r in results]

    assert text(got) == text(jax_out)


def test_visit_lines_batched_fresh_missed(fixture):
    """fresh_missed warns of a missing sequence on every line naming it,
    as a new Liftover for each line does (halLiftoverStatus)."""
    aln, src, tgt = fixture["aln"], fixture["src"], fixture["tgt"]
    beds = _beds(fixture["bed12"])
    want, err = [], io.StringIO()
    with contextlib.redirect_stderr(err):
        for b in copy.deepcopy(beds):
            want.append(Liftover(aln, src, tgt, out_psl=True,
                                 device="cpu").visit_line(b))
    got_err = io.StringIO()
    with contextlib.redirect_stderr(got_err):
        got = list(Liftover(aln, src, tgt, out_psl=True, device="cpu")
                   .visit_lines_batched(copy.deepcopy(beds), 16,
                                        fresh_missed=True))
    assert got == want and got_err.getvalue() == err.getvalue()
    assert err.getvalue().count("Unable to find sequence chrMissing") == 2


def test_map_lines_then_convert_maps_nothing(fixture, monkeypatch):
    """After map_lines, convert of those lines reads every interval from
    the fragment cache (the host mapper is never called) and writes
    convert's bytes without the cache."""
    aln, src, tgt = fixture["aln"], fixture["src"], fixture["tgt"]
    text = open(fixture["bed12"]).read()
    want = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()):
        Liftover(aln, src, tgt, device="cpu").convert(io.StringIO(text), want)
    lifter = Liftover(aln, src, tgt, device="cpu")
    lifter.map_lines(read_bed(io.StringIO(text)), batch_size=5)
    from hal_tpu_torch.ops import segmap_host

    def refuse(*a, **k):
        raise AssertionError("host map_source called")

    monkeypatch.setattr(segmap_host, "map_source", refuse)
    got = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()):
        lifter.convert(io.StringIO(text), got)
    assert got.getvalue() == want.getvalue() and got.getvalue()


def test_whole_sequence_lifts_past_the_default_capacity():
    """A whole sequence of 140k segments in one dispatch (halSynteny's
    lift): the mapper at its default starting capacity gives up (4,096
    times the batch), visit_lines_batched starts at a capacity sized to the
    segments the line covers and equals per-line visit_line."""
    from hal_tpu_torch.io.bed import BedLine
    from hal_tpu_torch.ops.segmap_torch import BatchMapper

    aln = create_random_alignment(
        seed=3, max_genomes=3, min_genomes=3, min_segment_length=2,
        max_segment_length=4, min_segments=70000, max_segments=72000,
        store_dna=False)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    assert g.num_top_segments > 16 * 4096
    mapper = BatchMapper(aln, src, tgt, device="cpu")
    with pytest.raises(RuntimeError, match="capacity blowup"):
        mapper.decode(mapper.dispatch(np.array([0]), np.array([g.length])))
    beds = [BedLine(chrom=g.seq_names[i], start=0, end=g.seq_length(i),
                    bed_type=3) for i in range(g.num_sequences)]
    got = list(Liftover(aln, src, tgt, device="cpu").visit_lines_batched(
        copy.deepcopy(beds), 0))
    want, _ = _per_line(Liftover(aln, src, tgt, device="cpu"), beds)
    assert got == want and sum(len(x) for x in got) > 1000


@pytest.mark.cuda
def test_visit_lines_batched_cuda_equals_cpu(fixture):
    """On the card: visit_lines_batched equals the CPU mapper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda)")
    aln, src, tgt = fixture["aln"], fixture["src"], fixture["tgt"]
    beds = _beds(fixture["bed12"])
    with contextlib.redirect_stderr(io.StringIO()):
        got = list(Liftover(aln, src, tgt, out_psl=True, device="cuda")
                   .visit_lines_batched(copy.deepcopy(beds), 16))
        want = list(Liftover(aln, src, tgt, out_psl=True, device="cpu")
                    .visit_lines_batched(copy.deepcopy(beds), 16))
    assert got == want


# ------------------------------------------------------------------ CLIs

def _files(d):
    return {os.path.relpath(os.path.join(dp, f), d):
            open(os.path.join(dp, f), "rb").read()
            for dp, _, fs in os.walk(d) for f in fs}


def _ni_pipeline(fx, d):
    """halTreeMutations -> halTreeNIBackground -> halTreeNIConservation ->
    halTreeNITurnover -> estimateTurnoverParams, in work directory d."""
    hal = fx["hal"]
    return [("halTreeMutations", [hal, d, "--doSnps"], False),
            ("halTreeNIBackground", [hal, d], False),
            ("halTreeNIConservation", [hal, d] + NI_CONS_FLAGS, False),
            ("halTreeNITurnover", [hal, d], True),
            ("estimateTurnoverParams", [hal, "TURNOVER", "--maxIt", "200",
                                        "--seed", "0"], False)]


# name: (steps given the fixture and an empty output directory d, each
# (tool, arguments, takes --device), and the expected exit code)
CLI_CASES = {
    "halValidate": (lambda fx, d: [("halValidate", [fx["hal"]], False)], 0),
    "halValidate_genome": (lambda fx, d: [
        ("halValidate", [fx["hal"], "--genome", fx["src"]], False)], 0),
    "halSynteny": (lambda fx, d: [("halSynteny", [
        fx["hal"], d + "/out.psl", "--queryGenome", fx["src"],
        "--targetGenome", fx["tgt"], "--minBlockSize", "20",
        "--maxAnchorDistance", "200"], True)], 0),
    "halSynteny_chromosome_stdout": (lambda fx, d: [("halSynteny", [
        fx["hal"], "stdout", "--queryGenome", fx["tgt"], "--targetGenome",
        fx["src"], "--minBlockSize", "1", "--queryChromosome",
        fx["aln"].open_genome(fx["tgt"]).seq_names[0]], True)], 0),
    "halSynteny_psl": (lambda fx, d: [
        ("halSynteny", [fx["hal"], d + "/a.psl", "--queryGenome", fx["src"],
                        "--targetGenome", fx["tgt"], "--minBlockSize", "1",
                        "--maxAnchorDistance", "1000000"], True),
        ("halSynteny", [d + "/a.psl", d + "/b.psl", "--alignmentIsPsl",
                        "--minBlockSize", "1"], True)], 0),
    "halLiftoverStatus": (lambda fx, d: [("halLiftoverStatus", [
        fx["bed12"], fx["hal"], fx["src"], fx["tgt"], d + "/status.tsv"],
        True)], 0),
    "halLiftoverStatus_edge_stdout": (lambda fx, d: [("halLiftoverStatus", [
        fx["bed12"], fx["hal"], fx["src"], fx["tgt"], "stdout", "--edge",
        "0.1"], True)], 0),
    "halLiftoverStatus_bad_line": (lambda fx, d: [("halLiftoverStatus", [
        _with_line(fx, d, "bed12", 30, "%s\t40\t40\tzero\n"), fx["hal"],
        fx["src"], fx["tgt"], d + "/status.tsv"], True)], 1),
    "syntenyRates": (lambda fx, d: [("syntenyRates", [
        fx["hal"], fx["src"], fx["bed6"], fx["tgt"]], True)], 0),
    "syntenyRates_merge": (lambda fx, d: [("syntenyRates", [
        fx["hal"], fx["src"], fx["bed6"], fx["tgt"], "--mergeBedLines"],
        True)], 0),
    "syntenyRates_bad_gene": (lambda fx, d: [("syntenyRates", [
        fx["hal"], fx["src"], _with_line(fx, d, "bed6_plain", 50,
                                         "%s\tEND\tEND\tzero\t0\t+\n"),
        fx["tgt"]], True)], 1),
    "halAlignedExtract": (lambda fx, d: [("halAlignedExtract", [
        fx["hal"], fx["src"], "--alignedFile", d + "/al.bed",
        "--viewParentCoords"], False), ("halAlignedExtract", [
            fx["hal"], fx["src"], "--complement"], False)], 0),
    "halMaskExtract": (lambda fx, d: [("halMaskExtract", [
        fx["hal"], fx["src"], "--maskFile", d + "/mask.bed", "--extend",
        "3"], False)], 0),
    "halBranchMutations": (lambda fx, d: [("halBranchMutations", [
        fx["hal"], fx["src"], "--refFile", d + "/ref.bed", "--parentFile",
        d + "/par.bed", "--snpFile", d + "/snp.bed", "--delBreakFile",
        d + "/db.bed"], False)], 0),
    "neutral_indel_pipeline": (_ni_pipeline, 0),
    "runDotplot": (lambda fx, d: [("runDotplot", [
        fx["hal"], fx["src"], fx["aln"].open_genome(fx["src"]).seq_names[0],
        fx["tgt"], "--out", d + "/dot.tsv"], True)], 0),
}


def _with_line(fx, d, which, at, fmt):
    """A copy of a gene file with one zero-length line inserted at row at,
    which both packages refuse when they reach it; END is the position
    before the sequence's last base (after every gene, so syntenyRates's
    overlap filter keeps it)."""
    lines = open(fx[which]).read().splitlines(True)
    g = fx["aln"].open_genome(fx["src"])
    lines.insert(at, (fmt % g.seq_names[0]).replace(
        "END", str(g.seq_length(0) - 1)))
    path = os.path.join(d, "..", which + "_bad.bed")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_equals_original(fixture, tmp_path, case):
    """Each CLI (the port's with --device cpu where it takes the flag):
    every file it writes, its stdout and its stderr equal hal_tpu's, step
    by step, and its exit code is the expected one."""
    steps, rc = CLI_CASES[case]
    runs = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        streams = []
        for k, (tool, args, device) in enumerate(steps(fixture, str(d))):
            args = [a if a != "TURNOVER" else str(d / "turnover.txt")
                    for a in args]
            r = run_tool(pkg, tool, args, device)
            streams.append((r.returncode, r.stdout, r.stderr))
            want_rc = rc if k == len(steps(fixture, str(d))) - 1 else 0
            assert r.returncode == want_rc, (pkg, tool, r.stderr[-2000:])
            if tool == "halTreeNITurnover":
                (d / "turnover.txt").write_text(r.stdout)
        runs[pkg] = (streams, _files(d))
    got, want = runs["hal_tpu_torch"], runs["hal_tpu"]
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    assert [k for k in want[1] if got[1][k] != want[1][k]] == []
    # each case shows real output: files with lines or stdout
    assert any(want[1].values()) or any(s[1] for s in want[0])
    if case == "halSynteny":
        assert want[1]["out.psl"].count(b"\n") > 2
    if case == "neutral_indel_pipeline":
        assert b"cons " in want[1]["turnover.txt"]
        assert any(k.endswith("_pm.bed") and v for k, v in want[1].items())
    if rc:
        assert "hal exception caught: Error zero or negative length" in \
            want[0][-1][2]


@pytest.mark.parametrize("tool,args", [
    ("halLiftoverStatus", ["BED12", "HAL", "SRC", "TGT", "OUT"]),
    ("halSynteny", ["HAL", "OUT", "--queryGenome", "SRC", "--targetGenome",
                    "TGT"]),
    ("syntenyRates", ["HAL", "SRC", "BED6", "TGT"]),
    ("halTreeNITurnover", ["HAL", "DIR"]),
    ("runDotplot", ["HAL", "SRC", "CHROM", "TGT"])])
def test_device_cuda_without_card_raises(fixture, tmp_path, tool, args):
    """--device cuda (the default) with no CUDA device: the tool fails
    with HalError's message and exit 1, and writes no output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    sub = {"BED12": fixture["bed12"], "BED6": fixture["bed6"],
           "HAL": fixture["hal"], "SRC": fixture["src"],
           "TGT": fixture["tgt"], "OUT": str(tmp_path / "out"),
           "DIR": str(tmp_path), "CHROM":
           fixture["aln"].open_genome(fixture["src"]).seq_names[0]}
    r = run_tool("hal_tpu_torch", tool, [sub.get(a, a) for a in args])
    assert r.returncode == 1
    assert "hal exception caught: --device cuda: no CUDA device" in r.stderr
    assert not (tmp_path / "out").exists() and r.stdout == ""


def test_dispatcher_lists_and_runs_the_port_tools(fixture):
    """python -m hal_tpu_torch --help lists the port's tools, this slice's
    included, and python -m hal_tpu_torch <tool> runs the port's tool."""
    r = subprocess.run([sys.executable, "-m", "hal_tpu_torch", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0
    assert r.stderr.startswith("usage: python -m hal_tpu_torch <tool>")
    tools = r.stderr.split("tools:\n")[1].split()
    for t in ("halValidate", "halSynteny", "halLiftoverStatus",
              "syntenyRates", "halAlignedExtract", "halMaskExtract",
              "halBranchMutations", "halTreeMutations",
              "halTreeNIBackground", "halTreeNIConservation",
              "halTreeNITurnover", "estimateTurnoverParams", "runDotplot",
              "halLiftover", "hal2assemblyHub"):
        assert t in tools, t
    assert "_device" not in tools
    r = subprocess.run([sys.executable, "-m", "hal_tpu_torch", "halValidate",
                        fixture["hal"]], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout == "\nFile valid\n"
    r = subprocess.run([sys.executable, "-m", "hal_tpu_torch", "nope"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and "unknown tool: nope" in r.stderr
