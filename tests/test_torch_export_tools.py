"""The port's host-only export and mutation tools (hal2chain, hal2paf,
halCoverageTable, halSummarizeMutations, mafMutations, halIndels,
getInsertionStats), copies that run no device code, against hal_tpu's
CLIs as `python -m` subprocesses on seeded alignments, after the JAX
package's own tests of them (test_lod_blockviz.py's hal2chain CLI,
test_reference_goldens.py's hal2paf, test_hub_tools.py's coverage table
and MAF mutation count, test_mutations.py's summary): out files, stdout,
stderr and exit code byte-equal.  Tolerance: exact equality."""

import io
import os
import subprocess
import sys

import pytest

from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.storage import save_alignment as jax_save
from hal_tpu.tools import mafMutations as jax_maf_mutations
from hal_tpu_torch.tools import mafMutations as port_maf_mutations

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(pkg, tool, args):
    argv = [sys.executable, "-m", "%s.tools.%s" % (pkg, tool)]
    return subprocess.run(argv + [str(a) for a in args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """halRandGen files of the JAX tests (seed 6 for hal2chain, seed 2 for
    halSummarizeMutations), a seeded DNA halz with paralogies, a
    halCoverage table of it and a MAF of it (made by hal_tpu's CLIs)."""
    d = tmp_path_factory.mktemp("export")
    out = dict(dir=d)
    for name, seed, segs in (("chain", 6, 30), ("mut", 2, 20)):
        out[name] = str(d / (name + ".halz"))
        r = run_tool("hal_tpu", "halRandGen", [
            out[name], "--seed", seed, "--maxGenomes", "4", "--maxSegments",
            segs, "--maxSegmentLength", "25"])
        assert r.returncode == 0, r.stderr
    aln = jax_random_alignment(seed=5, max_genomes=7, min_genomes=5,
                               mean_degree=1.4, min_segments=50,
                               max_segments=150, min_segment_length=5,
                               max_segment_length=40)
    for name in aln.genome_names():  # N runs for halIndels' clean test
        g = aln.open_genome(name)
        for s in range(0, g.length - 4, 211):
            g.set_dna(s, "NNNN")
    out["dna"] = str(d / "dna.halz")
    jax_save(aln, out["dna"], fmt="halz")
    out["names"] = aln.genome_names()
    out["children"] = [n for n in out["names"] if aln.tree.parent(n)]
    out["leaves"] = [n for n in out["names"] if aln.tree.is_leaf(n)]
    out["inner"] = next(n for n in out["children"]
                        if not aln.tree.is_leaf(n))
    out["seq"] = aln.open_genome(out["children"][0]).seq_names[0]
    r = run_tool("hal_tpu", "halCoverage", [out["dna"], out["leaves"][0],
                                            "--numSamples", "5000",
                                            "--bySequence"])
    assert r.returncode == 0, r.stderr
    for name in ("cov", "cov2"):
        out[name] = str(d / (name + ".txt"))
        with open(out[name], "w") as f:
            f.write(r.stdout)
    out["maf"] = str(d / "aln.maf")
    r = run_tool("hal_tpu", "hal2maf", [out["dna"], out["maf"],
                                        "--refGenome", out["leaves"][0]])
    assert r.returncode == 0, r.stderr
    return out


# name: (tool, arguments given the fixture and the output directory d,
# expected exit code)
CASES = {
    "hal2chain": ("hal2chain", lambda fx, d: [
        fx["chain"], "Genome_1", "--maxGap", "1000"], 0),
    "hal2chain_range_file": ("hal2chain", lambda fx, d: [
        fx["dna"], fx["children"][0], "--sequence", fx["seq"], "--start",
        "20", "--length", "400", "--chainFile", d + "/out.chain"], 0),
    "hal2chain_root": ("hal2chain", lambda fx, d: [
        fx["chain"], "Genome_0"], 1),
    "hal2paf": ("hal2paf", lambda fx, d: [fx["dna"]], 0),
    "hal2paf_names_root": ("hal2paf", lambda fx, d: [
        fx["dna"], "--onlySequenceNames", "--rootGenome", fx["inner"]], 0),
    "halCoverageTable": ("halCoverageTable", lambda fx, d: [
        "--input", fx["cov"], fx["cov2"], "--reference", fx["leaves"][0]],
        0),
    "halCoverageTable_duplicate": ("halCoverageTable", lambda fx, d: [
        "--input", fx["cov"], fx["cov"], "--reference", fx["leaves"][0]],
        1),
    "halCoverageTable_counts": ("halCoverageTable", lambda fx, d: [
        "--input", fx["cov"], "--reference", fx["leaves"][0], "--counts",
        "--chroms", fx["seq"]], 0),
    "halSummarizeMutations": ("halSummarizeMutations", lambda fx, d: [
        fx["mut"]], 0),
    "halSummarizeMutations_opts": ("halSummarizeMutations", lambda fx, d: [
        fx["dna"], "--targetGenomes", ",".join(fx["leaves"][:2]),
        "--maxGap", "3", "--maxNFraction", "0.5"], 0),
    "halSummarizeMutations_justSubs": ("halSummarizeMutations",
                                       lambda fx, d: [fx["dna"],
                                                      "--justSubs"], 0),
    "mafMutations": ("mafMutations", lambda fx, d: [fx["maf"]], 0),
    "halIndels": ("halIndels", lambda fx, d: [fx["dna"],
                                              fx["children"][0]], 0),
    "halIndels_adjacent": ("halIndels", lambda fx, d: [
        fx["dna"], fx["leaves"][-1], "--adjacentBases", "1"], 0),
    "getInsertionStats": ("getInsertionStats", lambda fx, d: [
        fx["dna"], fx["children"][0]], 0),
    "getInsertionStats_gap": ("getInsertionStats", lambda fx, d: [
        fx["dna"], fx["leaves"][-1], "--maxGap", "0"], 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_original(fixture, tmp_path, case):
    """The port's copy writes hal_tpu's files, stdout and stderr, and
    exits with its code."""
    tool, args, rc = CASES[case]
    runs = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        r = run_tool(pkg, tool, args(fixture, str(d)))
        assert r.returncode == rc, (pkg, r.stderr[-2000:])
        runs[pkg] = (r.stdout, r.stderr,
                     {f: (d / f).read_bytes() for f in os.listdir(d)})
    assert runs["hal_tpu_torch"] == runs["hal_tpu"]
    out, err, files = runs["hal_tpu"]
    if rc:
        assert "hal exception caught" in err
    else:
        assert out.count("\n") + sum(v.count(b"\n")
                                     for v in files.values()) >= 1


def test_maf_mutations_count_equals_original():
    """test_hub_tools.py's MAF: count_maf of both packages gives 7."""
    maf = ("a\ns\tr.c\t0\t5\t+\t10\tACG-TA\ns\tq.c\t0\t5\t+\t10\tACC-TG\n"
           "s\tp.c\t2\t4\t-\t10\tA-GGTC\n\n"
           "a\ns\tr.c\t5\t3\t+\t10\tAAA\ns\tq.c\t5\t3\t+\t10\taaG\n")
    assert port_maf_mutations.count_maf(io.StringIO(maf)) == 7 == \
        jax_maf_mutations.count_maf(io.StringIO(maf))
