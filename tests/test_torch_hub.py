"""The port's assembly-hub path on the CPU, held to the JAX package's tools
on the same seeded alignments: hal2assemblyHub (--device cpu) with its LOD
series, GC, repeat-mask and alignability tracks, its conservation track,
halGenerateComparisonHub, halLodBenchmark, halLodExtract,
halLodInterpolate, blockVizTest, blockVizBenchmark and hal2mafMP.

Each tool runs as `python -m <package>.tools.<tool>` in a subprocess, as a
user runs it; outputs are compared byte for byte, except the columns that
print a wall-clock time (halLodBenchmark's time(s), blockVizBenchmark's
mean_ms), which are masked.  The conservation track is held to the JAX
package's halPhyloP CLI (float64 on the CPU): headers equal and values
equal at --prec 3, as tests/test_torch_phylop.py holds the port's
halPhyloP CLI; its bigWig by its decoded values.

The port's HAL_TPU_TORCH_LAUNCH_LOG diagnostic shows which jobs imported
the kernels and that the --device cpu jobs launched none."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.storage import open_alignment as jax_open
from hal_tpu.storage import save_alignment as jax_save
from test_bbi import _decode_bigwig
from test_torch_phylop import _near_rounding_boundary, gtr_mod_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUB_FLAGS = ["--lod", "--maxBlock", "10", "--gcContent", "--rmsk",
             "--alignability", "--numProc", "2"]


def run_tool(pkg, tool, args, cwd=REPO, env=None, check=True):
    res = subprocess.run([sys.executable, "-m", "%s.tools.%s" % (pkg, tool)]
                         + [str(a) for a in args], cwd=cwd, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, **(env or {})))
    if check:
        assert res.returncode == 0, res.stderr[-3000:]
    return res


def tree_bytes(root):
    """{relative path: bytes, or ('link', target) for a symlink}."""
    out = {}
    for dp, dirs, files in os.walk(root):
        for f in files + [d for d in dirs if os.path.islink(os.path.join(dp, d))]:
            p = os.path.join(dp, f)
            rel = os.path.relpath(p, root)
            out[rel] = (("link", os.readlink(p)) if os.path.islink(p)
                        else open(p, "rb").read())
    return out


def assert_same_tree(got_root, want_root):
    got, want = tree_bytes(got_root), tree_bytes(want_root)
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    return want


def read_launch_log(path):
    """The lines of a HAL_TPU_TORCH_LAUNCH_LOG, by tool name."""
    out = {}
    with open(path) as f:
        for line in f:
            x = json.loads(line)
            assert x["end"] >= x["start"] > 0
            out.setdefault(os.path.basename(x["argv"][0])[:-3], []).append(x)
    return out


def launched(lines):
    return sum(sum((x["launches"] or {}).values()) for x in lines)


@pytest.fixture(scope="module")
def hub_hal(tmp_path_factory):
    """A random DNA alignment (5 genomes, ~40 segments of <= 25 bp a
    genome, soft-masked bases) as halz, a seeded GTR .mod on its tree, and
    its leaves."""
    d = tmp_path_factory.mktemp("hub")
    aln = jax_random_alignment(seed=2, max_genomes=5, max_segments=40,
                               max_segment_length=25)
    hal = str(d / "t.halz")
    jax_save(aln, hal, fmt="halz")
    mod = d / "t.mod"
    mod.write_text(gtr_mod_text(aln.tree.to_newick(), 41))
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    return hal, str(mod), leaves, d


def test_hub_equals_original(hub_hal, tmp_path):
    """hal2assemblyHub --lod --gcContent --rmsk --alignability: every file
    of the port's --device cpu hub (the alignment's copy, lod.txt and the
    LOD halz files, chrom.sizes, FASTA, GC wiggle and bigWig, repeat-mask
    BED and bigBed, alignability wiggle and bigWig, trackDb, genomes,
    groups, hub and documentation pages) equals the original's.  Every
    job of the port's hub ran the port's tool, and each alignability job
    (the one job to import the kernels' module) launched none."""
    hal, _mod, leaves, _d = hub_hal
    log = tmp_path / "launches.jsonl"
    run_tool("hal_tpu", "hal2assemblyHub", [hal, tmp_path / "want"] + HUB_FLAGS)
    run_tool("hal_tpu_torch", "hal2assemblyHub",
             [hal, tmp_path / "got"] + HUB_FLAGS + ["--device", "cpu"],
             env={"HAL_TPU_TORCH_LAUNCH_LOG": str(log)})
    want = assert_same_tree(tmp_path / "got", tmp_path / "want")
    for g in leaves:
        for name in (g + ".gc.bw", g + ".rmsk.bb", g + ".alignability.bw",
                     g + ".fa", "chrom.sizes", "trackDb.txt"):
            assert want[os.path.join(g, name)], name
    assert len([k for k in want if k.startswith("lod" + os.sep)]) > 1
    tools = read_launch_log(log)
    assert sorted(tools) == ["hal2assemblyHub", "hal2fasta",
                             "halAlignmentDepth", "halLodInterpolate",
                             "halStats"]
    for tool in ("hal2fasta", "halAlignmentDepth"):
        assert sorted(x["argv"][2] for x in tools[tool]) == sorted(leaves)
    assert sorted(x["argv"][3] for x in tools["halStats"]
                  if x["argv"][2] == "--chromSizes") == sorted(leaves)
    depth = tools["halAlignmentDepth"]
    assert all(x["argv"][-2:] == ["--device", "cpu"] and x["launches"]
               for x in depth)
    assert launched(depth) == 0
    assert all(x["launches"] is None for t in ("hal2fasta", "halStats",
                                               "halLodInterpolate")
               for x in tools[t])


def test_hub_conservation(hub_hal, tmp_path):
    """--conservation: the original hub fails (its halPhyloP job lacks the
    required wigFile); the port's passes "stdout", and each leaf's
    .conservation.wig equals the JAX package's halPhyloP CLI on that leaf
    (headers equal, values equal at --prec 3), its bigWig decodes to the
    values of the original writer's bigWig of that wiggle, and trackDb
    carries the track."""
    from hal_tpu import phylop as jax_phylop
    from hal_tpu.io import bbi as jax_bbi

    hal, mod, leaves, _d = hub_hal
    res = run_tool("hal_tpu", "hal2assemblyHub",
                   [hal, tmp_path / "orig", "--conservation", mod], check=False)
    assert res.returncode != 0
    assert "the following arguments are required: wigFile" in res.stderr
    log = tmp_path / "launches.jsonl"
    run_tool("hal_tpu_torch", "hal2assemblyHub",
             [hal, tmp_path / "got", "--conservation", mod, "--numProc", "2",
              "--device", "cpu"], env={"HAL_TPU_TORCH_LAUNCH_LOG": str(log)})
    ja = jax_open(hal)
    for g in leaves:
        gdir = tmp_path / "got" / g
        want_wig = tmp_path / ("%s.wig" % g)
        run_tool("hal_tpu", "halPhyloP", ["--device", "on", hal, g, mod,
                                          want_wig])
        want, got = want_wig.read_text(), (gdir / (g + ".conservation.wig")).read_text()
        heads = [x for x in want.splitlines() if x.startswith("fixedStep")]
        assert heads and heads == [x for x in got.splitlines()
                                   if x.startswith("fixedStep")]
        gen = ja.open_genome(g)
        sc = jax_phylop.PhyloPScorer(ja, jax_phylop.NeutralModel.from_mod_file(mod),
                                     device="on")
        vals = np.concatenate([sc.score_window(g, int(gen.seq_start[i]),
                                               int(gen.seq_start[i + 1]))
                               for i in range(gen.num_sequences)])
        assert _near_rounding_boundary(vals, 3) == 0
        assert got == want
        sizes = {gen.seq_names[i]: int(gen.seq_length(i))
                 for i in range(gen.num_sequences)}
        ref_bw = str(tmp_path / ("%s.bw" % g))
        jax_bbi.wig_to_bigwig(str(want_wig), sizes, ref_bw)
        _h, chroms, runs, summary, _n = _decode_bigwig(
            str(gdir / (g + ".conservation.bw")))
        _wh, wchroms, wruns, wsummary, _wn = _decode_bigwig(ref_bw)
        assert chroms == wchroms and runs == wruns and summary == wsummary
        assert "track conservation" in (gdir / "trackDb.txt").read_text()
    tools = read_launch_log(log)
    phylop = tools["halPhyloP"]
    assert sorted(x["argv"][2] for x in phylop) == sorted(leaves)
    assert all(x["argv"][4:] == ["stdout", "--device", "cpu"] and x["launches"]
               for x in phylop)
    assert launched(phylop) == 0


def test_hub_cuda_job_failure_fails_the_hub(hub_hal, tmp_path):
    """With --device cuda and no card the alignability jobs raise, and the
    hub fails with them: no job falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    hal, _mod, _leaves, _d = hub_hal
    res = run_tool("hal_tpu_torch", "hal2assemblyHub",
                   [hal, tmp_path / "hub", "--alignability"], check=False)
    assert res.returncode != 0
    assert "halAlignmentDepth" in res.stderr and "no CUDA device" in res.stderr


@pytest.mark.cuda
def test_hub_cuda_equals_cpu(hub_hal, tmp_path):
    """On the card: the --device cuda hub equals the --device cpu hub, and
    its alignability jobs launched the three scan and search kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hal, _mod, _leaves, _d = hub_hal
    log = tmp_path / "launches.jsonl"
    run_tool("hal_tpu_torch", "hal2assemblyHub",
             [hal, tmp_path / "cuda"] + HUB_FLAGS,
             env={"HAL_TPU_TORCH_LAUNCH_LOG": str(log)})
    run_tool("hal_tpu_torch", "hal2assemblyHub",
             [hal, tmp_path / "cpu"] + HUB_FLAGS + ["--device", "cpu"])
    assert_same_tree(tmp_path / "cuda", tmp_path / "cpu")
    for x in read_launch_log(log)["halAlignmentDepth"]:
        assert all(x["launches"][k] for k in ("searchsorted_right",
                                              "cumsum_i32", "cummax_i32"))


def test_comparison_hub_equals_original(hub_hal, tmp_path):
    """halGenerateComparisonHub over two alignments: the same files, FASTA
    from the port's hal2fasta, and the same links."""
    hal, _mod, _leaves, d = hub_hal
    other = str(d / "t2.halz")
    if not os.path.exists(other):
        jax_save(jax_open(hal), other, fmt="halz")
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        run_tool(pkg, "halGenerateComparisonHub",
                 [tmp_path / pkg, hal, other, "--labels", "x,y"])
    want = assert_same_tree(tmp_path / "hal_tpu_torch", tmp_path / "hal_tpu")
    assert want["input_1.hal"] == ("link", other)
    assert any(k.endswith(".fa") and v for k, v in want.items())


def _mask_columns(text, names):
    """Replace the named columns of a ', '-separated table by '*'."""
    lines = text.splitlines()
    head = next(i for i, x in enumerate(lines) if not x.startswith("#"))
    cols = lines[head].split(", ")
    idx = [cols.index(n) for n in names]
    out = lines[:head + 1]
    for x in lines[head + 1:]:
        v = x.split(", ")
        for i in idx:
            v[i] = "*"
        out.append(", ".join(v))
    return "\n".join(out)


def test_lod_benchmark_equals_original(hub_hal, tmp_path):
    """halLodBenchmark --doBlockViz --doMaf --device cpu prints the
    original's table (time(s) masked) and writes the same MAF of each
    level; --format halz gives the same rows but the size columns, and its
    hal2maf runs logged zero launches."""
    hal, _mod, _leaves, _d = hub_hal
    args = [hal, None, "--steps", "2,4", "--doBlockViz", "--doMaf"]
    outs = {}
    for pkg, extra in (("hal_tpu", []), ("hal_tpu_torch", ["--device", "cpu"]),
                       ("halz", ["--device", "cpu", "--format", "halz"])):
        args[1] = tmp_path / pkg
        log = tmp_path / (pkg + ".jsonl")
        res = run_tool("hal_tpu" if pkg == "hal_tpu" else "hal_tpu_torch",
                       "halLodBenchmark", args + extra,
                       env={"HAL_TPU_TORCH_LAUNCH_LOG": str(log)})
        outs[pkg] = (res.stdout, log)
    want = _mask_columns(outs["hal_tpu"][0], ["time(s)"])
    assert "mafLines" in want and "queryFidelity" in want
    assert _mask_columns(outs["hal_tpu_torch"][0], ["time(s)"]) == want
    assert _mask_columns(outs["halz"][0], ["time(s)", "fileSize", "sizeRatio"]) \
        == _mask_columns(outs["hal_tpu"][0], ["time(s)", "fileSize", "sizeRatio"])
    for step in (2, 4):
        maf = (tmp_path / "hal_tpu" / ("lod%d.maf" % step)).read_bytes()
        assert maf.count(b"\ns\t") > 0
        for pkg in ("hal_tpu_torch", "halz"):
            assert (tmp_path / pkg / ("lod%d.maf" % step)).read_bytes() == maf
        assert os.path.isdir(tmp_path / "halz" / ("lod%d.halz" % step))
    for pkg in ("hal_tpu_torch", "halz"):
        tools = read_launch_log(outs[pkg][1])
        assert len(tools["halLodExtract"]) == 2 and len(tools["hal2maf"]) == 2
        assert all(x["argv"][-2:] == ["--device", "cpu"] and x["launches"]
                   for x in tools["hal2maf"])
        assert launched(tools["hal2maf"]) == 0
    assert not os.path.exists(outs["hal_tpu"][1])


def test_lod_extract_and_interpolate_equal_original(hub_hal, tmp_path):
    """halLodExtract (halz, --keepSequences, --onlyOrthologs) and
    halLodInterpolate (the manifest and every level) write the original's
    bytes."""
    hal, _mod, _leaves, _d = hub_hal
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        run_tool(pkg, "halLodExtract", [hal, out / "a.halz", "3"])
        run_tool(pkg, "halLodExtract", [hal, out / "b.halz", "7",
                                        "--keepSequences", "--onlyOrthologs"])
        # relative paths, as the manifest records them
        run_tool(pkg, "halLodInterpolate", [hal, "lod.txt", "--outHalDir",
                                            "lod", "--maxBlock", "8"],
                 cwd=str(out), env={"PYTHONPATH": REPO})
    want = assert_same_tree(tmp_path / "hal_tpu_torch", tmp_path / "hal_tpu")
    assert len(want["lod.txt"].splitlines()) > 2


def test_blockviz_tools_equal_original(hub_hal, tmp_path):
    """blockVizTest (--verbose --doSeq --doDupes) on an alignment and on a
    LOD manifest, and blockVizBenchmark (mean_ms masked), print the
    original's bytes."""
    hal, _mod, leaves, _d = hub_hal
    run_tool("hal_tpu", "halLodInterpolate", [hal, tmp_path / "lod.txt",
                                              "--maxBlock", "8"])
    aln = jax_open(hal)
    g = aln.open_genome(leaves[0])
    chrom, clen = g.seq_names[0], int(g.seq_length(0))
    n = 0
    for path in (hal, tmp_path / "lod.txt"):
        for q in aln.genome_names():
            if q == leaves[0]:
                continue
            args = [path, q, leaves[0], chrom, 0, clen, "--verbose",
                    "--doSeq", "--doDupes"]
            want = run_tool("hal_tpu", "blockVizTest", args)
            got = run_tool("hal_tpu_torch", "blockVizTest", args)
            assert (got.stdout, got.stderr) == (want.stdout, want.stderr)
            n += want.stdout.count("chr:")
    assert n
    args = [hal, leaves[0], "--maxLength", "1000", "--queriesPerLevel", "3",
            "--doDupes"]
    want = run_tool("hal_tpu", "blockVizBenchmark", args).stdout
    got = run_tool("hal_tpu_torch", "blockVizBenchmark", args).stdout
    assert len(want.splitlines()) > 2
    assert _mask_columns(got, ["mean_ms"]) == _mask_columns(want, ["mean_ms"])


def _maf_outputs(root):
    return {k: v for k, v in tree_bytes(root).items() if k.endswith(".maf")}


@pytest.mark.parametrize("flags", [
    ["--sliceSize", "37", "--numProc", "3"],
    ["--splitBySequence", "--sliceSize", "50", "--numProc", "2"],
    ["--refTargets", None, "--numProc", "2", "--noAncestors"],
], ids=["slices", "by-sequence", "ref-targets"])
def test_hal2mafMP_equals_original(hub_hal, tmp_path, flags):
    """hal2mafMP with --device cpu writes the original's MAF files: genome
    slices, per-sequence files of slices, and BED targets split across
    processes.  Every slice runs hal2maf --unique, which takes the native
    host engine before the device engine's modules are imported: no slice
    imports the kernels' module."""
    hal, _mod, leaves, _d = hub_hal
    g = jax_open(hal).open_genome(leaves[0])
    bed = tmp_path / "targets.bed"
    bed.write_text("".join("%s\t%d\t%d\n" % (g.seq_names[i], 2, g.seq_length(i) - 3)
                           for i in range(g.num_sequences)))
    flags = [str(bed) if f is None else f for f in flags]
    log = tmp_path / "launches.jsonl"
    for pkg, extra in (("hal_tpu", []), ("hal_tpu_torch", ["--device", "cpu"])):
        out = tmp_path / pkg
        out.mkdir()
        run_tool(pkg, "hal2mafMP", [hal, out / "o.maf", "--refGenome",
                                    leaves[0]] + flags + extra,
                 env={"HAL_TPU_TORCH_LAUNCH_LOG": str(log)})
    want = _maf_outputs(tmp_path / "hal_tpu")
    got = _maf_outputs(tmp_path / "hal_tpu_torch")
    assert want and got == want
    assert sum(v.count(b"\ns\t") for v in want.values()) > 0
    if "--splitBySequence" in flags:
        assert len(want) == g.num_sequences
    tools = read_launch_log(log)
    assert tools["hal2maf"] and all(x["launches"] is None and "--unique" in
                                    x["argv"] for x in tools["hal2maf"])
