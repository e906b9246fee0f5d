"""The port's alignment editing, import and generation tools on the CPU,
held to hal_tpu's on seeded fixtures, after tests/test_surgery.py,
test_modify_extract.py and test_maf2hal.py: the surgery tools
(halSetMetadata, halRenameGenomes, halRenameSequences,
halUpdateBranchLengths, halWriteNucleotides, halRemoveGenome,
halRemoveSubtree, halReplaceGenome, halAddToBranch, halAppendSubtree,
halExtract) run in process by both packages on the same file in halz,
mmap and hdf5, their output alignments equal field by field and their
exit code, stdout and stderr equal; maf2hal.import_maf, halTestGen and
halRandGen, equal; ancestorsML --device cpu (its likelihoods within rtol
1e-12 of hal_tpu's, the rewritten DNA byte-equal, or equal outside the
tie set at --thresholdN 0.3), ancestorsMLMP's commands and final file;
halPhyloPTrain with fake phast scripts; benchMark and runAndGetResources.
Tolerance: exact equality, but for the likelihoods (rtol 1e-12) and the
tie set (two largest posteriors within 1e-12, or the best within 1e-12 of
--thresholdN)."""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import three_genome_alignment
from hal_tpu import dna as jax_dna
from hal_tpu.alignment import Alignment as JaxAlignment
from hal_tpu.constants import NULL_INDEX
from hal_tpu.genome import GenomeArrays as JaxGenomeArrays
from hal_tpu.genome import SequenceInfo as JaxSequenceInfo
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.storage import open_alignment as jax_open
from hal_tpu.storage import save_alignment as jax_save
from hal_tpu.tools import ancestorsML as jax_aml
from hal_tpu.tools import ancestorsMLMP as jax_amlmp
from hal_tpu.tools import halTestGen as jax_testgen
from hal_tpu.tools import maf2hal as jax_maf2hal
from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import ancestorsML as port_aml
from hal_tpu_torch.tools import ancestorsMLMP as port_amlmp
from hal_tpu_torch.tools import halTestGen as port_testgen
from hal_tpu_torch.tools import maf2hal as port_maf2hal
from test_maf2hal import _export_maf
from test_surgery import _append_alignment
from test_torch_host_copies import _assert_same_alignment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXT = {"halz": ".halz", "mmap": ".mmap", "hdf5": ".hal"}
# three levels (Genome_0 -> Genome_1 -> Genome_6), reversed blocks,
# unaligned child segments, DNA
FIXTURE = dict(seed=3, max_genomes=7, min_genomes=5, mean_degree=1.4,
               min_segments=50, max_segments=150, min_segment_length=5,
               max_segment_length=40, store_dna=True)
TIE = 1e-12


def _tool(pkg, name):
    import importlib

    return importlib.import_module("%s.tools.%s" % (pkg, name))


def _run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def _run_cli(pkg, tool, args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "%s.tools.%s" % (pkg, tool)]
                          + [str(a) for a in args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def _same(port, jax):
    """Alignment files equal field by field, the alignments' metadata too;
    each opened by its own package."""
    a, b = open_alignment(str(port)), jax_open(str(jax))
    assert a.metadata == b.metadata
    _assert_same_alignment(a, b)


def _random_fixture():
    aln = jax_random_alignment(**FIXTURE)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    inner = next(n for n in aln.genome_names()
                 if aln.tree.parent(n) and not aln.tree.is_leaf(n))
    return aln, dict(root=aln.root_name, inner=inner, leaf=leaves[-1],
                     inner_leaf=aln.tree.children(inner)[0])


NAMES = _random_fixture()[1]


def _inputs_random(d, fmt):
    aln = _random_fixture()[0]
    paths = {"aln": d / ("aln" + EXT[fmt]), "donor": d / ("donor" + EXT[fmt]),
             "out": d / ("out" + EXT[fmt]), "halz_out": d / "conv.halz"}
    jax_save(aln, str(paths["aln"]), fmt=fmt)
    jax_save(aln, str(paths["donor"]), fmt=fmt)
    g = aln.open_genome(NAMES["inner"])
    leaf = aln.open_genome(NAMES["leaf"])
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    root_base = aln.open_genome(NAMES["root"]).get_dna_string(0, 1)
    edits = {
        "renames": "%s\tInner_new\n%s\tLeaf_new\n" % (NAMES["inner"],
                                                      NAMES["leaf"]),
        "rename_clash": "%s\t%s\n" % (NAMES["leaf"], NAMES["root"]),
        "seq_renames": "%s\tfirst_new\n" % g.seq_names[0],
        "seq_missing": "nope\tother\n",
        # the second line matches on the reverse strand only
        "writes": "%s\t5\t%s\tC\n%s\t7\t%s\tg\n\n%s\t0\t%s\tA\n" % (
            NAMES["leaf"], leaf.get_dna_string(5, 1).lower(), NAMES["inner"],
            comp[g.get_dna_string(7, 1).upper()], NAMES["root"], root_base),
        "writes_bad": "%s\t3\tX\tA\n" % NAMES["leaf"],
    }
    for k, text in edits.items():
        paths[k] = d / (k + ".tsv")
        paths[k].write_text(text)
    newick = aln.tree.to_newick()
    paths["newick"] = re.sub(r":[0-9.eE+-]+", ":2.5", newick)
    paths["newick_bad"] = newick.replace(NAMES["inner_leaf"], "Stranger")
    return paths


def _branch_donors():
    """halAddToBranch's donors for three_genome_alignment: the bottom
    alignment rooted at the insert I over A (1:1) and the new leaf L
    (1:1), and the top alignment, the main one with A renamed I."""
    main = three_genome_alignment()
    a_dna = main.open_genome("A").get_dna(0, 25)
    bot = JaxAlignment()
    bot.add_root_genome("I", [JaxSequenceInfo("I_seq", 25, 0, 5)])
    bot.tree.add_child("I", "A", 0.05)
    bot.tree.add_child("I", "L", 0.07)
    ig = bot.open_genome("I")
    ig.bot_start[:-1] = np.arange(5) * 5
    ig.bot_child = np.stack([np.arange(5), np.arange(5)], 1).astype(np.int64)
    ig.bot_child_reversed = np.zeros((5, 2), np.uint8)
    ig.set_dna(0, a_dna)
    for name in ("A", "L"):
        g = JaxGenomeArrays.create(name, [JaxSequenceInfo(name + "_seq", 25,
                                                          5, 0)])
        g.top_start[:-1] = np.arange(5) * 5
        g.top_parent = np.arange(5, dtype=np.int64)
        g.set_dna(0, a_dna)
        bot.set_genome(g)
    top = three_genome_alignment()
    top.rename_genome("A", "I")
    return bot, top


def _inputs_three(d, fmt):
    paths = {"aln": d / ("aln" + EXT[fmt]), "app": d / ("app" + EXT[fmt]),
             "app_new": d / ("app_new" + EXT[fmt]),
             "bot": d / ("bot" + EXT[fmt]), "top": d / ("top" + EXT[fmt])}
    jax_save(three_genome_alignment(), str(paths["aln"]), fmt=fmt)
    jax_save(_append_alignment(), str(paths["app"]), fmt=fmt)
    new = _append_alignment()
    new.rename_genome("A", "C")
    new.rename_genome("A1", "C1")
    jax_save(new, str(paths["app_new"]), fmt=fmt)
    bot, top = _branch_donors()
    jax_save(bot, str(paths["bot"]), fmt=fmt)
    jax_save(top, str(paths["top"]), fmt=fmt)
    return paths


# name: (tool, inputs, argv given the inputs, exit code)
N = NAMES
SURGERY = {
    "setMetadata": ("halSetMetadata", _inputs_random,
                    lambda p: [p["aln"], "k1", "v1"], 0),
    "setMetadata_genome": ("halSetMetadata", _inputs_random, lambda p: [
        p["aln"], "gk", "gv", "--genome", N["inner"]], 0),
    "renameGenomes": ("halRenameGenomes", _inputs_random,
                      lambda p: [p["aln"], p["renames"]], 0),
    "renameGenomes_clash": ("halRenameGenomes", _inputs_random,
                            lambda p: [p["aln"], p["rename_clash"]], 1),
    "renameSequences": ("halRenameSequences", _inputs_random, lambda p: [
        p["aln"], N["inner"], p["seq_renames"]], 0),
    "renameSequences_missing": ("halRenameSequences", _inputs_random,
                                lambda p: [p["aln"], N["inner"],
                                           p["seq_missing"]], 1),
    "updateBranchLengths": ("halUpdateBranchLengths", _inputs_random,
                            lambda p: [p["aln"], p["newick"]], 0),
    "updateBranchLengths_bad": ("halUpdateBranchLengths", _inputs_random,
                                lambda p: [p["aln"], p["newick_bad"]], 1),
    "writeNucleotides": ("halWriteNucleotides", _inputs_random,
                         lambda p: [p["aln"], p["writes"]], 0),
    "writeNucleotides_bad": ("halWriteNucleotides", _inputs_random,
                             lambda p: [p["aln"], p["writes_bad"]], 1),
    "removeGenome": ("halRemoveGenome", _inputs_random,
                     lambda p: [p["aln"], N["leaf"]], 0),
    "removeGenome_noMark": ("halRemoveGenome", _inputs_random, lambda p: [
        p["aln"], N["inner_leaf"], "--noMarkAncestors"], 0),
    "removeSubtree": ("halRemoveSubtree", _inputs_random,
                      lambda p: [p["aln"], N["inner"]], 0),
    "replaceGenome": ("halReplaceGenome", _inputs_random, lambda p: [
        p["aln"], N["inner"], "--topAlignmentFile", p["donor"],
        "--bottomAlignmentFile", p["donor"]], 0),
    "replaceGenome_missing": ("halReplaceGenome", _inputs_random, lambda p: [
        p["aln"], "Nowhere", "--topAlignmentFile", p["donor"]], 1),
    "extract_subtree": ("halExtract", _inputs_random, lambda p: [
        p["aln"], p["out"], "--root", N["inner"]], 0),
    "extract_convert": ("halExtract", _inputs_random, lambda p: [
        p["aln"], p["halz_out"], "--outputFormat", "halz"], 0),
    "appendSubtree": ("halAppendSubtree", _inputs_three,
                      lambda p: [p["aln"], p["app"], "Anc", "A"], 0),
    "appendSubtree_new_leaf": ("halAppendSubtree", _inputs_three, lambda p: [
        p["aln"], p["app_new"], "Anc", "C", "--branchLength", "0.3"], 0),
    "addToBranch": ("halAddToBranch", _inputs_three, lambda p: [
        p["aln"], p["bot"], p["top"], "Anc", "I", "A", "L", "0.05",
        "0.07"], 0),
}


@pytest.mark.parametrize("fmt", sorted(EXT))
@pytest.mark.parametrize("case", sorted(SURGERY))
def test_surgery_equals_original(tmp_path, case, fmt):
    """Each surgery tool of the port, run on the same file as hal_tpu's
    (the same path, made anew), leaves an equal alignment with the same
    exit code, stdout and stderr; the written files validate."""
    tool, inputs, argv, rc = SURGERY[case]
    work = tmp_path / "work"
    runs = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        work.mkdir()
        got = _run(_tool(pkg, tool), argv(inputs(work, fmt)))
        assert got[0] == rc, (pkg, got[2])
        runs[pkg] = got
        shutil.move(str(work), str(tmp_path / pkg))
    assert runs["hal_tpu_torch"] == runs["hal_tpu"]
    if rc:
        assert "hal exception caught" in runs["hal_tpu"][2]
    names = sorted(os.listdir(tmp_path / "hal_tpu"))
    assert sorted(os.listdir(tmp_path / "hal_tpu_torch")) == names
    from hal_tpu_torch.ops.validate import validate_alignment

    for name in names:
        if name.endswith(".tsv"):
            continue
        port, jax = tmp_path / "hal_tpu_torch" / name, tmp_path / "hal_tpu" / name
        _same(port, jax)
        if not rc:
            validate_alignment(open_alignment(str(port)))


# ------------------------------------------------------ import, generation

def _mafs():
    big = jax_random_alignment(seed=8, max_genomes=5, min_genomes=4,
                               mean_degree=2.0, min_segments=20,
                               max_segments=60, min_segment_length=5,
                               max_segment_length=30, store_dna=True)
    return {"three": _export_maf(three_genome_alignment(), "Anc"),
            "random": _export_maf(big, big.root_name)}


MAFS = _mafs()


@pytest.mark.parametrize("maf", sorted(MAFS))
def test_import_maf_equals_original(maf):
    for ref in (None, "Anc" if maf == "three" else "Genome_0"):
        a = port_maf2hal.import_maf(io.StringIO(MAFS[maf]), ref)
        b = jax_maf2hal.import_maf(io.StringIO(MAFS[maf]), ref)
        _assert_same_alignment(a, b)


def test_test_alignment_equals_original():
    _assert_same_alignment(port_testgen.build_test_alignment(),
                           jax_testgen.build_test_alignment())


WRITERS = {
    "maf2hal": ("maf2hal", lambda d: [d / "in.maf"], []),
    "maf2hal_targets": ("maf2hal", lambda d: [d / "in.maf"],
                        ["--targetGenomes", "Genome_1,Genome_2"]),
    "halTestGen": ("halTestGen", lambda d: [], []),
    "halRandGen_preset": ("halRandGen", lambda d: [],
                          ["--preset", "small", "--seed", "2"]),
    "halRandGen": ("halRandGen", lambda d: [], [
        "--seed", "5", "--maxGenomes", "4", "--minSegments", "3",
        "--maxSegments", "30", "--maxSegmentLength", "40"]),
}


@pytest.mark.parametrize("ext", [".halz", ".hal"])
@pytest.mark.parametrize("case", sorted(WRITERS))
def test_writers_equal_original(tmp_path, case, ext):
    """maf2hal, halTestGen and halRandGen write equal alignments (halz, or
    hdf5 by the .hal extension) with equal stdout and stderr."""
    tool, head, tail = WRITERS[case]
    (tmp_path / "in.maf").write_text(MAFS["random"])
    runs = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        out = tmp_path / ("out" + ext)
        runs[pkg] = _run(_tool(pkg, tool), head(tmp_path) + [out] + tail)
        assert runs[pkg][0] == 0, runs[pkg]
        shutil.move(str(out), str(tmp_path / (pkg + ext)))
    assert runs["hal_tpu_torch"] == runs["hal_tpu"]
    _same(tmp_path / ("hal_tpu_torch" + ext), tmp_path / ("hal_tpu" + ext))


# -------------------------------------------------------------- ancestorsML

def _ml_fixture():
    """FIXTURE with soft-masked runs and N runs in its leaves."""
    aln = jax_random_alignment(**FIXTURE)
    for name in aln.genome_names():
        if aln.tree.is_leaf(name):
            g = aln.open_genome(name)
            for s in range(0, g.length - 9, 97):
                g.set_dna(s, g.get_dna_string(s, 6).lower())
                g.set_dna(s + 6, "Nnn")
    return aln


def _tie_set(L, threshold):
    post = L / np.maximum(L.sum(axis=1, keepdims=True), 1e-300)
    top = np.sort(post, axis=1)
    return (top[:, 3] - top[:, 2] <= TIE) | (np.abs(top[:, 3] - threshold)
                                             <= TIE)


def test_ml_fixture_has_what_the_pass_maps():
    aln = _ml_fixture()
    rev = unaligned = 0
    for name in aln.genome_names():
        g = aln.open_genome(name)
        if aln.tree.parent(name):
            rev += int((np.asarray(g.top_parent_reversed)
                        & (np.asarray(g.top_parent) >= 0)).sum())
        if aln.tree.children(name):
            unaligned += int((np.asarray(g.bot_child) < 0).sum())
    leaf = aln.open_genome(NAMES["leaf"]).get_dna(0, 60)
    assert rev > 10 and unaligned > 10
    assert (leaf >= 97).any() and (leaf == ord("N")).any() and \
        (leaf == ord("n")).any()


def _with_empty_child(aln):
    """aln with a leaf of length 0 added under the root, unaligned."""
    root = NAMES["root"]
    aln.add_leaf_genome("Empty", root, 0.1)
    g = aln.open_genome(root)
    g.bot_child = np.concatenate([g.bot_child, np.full(
        (g.bot_child.shape[0], 1), NULL_INDEX, g.bot_child.dtype)], 1)
    g.bot_child_reversed = np.concatenate([g.bot_child_reversed, np.zeros(
        (g.bot_child.shape[0], 1), g.bot_child_reversed.dtype)], 1)
    assert aln.open_genome("Empty").length == 0
    return aln


@pytest.mark.parametrize("genome", ["root", "inner", "root_empty_child"])
def test_likelihoods_equal_original(genome):
    """The device pass on the CPU: L within rtol 1e-12 of hal_tpu's (also
    with a child of length 0, which contributes the prior)."""
    aln = _ml_fixture()
    if genome == "root_empty_child":
        aln, genome = _with_empty_child(aln), "root"
    want = jax_aml._likelihoods_for(aln, NAMES[genome])
    got = port_aml._likelihoods_for(aln, NAMES[genome], "cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_likelihoods_use_the_scan_not_a_segment_loop(monkeypatch):
    """The segment map is one cummax_i32 a child, no Python loop over
    segments: a fixture of many segments maps with one scan call a child."""
    from hal_tpu_torch.ops import kernels

    calls = []
    real = kernels.cummax_i32
    monkeypatch.setattr(kernels, "cummax_i32",
                        lambda x: calls.append(x.shape[0]) or real(x))
    aln = _ml_fixture()
    port_aml._likelihoods_for(aln, NAMES["root"], "cpu")
    inner = [n for n in aln.genome_names() if aln.tree.children(n)]
    assert len(calls) == sum(len(aln.tree.children(n)) for n in inner)


@pytest.mark.parametrize("fmt", sorted(EXT))
@pytest.mark.parametrize("threshold", [None, "0.3"])
def test_ancestors_ml_cli_equals_original(tmp_path, fmt, threshold):
    """ancestorsML --device cpu --printWrites on the root rewrites the DNA
    hal_tpu's does (at --thresholdN 0.3: equal outside the tie set), the
    other genomes and the tables untouched, the same stderr."""
    aln = _ml_fixture()
    extra = ["--thresholdN", threshold] if threshold else []
    runs = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        path = tmp_path / ("aln" + EXT[fmt])
        jax_save(aln, str(path), fmt=fmt)
        device = ["--device", "cpu"] if pkg == "hal_tpu_torch" else []
        runs[pkg] = _run(_tool(pkg, "ancestorsML"), [
            path, NAMES["root"], "--printWrites"] + extra + device)
        assert runs[pkg][0] == 0, runs[pkg]
        shutil.move(str(path), str(tmp_path / pkg))
    assert runs["hal_tpu_torch"] == runs["hal_tpu"]
    assert runs["hal_tpu"][2].startswith("ancestorsML: rewrote ")
    port, jax = open_alignment(str(tmp_path / "hal_tpu_torch")), \
        jax_open(str(tmp_path / "hal_tpu"))
    if threshold is None:
        _assert_same_alignment(port, jax)
        return
    L = jax_aml._likelihoods_for(aln, NAMES["root"])
    ties = _tie_set(L, float(threshold))
    n = L.shape[0]
    a = port.open_genome(NAMES["root"]).get_dna(0, n)
    b = jax.open_genome(NAMES["root"]).get_dna(0, n)
    assert np.array_equal(a[~ties], b[~ties])
    for name in aln.genome_names():
        if name != NAMES["root"]:
            ga, gb = port.open_genome(name), jax.open_genome(name)
            assert np.array_equal(np.asarray(ga.dna), np.asarray(gb.dna))


def test_ancestors_ml_leaf_and_cuda_without_card(tmp_path):
    """A leaf is refused with hal_tpu's message; --device cuda (the
    default) with no CUDA device raises HalError and writes nothing."""
    path = tmp_path / "aln.halz"
    jax_save(_ml_fixture(), str(path), fmt="halz")
    before = open_alignment(str(path)).open_genome(NAMES["root"]).get_dna(
        0, 50).tobytes()
    want = _run(jax_aml, [path, NAMES["leaf"]])
    assert _run(port_aml, [path, NAMES["leaf"], "--device", "cpu"]) == want
    assert want[0] == 1 and "is not ancestral" in want[2]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    rc, out, err = _run(port_aml, [path, NAMES["root"]])
    assert rc == 1 and out == ""
    assert "hal exception caught: --device cuda: no CUDA device" in err
    assert open_alignment(str(path)).open_genome(NAMES["root"]).get_dna(
        0, 50).tobytes() == before


@pytest.mark.cuda
def test_ancestors_ml_cuda_equals_cpu():
    """On the card: L within rtol 1e-12 of the CPU pass, and the calls
    equal outside the tie set."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda)")
    from hal_tpu_torch.ops import kernels

    aln = _ml_fixture()
    kernels.reset_launches()
    got = port_aml._likelihoods_for(aln, NAMES["root"], "cuda").cpu().numpy()
    assert kernels.launches()["cummax_i32"] > 0
    want = port_aml._likelihoods_for(aln, NAMES["root"], "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    ties = _tie_set(want, 0.9)
    a = port_aml._posterior_calls(torch.from_numpy(got).cuda(), 0.9)
    b = port_aml._posterior_calls(torch.from_numpy(want), 0.9)
    assert np.array_equal(a[~ties], b[~ties])


# ------------------------------------------------- ancestorsMLMP, phyloP

def test_ancestors_mlmp_commands_equal_original(monkeypatch):
    """Both packages give their ancestorsML the ancestors bottom-up, one
    command a genome; the port's run its own module with --device."""
    aln = _ml_fixture()
    cmds = {}
    for pkg, mod in (("hal_tpu", jax_amlmp), ("hal_tpu_torch", port_amlmp)):
        seen = cmds[pkg] = []
        monkeypatch.setattr(mod, "get_hal_genomes",
                            lambda path: aln.genome_names())
        monkeypatch.setattr(mod, "get_hal_child_names",
                            lambda path, g: aln.tree.children(g))
        monkeypatch.setattr(mod, "run_parallel_shell_commands",
                            lambda c, n, seen=seen: seen.append((c, n)))
        extra = ["--device", "cpu"] if pkg == "hal_tpu_torch" else []
        assert _run(mod, ["x.halz", "--model", "m.mod"] + extra)[0] == 0
    want = [([c[0].replace("-m hal_tpu.tools.ancestorsML x.halz %s"
                           % c[0].split()[4], "-m hal_tpu_torch.tools."
                           "ancestorsML x.halz %s --device cpu"
                           % c[0].split()[4])], n)
            for c, n in cmds["hal_tpu"]]
    assert cmds["hal_tpu_torch"] == want
    order = [c[0].split()[4] for c, _n in cmds["hal_tpu"]]
    assert order == [g for g in reversed(aln.genome_names())
                     if aln.tree.children(g)] and len(order) >= 2


def test_ancestors_mlmp_file_equals_original(tmp_path):
    """The whole ancestorsMLMP run (its halStats and ancestorsML
    processes) on a small file: equal final alignments."""
    aln = jax_random_alignment(**dict(FIXTURE, min_segments=5,
                                      max_segments=20))
    assert sum(1 for n in aln.genome_names() if aln.tree.children(n)) >= 2
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        path = tmp_path / (pkg + ".halz")
        jax_save(aln, str(path), fmt="halz")
        extra = ["--device", "cpu"] if pkg == "hal_tpu_torch" else []
        r = _run_cli(pkg, "ancestorsMLMP", [path] + extra)
        assert r.returncode == 0 and r.stdout == "", r.stderr[-2000:]
    _same(tmp_path / "hal_tpu_torch.halz", tmp_path / "hal_tpu.halz")


FAKE_PHAST = """#!%s
import json, os, shutil, sys
log = os.environ["FAKE_PHAST_LOG"]
with open(log, "a") as f:
    f.write(json.dumps(sys.argv) + "\\n")
if os.path.basename(sys.argv[0]) == "phyloFit":
    shutil.copy(sys.argv[-1], log + ".maf")
"""


def test_phylop_train_jobs_and_message(tmp_path):
    """halPhyloPTrain with fake phyloFit / msa_view scripts on PATH: the
    port's jobs are its own hal4dExtract and hal2maf with --device cpu,
    phyloFit gets the arguments and the 4d MAF hal_tpu's gives it; with
    no phast on PATH both raise the same HalError."""
    hal = tmp_path / "aln.halz"
    aln = jax_random_alignment(seed=9, max_genomes=3, min_segments=10,
                               max_segments=10, min_segment_length=30,
                               max_segment_length=40, store_dna=True)
    jax_save(aln, str(hal), fmt="halz")
    g = aln.open_genome(aln.root_name)
    bed = tmp_path / "genes.bed"
    bed.write_text("%s\t0\t90\tgene1\t0\t+\t0\t90\t0\t1\t90,\t0,\n"
                   % g.seq_names[0])
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name in ("phyloFit", "msa_view"):
        (bindir / name).write_text(FAKE_PHAST % sys.executable)
        (bindir / name).chmod(0o755)
    seen = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        log = tmp_path / (pkg + ".log")
        env = dict(os.environ, PATH="%s:%s" % (bindir, os.environ["PATH"]),
                   FAKE_PHAST_LOG=str(log),
                   HAL_TPU_TORCH_LAUNCH_LOG=str(tmp_path / (pkg + ".jobs")))
        extra = ["--device", "cpu"] if pkg == "hal_tpu_torch" else []
        r = _run_cli(pkg, "halPhyloPTrain", [hal, aln.root_name, bed,
                                             tmp_path / "out.mod"] + extra,
                     env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        argv = [json.loads(x) for x in log.read_text().splitlines()]
        assert [os.path.basename(a[0]) for a in argv] == ["phyloFit"]
        seen[pkg] = (argv[0][1:-1], (tmp_path / (pkg + ".log.maf")).read_text())
    assert seen["hal_tpu_torch"] == seen["hal_tpu"]
    assert "\ns\t" in seen["hal_tpu"][1] and "--subst-mod" in seen["hal_tpu"][0]
    jobs = [json.loads(x)["argv"] for x in
            (tmp_path / "hal_tpu_torch.jobs").read_text().splitlines()]
    tools = {os.path.basename(a[0]): a[1:] for a in jobs}
    for tool in ("hal4dExtract", "hal2maf"):
        args = tools[tool + ".py"]
        assert args[args.index("--device") + 1] == "cpu", args
    assert not (tmp_path / "hal_tpu.jobs").exists()
    empty = tmp_path / "empty"
    empty.mkdir()
    msgs = []
    for mod in (_tool("hal_tpu", "halPhyloPTrain"),
                _tool("hal_tpu_torch", "halPhyloPTrain")):
        old = os.environ["PATH"]
        os.environ["PATH"] = str(empty)
        try:
            msgs.append(_run(mod, [hal, aln.root_name, bed, "x.mod"]))
        finally:
            os.environ["PATH"] = old
    assert msgs[0] == msgs[1] and msgs[0][0] == 1
    assert "halPhyloPTrain requires the phast package (phyloFit not found" \
        in msgs[0][2]


# ----------------------------------------------- benchMark, resources

def test_bench_mark_equals_original():
    """benchMark --formats halz,mmap: the header and the rows but for the
    seconds (the formats, chunks, compressions and sizes) equal."""
    rows = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        rc, out, err = _run(_tool(pkg, "benchMark"), [
            "--formats", "halz,mmap", "--maxGenomes", "4", "--maxSegments",
            "40", "--seed", "3"])
        assert rc == 0 and err == "", err
        lines = out.splitlines()
        rows[pkg] = [lines[0]] + [x.split(", ")[:3] + x.split(", ")[5:]
                                  for x in lines[1:]]
    assert rows["hal_tpu_torch"] == rows["hal_tpu"]
    assert rows["hal_tpu"][0] == "format, chunk, comp, time(gen), " \
        "time(cons), fsize(k)"
    assert [x[0] for x in rows["hal_tpu"][1:]] == ["halz", "mmap"]


@pytest.mark.parametrize("command,rc", [("true", 0), ("exit 3", 3)])
def test_run_and_get_resources_equals_original(command, rc):
    """runAndGetResources prints (seconds, max RSS kb) and exits with the
    command's code."""
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        r = _run_cli(pkg, "runAndGetResources", command.split())
        assert r.returncode == rc, r.stderr
        assert re.fullmatch(r"\([0-9]+\.[0-9]{3}, [0-9]+\)\n", r.stdout), \
            r.stdout


def test_available_tools_equal_original():
    """python -m hal_tpu_torch lists every tool python -m hal_tpu lists."""
    import hal_tpu.__main__ as jax_main
    import hal_tpu_torch.__main__ as port_main

    assert port_main.available_tools() == jax_main.available_tools()
    assert {"ancestorsML", "maf2hal", "halAddToBranch", "benchMark"} <= set(
        port_main.available_tools())


def test_write_nucleotides_reverse_strand_line_is_a_complement():
    """The fixture's second edit matches only through the reverse strand
    (hal_tpu's retry), so that the cases above exercise it."""
    aln = _random_fixture()[0]
    cur = aln.open_genome(NAMES["inner"]).get_dna_string(7, 1)
    rc = jax_dna.reverse_complement(cur.encode()).tobytes().decode()
    assert cur.upper() != rc.upper()
