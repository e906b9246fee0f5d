"""The port's region and SNP tools (findRegionsExclusivelyInGroup,
halSingleCopyRegionsExtract, hal4dExtract --conserved, halSnps,
halContiguousRegions) and the batched mapper's map_source order, on the
CPU against the JAX package's host mapper and CLIs.

- BatchMapper.dispatch(ordered=True) + atomize_by_owner gives, per owner,
  map_source's rows element for element, order included, on up, down,
  across-the-MRCA and self paths, with and without dupes; paths with a
  coalescence limit above the MRCA are not reproduced (strict xfail).
- PathData.build(host_paralogies=True)'s self-map equals map_source's base
  pairs per window; the default (segmap_jax's) para branches add some.
- Each CLI with --device cpu, as a `python -m` subprocess: out files,
  stdout, stderr and exit code byte-equal to hal_tpu's; run in process
  with segmap_host.map_source refused; --device cuda without a card.
Tolerance: exact equality throughout."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hal_tpu.ops import segmap_host as jax_sm
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.storage import save_alignment as jax_save
from hal_tpu_torch.ops import segmap_host as port_sm
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.ops.liftover_bulk import atomize_by_owner
from hal_tpu_torch.randgen import create_random_alignment
from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import (_regions, findRegionsExclusivelyInGroup,
                                 hal4dExtract, halContiguousRegions,
                                 halSingleCopyRegionsExtract, halSnps)
from naive_oracle import fragments_to_base_pairs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every random fixture carries paralogy rings; this one's tree is four
# levels deep (Genome_7 under Genome_6, Genome_5, Genome_4, Genome_2), and
# halContiguousRegions to Genome_7 reads map_source's order
FIXTURE = dict(seed=3, max_genomes=8, min_segments=300, max_segments=600)
ORDER_FIXTURE = dict(max_genomes=8, min_segments=30, max_segments=80)


def _rows(f):
    return list(zip(*(np.asarray(a).tolist() for a in
                      (f.src_lo, f.src_hi, f.tgt_lo, f.tgt_hi, f.rev))))


def _kind(tree, src, tgt):
    mrca = tree.lca(src, tgt)
    return ("self" if src == tgt else "up" if mrca == tgt
            else "down" if mrca == src else "across")


def _ordered_rows(aln, src, tgt, lo, hi, owners, **opts):
    """Per owner, the rows of one ordered dispatch, atomized."""
    mapper = st.BatchMapper(aln, src, tgt, device="cpu", **opts)
    f6 = mapper.decode(mapper.dispatch(lo, hi, owners, cap_mult=1,
                                       ordered=True))
    scale = int(max(aln.open_genome(src).length,
                    aln.open_genome(tgt).length) + 2)
    a = atomize_by_owner(*f6[:4], f6[4].astype(np.uint8), f6[5], scale)
    return {int(k): list(zip(*(x[a[5] == k].tolist() for x in a[:5])))
            for k in owners}


def _windows(rng, length, n=6):
    lo = np.sort(rng.integers(0, length - 1, n))
    return lo, np.minimum(lo + rng.integers(1, length, n), length)


@pytest.mark.parametrize("dupes", [True, False], ids=["dupes", "noDupes"])
@pytest.mark.parametrize("seed", [2, 4, 9])
def test_ordered_dispatch_equals_map_source_rows_and_order(seed, dupes):
    """Every ordered genome pair of a fixture with paralogy rings, six
    random intervals each under shuffled owners, at a capacity that
    overflows and reruns: per owner, the atomized rows equal map_source's,
    order included.  With dupes, the device's own order (atomize_by_owner
    over the unordered dispatch) differs on some owners."""
    aln = create_random_alignment(seed=seed, **ORDER_FIXTURE)
    names = aln.genome_names()
    rng = np.random.default_rng(seed)
    kinds, checked, reordered = set(), 0, 0
    for src in names:
        g = aln.open_genome(src)
        if g.length < 10:
            continue
        for tgt in names:
            lo, hi = _windows(rng, g.length)
            owners = rng.permutation(len(lo))
            got = _ordered_rows(aln, src, tgt, lo, hi, owners,
                                do_dupes=dupes)
            mapper = st.BatchMapper(aln, src, tgt, do_dupes=dupes,
                                    device="cpu")
            raw = mapper.decode(mapper.dispatch(lo, hi, owners))
            scale = int(max(g.length, aln.open_genome(tgt).length) + 2)
            naive = atomize_by_owner(*raw[:4], raw[4].astype(np.uint8),
                                     raw[5], scale)
            for i, k in enumerate(owners.tolist()):
                want = _rows(port_sm.map_source(
                    aln, src, lo[i:i + 1], hi[i:i + 1], tgt,
                    do_dupes=dupes))
                assert got[k] == want, (src, tgt, i)
                assert want == _rows(jax_sm.map_source(
                    aln, src, lo[i:i + 1], hi[i:i + 1], tgt,
                    do_dupes=dupes))
                mine = list(zip(*(x[naive[5] == k].tolist()
                                  for x in naive[:5])))
                assert sorted(mine) == sorted(want)
                reordered += mine != want
                checked += 1
            kinds.add(_kind(aln.tree, src, tgt))
    assert kinds == {"self", "up", "down", "across"} and checked > 200
    assert (reordered > 0) == dupes


def test_ordered_dispatch_reranks_the_key(monkeypatch):
    """With the key's limit cut to 4, every ring level re-ranks the key
    densely: the rows and their order stay map_source's."""
    monkeypatch.setattr(st, "_KEY_LIMIT", 4)
    aln = create_random_alignment(seed=3, **ORDER_FIXTURE)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    rng = np.random.default_rng(1)
    rings = []
    for src, tgt in ((leaves[0], leaves[-1]), (leaves[-1], leaves[0])):
        g = aln.open_genome(src)
        lo, hi = _windows(rng, g.length)
        path = st.PathData.build(aln, src, tgt, device="cpu")
        rings.append(sum(lv.max_ring > 0 for lv in path.levels))
        got = _ordered_rows(aln, src, tgt, lo, hi, np.arange(len(lo)))
        for i in range(len(lo)):
            assert got[i] == _rows(port_sm.map_source(
                aln, src, lo[i:i + 1], hi[i:i + 1], tgt))
    assert max(rings) >= 3


@pytest.mark.xfail(strict=True, raises=ValueError,
                   reason="map_source's order on a path with a coalescence "
                          "limit above the MRCA is not reproduced "
                          "(ROADMAP §3); the ordered dispatch refuses it")
@pytest.mark.parametrize("self_map", [True, False], ids=["self", "pair"])
def test_ordered_dispatch_on_coalescence_paths(self_map):
    """The self-map and a leaf pair, each up to the root: per owner, the
    rows in map_source's order."""
    aln = create_random_alignment(seed=3, **ORDER_FIXTURE)
    root = aln.root_name
    names = aln.genome_names()
    src, tgt = next((s, t) for s in names for t in names
                    if (s == t) == self_map and aln.tree.is_leaf(s)
                    and len(aln.tree.path(aln.tree.lca(s, t), root)) > 2)
    g = aln.open_genome(src)
    lo, hi = _windows(np.random.default_rng(2), g.length)
    got = _ordered_rows(aln, src, tgt, lo, hi, np.arange(len(lo)),
                        coalescence_limit=root, host_paralogies=True)
    for i in range(len(lo)):
        assert got[i] == _rows(port_sm.map_source(
            aln, src, lo[i:i + 1], hi[i:i + 1], tgt,
            coalescence_limit=root))


def _base_pairs(frags, owners):
    out = {}
    for k in np.unique(owners).tolist():
        m = owners == k
        f = port_sm.Fragments(*(np.asarray(a)[m] for a in frags[:4]),
                              np.asarray(frags[4])[m].astype(np.uint8))
        out[k] = fragments_to_base_pairs(f)
    return out


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_self_map_host_paralogies_equals_map_source_base_pairs(seed):
    """halSingleCopyRegionsExtract's self-map (ref -> ref up to the root)
    of every leaf whose chain to the root holds three genomes or more, in
    windows: with host_paralogies the batched mapper's base pairs equal
    map_source's in every window; segmap_jax's default para branches add
    base pairs in some (ROADMAP §3)."""
    aln = create_random_alignment(seed=seed, **ORDER_FIXTURE)
    root = aln.root_name
    rng = np.random.default_rng(seed)
    checked, extra = 0, 0
    for ref in aln.genome_names():
        g = aln.open_genome(ref)
        if len(aln.tree.path(ref, root)) < 3 or g.length < 10:
            continue
        lo, hi = _windows(rng, g.length)
        want = {}
        for i in range(len(lo)):
            want[i] = fragments_to_base_pairs(port_sm.map_source(
                aln, ref, lo[i:i + 1], hi[i:i + 1], ref,
                coalescence_limit=root))
        for host in (True, False):
            mapper = st.BatchMapper(aln, ref, ref, coalescence_limit=root,
                                    host_paralogies=host, device="cpu")
            f6 = mapper.decode(mapper.dispatch(lo, hi))
            got = _base_pairs(f6, f6[5])
            for i in range(len(lo)):
                if host:
                    assert got.get(i, set()) == want[i], (ref, i)
                else:
                    assert got.get(i, set()) >= want[i]
                    extra += got.get(i, set()) != want[i]
        checked += 1
    assert checked >= 2 and extra > 0


# ------------------------------------------------------------------ CLIs

def run_tool(pkg, tool, args, device=True):
    argv = [sys.executable, "-m", "%s.tools.%s" % (pkg, tool)]
    argv += [str(a) for a in args]
    if device and pkg == "hal_tpu_torch":
        argv += ["--device", "cpu"]
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=600)


def _genes(g, rng, n, with_bad=False):
    rows = []
    for k in range(n):
        si = int(rng.integers(0, g.num_sequences))
        span = int(rng.integers(30, min(300, g.seq_length(si) - 1)))
        st_ = int(rng.integers(0, g.seq_length(si) - span))
        nb = int(rng.integers(1, 5))
        cuts = np.sort(rng.choice(np.arange(1, span), 2 * nb - 2,
                                  replace=False))
        edges = np.concatenate([[0], cuts, [span]])
        starts, ends = edges[0::2], edges[1::2]
        rows.append("%s\t%d\t%d\tgene%d\t0\t%s\t%d\t%d\t0\t%d\t%s,\t%s,\n" % (
            g.seq_names[si], st_, st_ + span, k, "+-"[k % 2], st_,
            st_ + span, nb, ",".join(str(int(e - s)) for s, e in
                                     zip(starts, ends)),
            ",".join(str(int(s)) for s in starts)))
    if with_bad:  # a sequence the genome lacks, after 12 genes
        rows.insert(12, "chrMissing" + rows[12][rows[12].index("\t"):])
    return "".join(rows)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(halz path, alignment, gene files of Genome_7 and Genome_3)."""
    d = tmp_path_factory.mktemp("regions")
    hal = str(d / "a.halz")
    jax_save(jax_random_alignment(**FIXTURE), hal, fmt="halz")
    aln = open_alignment(hal)
    paths = {}
    for name, ref, bad in (("genes7", "Genome_7", False),
                           ("genes3", "Genome_3", False),
                           ("bad7", "Genome_7", True)):
        paths[name] = str(d / (name + ".bed"))
        with open(paths[name], "w") as f:
            f.write(_genes(aln.open_genome(ref), np.random.default_rng(4),
                           40, bad))
    return dict(hal=hal, aln=aln, dir=d, **paths)


# name: (tool, arguments (HAL, GENES7, GENES3, BAD7 and OUT substituted),
# expected exit code)
CLI_CASES = {
    "halSnps_tsv": ("halSnps", ["HAL", "Genome_7", "Genome_1,Genome_3,Genome_5",
                                "--tsv", "OUT/snps.tsv"], 0),
    "halSnps_noDupes": ("halSnps", ["HAL", "Genome_7", "Genome_1,Genome_3,"
                                    "Genome_5", "--tsv", "OUT/snps.tsv",
                                    "--noDupes"], 0),
    "halSnps_range": ("halSnps", ["HAL", "Genome_3", "Genome_7,Genome_0,"
                                  "Genome_3,Genome_6", "--tsv", "OUT/s.tsv",
                                  "--refSequence", "Genome_3_seq", "--start",
                                  "100", "--length", "900",
                                  "--minSpeciesForSnp", "2"], 0),
    "halSnps_missing_target": ("halSnps", ["HAL", "Genome_7", "Genome_1,nope"],
                               1),
    "halContiguousRegions": ("halContiguousRegions",
                             ["HAL", "Genome_3", "Genome_7"], 0),
    "halContiguousRegions_noDupes": ("halContiguousRegions",
                                     ["HAL", "Genome_3", "Genome_7",
                                      "--noDupes"], 0),
    "halContiguousRegions_up_maxGap": ("halContiguousRegions",
                                       ["HAL", "Genome_7", "Genome_4",
                                        "--maxGap", "5"], 0),
    "halSingleCopyRegionsExtract": ("halSingleCopyRegionsExtract",
                                    ["HAL", "Genome_7"], 0),
    "halSingleCopyRegionsExtract_targets": (
        "halSingleCopyRegionsExtract", ["HAL", "Genome_5", "--targetGenomes",
                                        "Genome_7,Genome_3",
                                        "--requireAllTargets"], 0),
    "halSingleCopyRegionsExtract_range": (
        "halSingleCopyRegionsExtract", ["HAL", "Genome_3", "--refSequence",
                                        "Genome_3_seq", "--start", "50",
                                        "--length", "700"], 0),
    "findRegionsExclusivelyInGroup": ("findRegionsExclusivelyInGroup",
                                      ["HAL", "Genome_7", "Genome_3"], 0),
    "findRegionsExclusivelyInGroup_counts": (
        "findRegionsExclusivelyInGroup", ["HAL", "Genome_7",
                                          "Genome_3,Genome_5,Genome_0",
                                          "--minIngroupGenomes", "1",
                                          "--maxOutgroupGenomes", "0"], 0),
    "hal4dExtract_conserved": ("hal4dExtract", ["HAL", "Genome_7", "GENES7",
                                                "OUT/4d.bed", "--conserved"],
                               0),
    "hal4dExtract_conserved_stdout": ("hal4dExtract",
                                      ["HAL", "Genome_3", "GENES3", "stdout",
                                       "--conserved"], 0),
    "hal4dExtract_plain": ("hal4dExtract", ["HAL", "Genome_7", "GENES7",
                                            "OUT/4d.bed"], 0),
    "hal4dExtract_bad_line": ("hal4dExtract", ["HAL", "Genome_7", "BAD7",
                                               "stdout", "--conserved"], 1),
}


def _sub(fx, args, out):
    table = {"HAL": fx["hal"], "GENES7": fx["genes7"],
             "GENES3": fx["genes3"], "BAD7": fx["bad7"]}
    return [table.get(a, a.replace("OUT", out)) for a in args]


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_equals_original(fixture, tmp_path, case):
    """Each tool with --device cpu: the files it writes, its stdout, its
    stderr and its exit code equal hal_tpu's on the same inputs."""
    tool, args, rc = CLI_CASES[case]
    runs = {}
    for pkg in ("hal_tpu", "hal_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        r = run_tool(pkg, tool, _sub(fixture, args, str(d)))
        assert r.returncode == rc, (pkg, r.stderr[-2000:])
        runs[pkg] = (r.stdout, r.stderr, _files(d))
    assert runs["hal_tpu_torch"] == runs["hal_tpu"]
    out, err, files = runs["hal_tpu"]
    if rc:
        assert "hal exception caught" in err
    else:
        assert out.count("\n") + sum(v.count(b"\n")
                                     for v in files.values()) > 3


def _in_process(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(argv) == 0
    return out.getvalue()


# each tool in process: (module, arguments), over the fixture's genomes
IN_PROCESS = [
    (halSnps, ["HAL", "Genome_7", "Genome_1,Genome_3,Genome_5", "--tsv",
               "OUT/snps.tsv"]),
    (halContiguousRegions, ["HAL", "Genome_3", "Genome_7"]),
    (halSingleCopyRegionsExtract, ["HAL", "Genome_7"]),
    (findRegionsExclusivelyInGroup, ["HAL", "Genome_7", "Genome_3"]),
    (hal4dExtract, ["HAL", "Genome_7", "GENES7", "OUT/4d.bed",
                    "--conserved"]),
]


@pytest.mark.parametrize("mod,args", IN_PROCESS,
                         ids=[m.__name__.rsplit(".", 1)[1]
                              for m, _ in IN_PROCESS])
def test_tools_map_nothing_on_the_host(fixture, tmp_path, monkeypatch, mod,
                                       args):
    """In process, with the port's segmap_host.map_source refused, each
    tool runs on the batched mapper alone and writes what it writes with
    the host mapper free to run."""
    argv = _sub(fixture, args, str(tmp_path)) + ["--device", "cpu"]
    want = _in_process(mod, argv)
    want_files = _files(tmp_path)

    def refuse(*a, **k):
        raise AssertionError("host map_source called")

    monkeypatch.setattr(port_sm, "map_source", refuse)
    got = _in_process(mod, argv)
    assert got == want and _files(tmp_path) == want_files
    assert got or any(want_files.values())


def test_tools_read_map_source_order(fixture, tmp_path, monkeypatch):
    """halContiguousRegions Genome_3 -> Genome_7 chains fragments in
    map_source's order: on the device's own order (an unordered dispatch)
    its BED differs from the original's, which the ordered dispatch gives.
    halSingleCopyRegionsExtract's self-map of Genome_7 needs the host-
    semantics paralogy branches: with segmap_jax's its BED differs."""
    real_map, real_mapper = _regions.map_by_owner, _regions.BatchMapper

    def unordered(*a, **k):
        return real_map(*a, **dict(k, ordered=False))

    def jax_branches(*a, **k):
        return real_mapper(*a, **dict(k, host_paralogies=False))

    cases = [(halContiguousRegions, ["HAL", "Genome_3", "Genome_7"],
              (halContiguousRegions, "map_by_owner", unordered)),
             (halSingleCopyRegionsExtract, ["HAL", "Genome_7"],
              (_regions, "BatchMapper", jax_branches))]
    for mod, args, patch in cases:
        argv = _sub(fixture, args, str(tmp_path)) + ["--device", "cpu"]
        want = run_tool("hal_tpu", mod.__name__.rsplit(".", 1)[1],
                        _sub(fixture, args, str(tmp_path))).stdout
        assert _in_process(mod, argv) == want and want
        with monkeypatch.context() as m:
            m.setattr(*patch)
            assert _in_process(mod, argv) != want


@pytest.mark.parametrize("mod,args", IN_PROCESS,
                         ids=[m.__name__.rsplit(".", 1)[1]
                              for m, _ in IN_PROCESS])
def test_device_cuda_without_card_raises(fixture, tmp_path, mod, args):
    """--device cuda (the default) with no CUDA device: HalError's message,
    exit 1, no output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    err = io.StringIO()
    out = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = mod.main(_sub(fixture, args, str(tmp_path)))
    assert rc == 1 and out.getvalue() == "" and os.listdir(tmp_path) == []
    assert "hal exception caught: --device cuda: no CUDA device" in \
        err.getvalue()
