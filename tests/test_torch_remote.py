"""Remote (HTTP) alignments in the port: hal_tpu_torch.storage.remote, the
copy of hal_tpu/storage/remote.py (the reference's UDC, api/impl/udc2.c,
README.md:126-131).

- Each test of tests/test_remote.py, on the port's modules: remote open
  equals local, laziness, cache reuse, fetch_range, read-only, BlockFile
  reads, the block-granular HDF5 and halz liftovers, the legacy-HDF5
  fallback (skips without the reference's mr.hal, as the original does) and
  RemoteArray semantics.  test_remote_halz_blockviz_query has no
  counterpart: blockviz is not in the port.
- The copy against the original on one server: the same arrays, and the
  same requests and bytes for the same host queries.
- The port's CLIs with --device cpu on a served URL: byte-equal to
  hal_tpu's same CLI on the same URL and to the port's on the local file.
- Under them, bulk_runs_device, PathData and the replicated and
  table-sharded steps on a URL equal to the same on the local file.
- Read-only buffers (a materialised remote array, a memory map) reach
  torch as copies, with no warning.

Servers are http.server threads on 127.0.0.1 (tests/test_remote.py's
handlers).  Tolerance: exact equality throughout."""

import contextlib
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest
import torch

from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.randgen import create_random_alignment
from hal_tpu_torch.storage import open_alignment, save_alignment
from hal_tpu_torch.storage.remote import RemoteArray
from test_reference_goldens import REF
from test_remote import CountingHandler, RangeHandler
from test_torch_phylop import gtr_mod_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def serve(directory, handler=RangeHandler):
    """Serve directory on 127.0.0.1 from a thread; yields (base URL, the
    handler class, with its own request and byte counters)."""
    h = type("H", (handler,), {"served_bytes": [0], "requests": []})
    srv = HTTPServer(("127.0.0.1", 0),
                     lambda *a, **kw: h(*a, directory=str(directory), **kw))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield "http://127.0.0.1:%d" % srv.server_address[1], h
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


@pytest.fixture(autouse=True)
def udc_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HAL_TPU_UDC_DIR", str(tmp_path / "udc"))


def _leaves(aln):
    return [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)]


# ------------------------------------------------ tests/test_remote.py, ported

@pytest.fixture(scope="module")
def served_halz(tmp_path_factory):
    root = tmp_path_factory.mktemp("remote")
    aln = create_random_alignment(seed=4, max_genomes=4, min_genomes=3,
                                  min_segments=5, max_segments=20)
    save_alignment(aln, str(root / "t.halz"), fmt="halz")
    with serve(root, CountingHandler) as (base, handler):
        yield aln, base + "/t.halz", handler


def test_remote_open_matches_local(served_halz):
    aln, url, _handler = served_halz
    remote = open_alignment(url)
    assert type(remote).__module__ == "hal_tpu_torch.alignment"
    assert remote.get_newick_tree() == aln.get_newick_tree()
    assert sorted(remote.genome_names()) == sorted(aln.genome_names())
    for name in aln.genome_names():
        a = aln.open_genome(name)
        b = remote.open_genome(name)
        assert np.array_equal(a.top_start, b.top_start)
        assert np.array_equal(a.dna, b.dna)
        assert a.seq_names == b.seq_names


def test_remote_is_lazy(served_halz):
    aln, url, handler = served_halz
    RemoteArray._bf_cache.clear()  # count this test's fetches only
    handler.requests.clear()
    remote = open_alignment(url)
    assert all(p.endswith("halz.json") for p in handler.requests)
    leaf = _leaves(aln)[0]
    remote.open_genome(leaf)
    assert {p for p in handler.requests if leaf in p}, \
        "opening a genome must fetch its arrays"
    others = {p for p in handler.requests
              if not p.endswith("halz.json") and leaf not in p}
    assert not others, "untouched genomes must not be fetched: %s" % others


def test_remote_cache_reuse(served_halz):
    aln, url, handler = served_halz
    remote = open_alignment(url)
    leaf = _leaves(aln)[0]
    remote.open_genome(leaf)
    n1 = len(handler.requests)
    open_alignment(url).open_genome(leaf)
    # the second open refetches only the manifest; arrays come from the cache
    assert len(handler.requests) - n1 == 1


def test_fetch_range(served_halz):
    from hal_tpu_torch.storage.remote import fetch_range

    _aln, url, _handler = served_halz
    with urllib.request.urlopen(url + "/halz.json") as r:
        whole = r.read()
    assert fetch_range(url + "/halz.json", 2, 10) == whole[2:12]


def test_remote_readonly(served_halz):
    _aln, url, _handler = served_halz
    with pytest.raises(ValueError, match="read-only"):
        open_alignment(url, mode="w")


@pytest.fixture(scope="module")
def served_hdf5(tmp_path_factory):
    root = tmp_path_factory.mktemp("remote_h5")
    aln = create_random_alignment(seed=12, max_genomes=16, min_genomes=12,
                                  mean_degree=2.0, min_segments=2000,
                                  max_segments=3000, min_segment_length=8,
                                  max_segment_length=40, fast_dna=True)
    save_alignment(aln, str(root / "t.hal"), fmt="hdf5")
    with serve(root) as (base, handler):
        yield (aln, base + "/t.hal", handler,
               os.path.getsize(str(root / "t.hal")))


def test_block_file_reads(served_hdf5):
    from hal_tpu_torch.storage.remote import BlockFile

    _aln, url, _handler, size = served_hdf5
    bf = BlockFile(url, block_size=4096)
    assert bf.size == size
    with urllib.request.urlopen(url) as r:
        whole = r.read()
    bf.seek(17)
    assert bf.read(10000) == whole[17:10017]
    bf.seek(-5, 2)
    assert bf.read() == whole[-5:]
    # cached blocks are not refetched
    n = bf.requests
    bf.seek(17)
    bf.read(1000)
    assert bf.requests == n


def test_remote_hdf5_block_granular_liftover(served_hdf5):
    """One interval lifted against a remote .hal fetches a fraction of the
    file: untouched genomes never cross the wire."""
    aln, url, _handler, size = served_hdf5
    remote = open_alignment(url)
    bf = getattr(remote, "remote_file", None)
    assert bf is not None, "remote hdf5 must use the block-granular path"
    assert remote.get_newick_tree() == aln.get_newick_tree()
    leaves = _leaves(aln)
    src, tgt = leaves[0], leaves[-1]
    g = remote.open_genome(src)
    lo = np.array([g.length // 3], np.int64)
    hi = lo + min(20, g.length // 4)
    frags = sm.map_source(remote, src, lo, hi, tgt, do_dupes=True)
    ref = sm.map_source(aln, src, lo, hi, tgt, do_dupes=True)
    assert np.array_equal(frags.tgt_lo, ref.tgt_lo)
    assert bf.bytes_fetched < size // 2, \
        "block-granular open fetched %d of %d bytes" % (bf.bytes_fetched, size)


def test_remote_legacy_hdf5_falls_back_after_lazy_load(tmp_path):
    """The legacy mr.hal (v2.1 fixed-width seqname datatype) needs the
    relaxed-integrity open, which applies only to real file paths: the
    BlockFile path fails at genome load, lazily, and open_remote's fallback
    switches the first open_genome to the whole-file download."""
    import shutil

    src = os.path.join(REF, "paf/tests/input/mr.hal")
    if not os.path.exists(src):
        pytest.skip("reference mr.hal fixture not present")
    root = tmp_path / "legacy"
    root.mkdir()
    shutil.copy(src, str(root / "mr.hal"))
    with serve(root) as (base, _handler):
        local = open_alignment(src)
        remote = open_alignment(base + "/mr.hal")
        assert remote.get_newick_tree() == local.get_newick_tree()
        name = sorted(local.genome_names())[0]
        rg = remote.open_genome(name)
        lg = local.open_genome(name)
        assert rg.length == lg.length
        assert list(rg.seq_names) == list(lg.seq_names)
        assert np.array_equal(rg.top_start, lg.top_start)


def test_remote_halz_block_granular_liftover(tmp_path):
    """Lifting one 25 bp interval against a served large halz touches
    under 5% of the segment arrays: block reads, not whole-array
    downloads."""
    aln = create_random_alignment(seed=9, max_genomes=4, min_genomes=3,
                                  min_segments=120000, max_segments=130000,
                                  min_segment_length=30,
                                  max_segment_length=34, store_dna=False)
    save_alignment(aln, str(tmp_path / "big.halz"), fmt="halz")
    # Range support is required: without it BlockFile's whole-body
    # fallback (right for servers without ranges) downloads everything
    with serve(tmp_path) as (base, _handler):
        RemoteArray._bf_cache.clear()
        remote = open_alignment(base + "/big.halz")
        leaves = _leaves(aln)
        src, tgt = leaves[0], leaves[-1]
        g = remote.open_genome(src)
        lo = np.array([g.length // 3], np.int64)
        hi = lo + 25
        frags = sm.map_source(remote, src, lo, hi, tgt, do_dupes=True)
        ref = sm.map_source(aln, src, lo, hi, tgt, do_dupes=True)
        assert np.array_equal(frags.tgt_lo, ref.tgt_lo)
        assert np.array_equal(frags.src_lo, ref.src_lo)
        assert remote.remote_arrays, "large arrays take the RemoteArray path"
        ras = remote.remote_arrays
        total = sum(ra.nbytes for (_n, _a, ra) in ras)
        fetched = sum(bf.bytes_fetched for bf in
                      {id(ra.bf): ra.bf for (_n, _a, ra) in ras}.values())
        assert total > 10 * 10 ** 6, total
        assert fetched < total // 20, \
            "fetched %d of %d array bytes" % (fetched, total)


def test_remote_array_semantics(tmp_path):
    """RemoteArray against numpy on every supported access: scalars,
    slices, fancy and 2-D gathers, searchsorted sides, comparisons and
    ufuncs."""
    rng = np.random.default_rng(3)
    a1 = np.sort(rng.integers(0, 10 ** 6, 5000)).astype(np.int64)
    a2 = rng.integers(-5, 5, (700, 3)).astype(np.int64)
    np.save(tmp_path / "a1.npy", a1)
    np.save(tmp_path / "a2.npy", a2)
    with serve(tmp_path) as (base, _handler):
        RemoteArray._bf_cache.clear()
        r1 = RemoteArray(base + "/a1.npy", block_size=256)
        r2 = RemoteArray(base + "/a2.npy", block_size=256)
        assert len(r1) == 5000 and r1.shape == a1.shape
        assert r2.shape == a2.shape and r2.ndim == 2
        assert r1[17] == a1[17] and r1[-1] == a1[-1]
        assert np.array_equal(r1[100:130], a1[100:130])
        idx = rng.integers(0, 5000, 40)
        assert np.array_equal(r1[idx], a1[idx])
        assert np.array_equal(r2[idx % 700, 1], a2[idx % 700, 1])
        assert np.array_equal(r2[5], a2[5])
        q = rng.integers(0, 10 ** 6, 25)
        for side in ("left", "right"):
            assert np.array_equal(np.searchsorted(r1, q, side=side),
                                  np.searchsorted(a1, q, side=side))
        assert int(np.searchsorted(r1, int(q[0]))) == \
            int(np.searchsorted(a1, int(q[0])))
        assert np.array_equal(r1 != -1, a1 != -1)
        assert np.array_equal(np.minimum(r1, 5), np.minimum(a1, 5))
        assert (np.asarray(r2) == a2).all()
        # partial access stays partial: a fresh array fetched few blocks
        RemoteArray._bf_cache.clear()
        r3 = RemoteArray(base + "/a1.npy", block_size=256)
        _ = r3[4999]
        assert r3.bytes_fetched < a1.nbytes // 4


# ------------------------------------------------ the copy against hal_tpu's

@pytest.mark.parametrize("fmt", ["halz", "hdf5"])
def test_remote_copy_equals_original(tmp_path, fmt):
    """hal_tpu.storage.remote and its copy on one server: equal arrays,
    and for the same host queries (map_source of two 25 bp intervals) the
    same fragments, requests and bytes fetched."""
    from hal_tpu.ops import segmap_host as jax_sm
    from hal_tpu.storage import open_alignment as jax_open
    from hal_tpu.storage.remote import RemoteArray as JaxRemoteArray

    aln = create_random_alignment(seed=9, max_genomes=4, min_genomes=3,
                                  min_segments=20000, max_segments=24000,
                                  min_segment_length=30,
                                  max_segment_length=34, store_dna=False)
    name = "p.halz" if fmt == "halz" else "p.hal"
    save_alignment(aln, str(tmp_path / name), fmt=fmt)
    leaves = _leaves(aln)
    src, tgt = leaves[0], leaves[-1]
    with serve(tmp_path) as (base, _handler):
        url = base + "/" + name
        got = []
        for opener, segmap, cache in ((open_alignment, sm,
                                       RemoteArray._bf_cache),
                                      (jax_open, jax_sm,
                                       JaxRemoteArray._bf_cache)):
            RemoteArray._bf_cache.clear()
            JaxRemoteArray._bf_cache.clear()
            remote = opener(url)
            g = remote.open_genome(src)
            lo = np.array([g.length // 3, g.length // 2], np.int64)
            frags = segmap.map_source(remote, src, lo, lo + 25, tgt,
                                      do_dupes=True)
            if fmt == "halz":
                io = (sorted((u, bf.requests, bf.bytes_fetched)
                             for (u, _bs), bf in cache.items()),
                      [(n, a, ra.nbytes) for n, a, ra in remote.remote_arrays])
            else:
                bf = remote.remote_file
                io = (bf.requests, bf.bytes_fetched)
            got.append((remote, frags, io))
        (port, pf, pio), (ref, jf, jio) = got
        assert pio == jio
        assert pio[0], "the queries fetched nothing"
        for f in ("src_lo", "src_hi", "tgt_lo", "tgt_hi", "rev"):
            assert np.array_equal(getattr(pf, f), getattr(jf, f)), f
        assert port.get_newick_tree() == ref.get_newick_tree()
        for gname in aln.genome_names():
            pg, jg = port.open_genome(gname), ref.open_genome(gname)
            for arr in ("top_start", "top_parent", "top_parent_reversed",
                        "top_paralogy", "bot_start", "bot_child",
                        "bot_child_reversed", "seq_start", "dna"):
                x, y = np.asarray(getattr(pg, arr)), np.asarray(getattr(jg, arr))
                assert x.dtype == y.dtype and np.array_equal(x, y), (gname, arr)
            assert pg.seq_names == jg.seq_names


# ------------------------------------------------------------ the CLIs

@pytest.fixture(scope="module")
def cli_served(tmp_path_factory):
    """A random DNA alignment as halz (tests/test_torch_phylop.py's CLI
    fixture), served; a BED, a wiggle and a seeded GTR .mod beside it."""
    d = tmp_path_factory.mktemp("remote_cli")
    aln = create_random_alignment(seed=31, max_genomes=6, min_genomes=5,
                                  min_segments=20, max_segments=60,
                                  min_segment_length=4, max_segment_length=14)
    save_alignment(aln, str(d / "aln.halz"), fmt="halz")
    leaves = _leaves(aln)
    g = aln.open_genome(leaves[0])
    rng = np.random.default_rng(5)
    name, slen = g.seq_names[0], g.seq_length(0)
    starts = np.sort(rng.integers(0, slen - 12, 40))
    (d / "in.bed").write_text("".join(
        "%s\t%d\t%d\n" % (name, s, s + int(rng.integers(1, 12)))
        for s in starts))
    (d / "in.wig").write_text(
        "fixedStep chrom=%s start=3 step=1\n" % name
        + "".join("%g\n" % v for v in np.round(rng.normal(size=slen - 5), 3)))
    (d / "aln.mod").write_text(gtr_mod_text(aln.tree.to_newick(), 33))
    with serve(d) as (base, _handler):
        yield d, base + "/aln.halz", leaves


def _cli_argv(tool, d, hal, leaves, out, port):
    src, tgt = leaves[0], leaves[-1]
    dev = ["--device", "cpu"] if port else []
    if tool == "halLiftover":
        return [hal, src, str(d / "in.bed"), tgt, out] + dev
    if tool == "halAlignmentDepth":
        return [hal, src, "--outWiggle", out] + (dev or ["--device"])
    if tool == "halWiggleLiftover":
        return [hal, src, str(d / "in.wig"), tgt, out] + dev
    if tool == "hal2maf":
        return [hal, out, "--refGenome", src] + (dev or ["--device"])
    if tool == "halPhyloP":
        return (dev or ["--device", "on"]) + [hal, src, str(d / "aln.mod"),
                                              out]
    return [hal]  # halStats prints to stdout


@pytest.mark.parametrize("tool", ["halLiftover", "halAlignmentDepth",
                                  "halWiggleLiftover", "hal2maf", "halPhyloP",
                                  "halStats"])
def test_cli_on_url_equals_jax_and_local(cli_served, tool, capsys):
    """The port's CLI with --device cpu on the served URL prints the bytes
    of hal_tpu's same CLI on the same URL, and of the port's on the local
    file."""
    import importlib

    d, url, leaves = cli_served
    port_cli = importlib.import_module("hal_tpu_torch.tools." + tool)
    jax_cli = importlib.import_module("hal_tpu.tools." + tool)
    outs = {}
    for who, cli, hal in (("port_url", port_cli, url),
                          ("jax_url", jax_cli, url),
                          ("port_local", port_cli, str(d / "aln.halz"))):
        out = str(d / ("%s_%s.out" % (tool, who)))
        capsys.readouterr()
        cli.run(_cli_argv(tool, d, hal, leaves, out, cli is port_cli))
        outs[who] = (capsys.readouterr().out.encode() if tool == "halStats"
                     else open(out, "rb").read())
    assert outs["port_url"], tool
    assert outs["port_url"] == outs["jax_url"] == outs["port_local"]


# -------------------------------------------- read-only buffers into torch

def test_read_only_arrays_reach_torch_as_copies():
    """A read-only array (np.frombuffer, as RemoteArray.materialize makes)
    goes to torch through each conversion of the port as a copy: the
    tensor does not alias it, and torch warns of no non-writable array
    (run with UserWarning as an error, in a fresh process: torch warns
    once a process)."""
    code = (
        "import types\n"
        "import numpy as np, torch\n"
        "from hal_tpu_torch.ops import segmap_torch as st\n"
        "from hal_tpu_torch.parallel import distributed, sharded\n"
        "ro = np.frombuffer(np.arange(0, 80, 5, dtype=np.int64).tobytes(),"
        " np.int64)\n"
        "assert not ro.flags.writeable\n"
        "def apart(t):\n"
        "    lo = ro.ctypes.data\n"
        "    return not lo <= t.data_ptr() < lo + ro.nbytes\n"
        "cpu = torch.device('cpu')\n"
        "t = st.target_seq_grid(types.SimpleNamespace(seq_start=ro),"
        " device=cpu)\n"
        "assert apart(t) and t.tolist() == ro[1:-1].tolist()\n"
        "t = st.coords(types.SimpleNamespace(dtype=torch.int64, device=cpu),"
        " ro)\n"
        "assert apart(t) and t.tolist() == ro.tolist()\n"
        "mesh = sharded.make_mesh(2, device=cpu)\n"
        "ts = sharded.shard_batch(mesh, ro, ro, ro)\n"
        "assert all(apart(t) for t in ts)\n"
        "ts = distributed.shard_global_batch(mesh, [ro])\n"
        "assert all(apart(t) for t in ts) and ts[0].tolist() == ro.tolist()\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-W", "error::UserWarning", "-c",
                          code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"


def test_bulk_runs_device_on_url_equals_local(cli_served):
    """bulk_runs_device (map, runs, wire, decode on --device) on the served
    alignment equals the same call on the local file."""
    from hal_tpu_torch.ops.liftover_bulk import bulk_runs_device

    d, url, leaves = cli_served
    src, tgt = leaves[0], leaves[-1]
    res = []
    for hal in (url, str(d / "aln.halz")):
        RemoteArray._bf_cache.clear()
        aln = open_alignment(hal)
        g = aln.open_genome(src)
        rng = np.random.default_rng(8)
        lo = np.sort(rng.integers(0, g.length - 10, 64)).astype(np.int64)
        hi = lo + rng.integers(1, 10, 64)
        res.append(bulk_runs_device(aln, src, tgt, lo, hi,
                                    aln.open_genome(tgt),
                                    device=torch.device("cpu")))
    assert res[0] is not None
    for a, b in zip(*res):
        assert np.array_equal(a, b)


def test_path_and_sharded_steps_on_url_equal_local(tmp_path):
    """PathData built over a served alignment (its large arrays as
    RemoteArray views) equals the local build level by level, and the
    replicated and table-sharded steps over 4 local shards on the CPU give
    equal fragments, histograms and overflow flags from either."""
    from hal_tpu_torch.ops import segmap_torch as st
    from hal_tpu_torch.parallel import sharded as ps

    aln = create_random_alignment(seed=3, max_genomes=5, min_genomes=4,
                                  min_segment_length=10,
                                  max_segment_length=18, min_segments=3000,
                                  max_segments=4000, store_dna=False)
    save_alignment(aln, str(tmp_path / "s.halz"), fmt="halz")
    leaves = _leaves(aln)
    src, tgt = leaves[0], leaves[-1]
    rng = np.random.default_rng(6)
    with serve(tmp_path) as (base, _handler):
        out = []
        for hal in (base + "/s.halz", str(tmp_path / "s.halz")):
            RemoteArray._bf_cache.clear()
            a = open_alignment(hal)
            g, tg = a.open_genome(src), a.open_genome(tgt)
            if hal.startswith("http"):
                assert a.remote_arrays, "large arrays take the RemoteArray path"
            path = st.PathData.build(a, src, tgt, device="cpu")
            lo = np.sort(rng.integers(0, g.length - 20, 256)).astype(np.int64)
            hi = lo + rng.integers(1, 20, 256)
            owner = np.arange(256, dtype=np.int64)
            caps = tuple((4096, 8192) if lv.kind == "down" and lv.max_ring
                         else 4096 for lv in path.levels)
            mesh = ps.make_mesh(4, 1, device="cpu")
            batch = ps.shard_batch(mesh, lo, hi, owner)
            rep = ps.make_sharded_step(path, caps, tg.length, 16, mesh)(*batch)
            tab = ps.make_table_sharded_step(
                ps.shard_path_tables(path, mesh), caps, mesh)(*batch)
            out.append((path, rep, tab))
            rng = np.random.default_rng(6)
    (pr, rr, tr), (pl, rl, tl) = out
    for a, b in zip(pr.levels, pl.levels):
        assert a.kind == b.kind and a.max_ring == b.max_ring
        for f in ("grid", "seg_table", "ring_mem_tab"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(rr + tr, rl + tl):
        assert torch.equal(x, y)
    assert int((rr[0][st.C_VALID] > 0).sum()) > 0
