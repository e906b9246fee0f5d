"""The port's sharded steps (hal_tpu_torch.parallel.{mesh,sharded,
ring_sharded}, the sharded column step of ops.column_torch,
hal_tpu_torch.graft_entry and tools.benchScaling) on the CPU, held against
hal_tpu.parallel and column_jax on the virtual 8-device mesh
(tests/conftest.py) on the fixtures of tests/test_sharded.py,
test_sharded_tables.py and test_ring_sharded.py.  The port's shards are
local shards of one process (no process group); the JAX package's levels
go to the port through PathData.from_numpy, so both run on the same
tables.  Tolerance: exact equality (fragment matrices, overflow flags,
histograms, MAF bytes); on the CPU the port's kernels take their plain
versions."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from hal_tpu.io.maf_io import MafBlockBuilder as JaxBuilder
from hal_tpu.ops import column_jax as cj
from hal_tpu.ops import segmap_jax as sj
from hal_tpu.ops.column import iter_slices_exact
from hal_tpu.parallel import ring_sharded as jr
from hal_tpu.parallel import sharded as js
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu_torch.io.maf_io import MafBlockBuilder
from hal_tpu_torch.ops import column_torch as ct
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.parallel import ring_sharded as pr
from hal_tpu_torch.parallel import sharded as ps
from hal_tpu_torch.parallel.mesh import Mesh
from hal_tpu_torch.randgen import create_random_alignment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_path(path):
    """The port's PathData on the JAX package's level tables."""
    return st.PathData.from_numpy(path.levels, path.n_up, path.para,
                                  path.min_length, device="cpu")


def _i64(x):
    return np.asarray(x).astype(np.int64)


def _leaf_pair(aln):
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src = leaves[0]
    return src, (leaves[-1] if leaves[-1] != src else aln.root_name)


def _batch(g, n, seed, max_len):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, max(g.length - max_len, 1), n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, max_len, n), g.length).astype(np.int64)
    return lo, hi, np.arange(n, dtype=np.int64)


def test_mesh_local_collectives():
    """Among local shards: psum sums the stacked values, all_gather returns
    them in data order, all_to_all swaps the (src, dst) bucket axes; the
    shard layout is devices.reshape(n_data, n_coord)'s."""
    mesh = Mesh(4, 2, device="cpu")
    assert mesh.n_local == 8 and list(mesh.local_data) == [0, 1, 2, 3]
    assert [mesh.axis_index(k, "data") for k in mesh.local_shards] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert [mesh.axis_index(k, "coord") for k in mesh.local_shards] == \
        [0, 1] * 4
    x = torch.arange(4 * 3 * 5).reshape(4, 3, 5)
    assert torch.equal(mesh.psum(x), x.sum(0))
    assert torch.equal(mesh.all_gather(x), x)
    y = torch.arange(4 * 4 * 6).reshape(4, 4, 6)
    assert torch.equal(mesh.all_to_all(y), y.transpose(0, 1))
    with pytest.raises(ValueError, match="divide"):
        mesh.split(torch.arange(6))


def _replicated_fixture():
    # tests/test_sharded.py's fixture
    aln = jax_random_alignment(seed=3, max_genomes=5, min_genomes=4,
                               min_segment_length=10, max_segment_length=18,
                               min_segments=30, max_segments=60)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    return aln, leaves[0], leaves[-1]


def test_replicated_step_equals_jax():
    """make_sharded_step at mesh (4, 2) over 8 local shards: F (8, D*cap)
    and the coord-sharded histogram equal the JAX package's element for
    element."""
    aln, src, tgt = _replicated_fixture()
    tg = aln.open_genome(tgt)
    path = sj.PathData.build(aln, src, tgt)
    lo, hi, owner = _batch(aln.open_genome(src), 32, 0, 20)
    caps = tuple(int(32 * 8 * (min(lv.max_ring + 1, 4) if lv.max_ring else 1))
                 for lv in path.levels)
    mesh = js.make_mesh(4, 2)
    F, cov = js.make_sharded_step(path, caps, tg.length, 16, mesh)(
        *js.shard_batch(mesh, lo, hi, owner))
    pmesh = ps.make_mesh(4, 2, device="cpu")
    pF, pcov = ps.make_sharded_step(_port_path(path), caps, tg.length, 16,
                                    pmesh)(*ps.shard_batch(pmesh, lo, hi,
                                                           owner))
    assert pF.shape == np.asarray(F).shape and pF.shape[1] % 4 == 0
    assert np.array_equal(pF.numpy().astype(np.int64), _i64(F))
    assert pcov.dtype == torch.int64
    assert np.array_equal(pcov.numpy(), _i64(cov))
    assert pcov.sum() > 0


def test_histogram_bins_in_int64_where_jax_would_wrap():
    """Fault k: the JAX package bins t_lo * n_bins in the path's 32-bit
    dtype.  On an int32 path with n_bins = 2^22 that product passes 2^31,
    and the port's histogram still equals an int64 numpy histogram of its
    own fragments."""
    aln, src, tgt = _replicated_fixture()
    tg = aln.open_genome(tgt)
    path = _port_path(sj.PathData.build(aln, src, tgt))
    assert path.dtype == torch.int32
    lo, hi, owner = _batch(aln.open_genome(src), 64, 1, 20)
    caps = tuple(64 * 8 * 4 for _ in path.levels)
    n_bins = 1 << 22
    mesh = ps.make_mesh(2, 2, device="cpu")
    F, cov = ps.make_sharded_step(path, caps, tg.length, n_bins, mesh)(
        *ps.shard_batch(mesh, lo, hi, owner))
    M = F.numpy().astype(np.int64)
    M = M[:, M[st.C_VALID] > 0]
    t_lo, t_hi = M[st.C_TLO], M[st.C_THI]
    assert (t_lo * n_bins >= 2 ** 31).any()  # the 32-bit product wraps here
    want = np.zeros(n_bins, np.int64)
    np.add.at(want, np.clip(t_lo * n_bins // tg.length, 0, n_bins - 1),
              t_hi - t_lo)
    assert want.sum() > 0 and np.array_equal(cov.numpy(), want)


def _tables_fixture():
    # tests/test_sharded_tables.py's fixture
    aln = jax_random_alignment(seed=5, max_genomes=6, min_genomes=5,
                               min_segments=48, max_segments=64,
                               min_segment_length=4, max_segment_length=9)
    src, tgt = _leaf_pair(aln)
    path = sj.PathData.build(aln, src, tgt)
    lo, hi, owner = _batch(aln.open_genome(src), 64, 2, 16)
    caps = tuple((int(256 * min(lv.max_ring + 1, 4)), 1024)
                 if lv.kind == "down" and lv.max_ring else 256
                 for lv in path.levels)
    return path, (lo, hi, owner), caps


@pytest.mark.parametrize("kernel_limit", ["default", "below_padded_grid"])
def test_table_sharded_step_equals_jax(kernel_limit, monkeypatch):
    """make_table_sharded_step at D = 8: F and the overflow flags equal the
    JAX package's.  Each gathered level is the padded level whole, with the
    searchsorted kernel's tables rebuilt from its grid — or, with the
    kernel's grid limit below the padded grid's length, none, so the
    lookup takes the path an unsharded grid of that length takes."""
    path, batch, caps = _tables_fixture()
    if kernel_limit != "default":
        monkeypatch.setattr(st, "_KERNEL_GRID_LIMIT",
                            min(lv.grid.shape[0] for lv in path.levels) - 1)
    mesh = js.make_mesh(8, 1)
    F, ovf = js.make_table_sharded_step(js.shard_path_tables(path, mesh),
                                        caps, mesh)(
        *js.shard_batch(mesh, *batch))
    pmesh = ps.make_mesh(8, 1, device="cpu")
    ppath = _port_path(path)
    psh = ps.shard_path_tables(ppath, pmesh)
    for lv, slv in zip(ppath.levels, psh.levels):
        assert slv.grid.shape == (8, -(-lv.grid.shape[0] // 8))
        assert slv.seg_table.shape == (8, 8, -(-lv.seg_table.shape[1] // 8))
        g = ps.gather_level(pmesh, slv)
        want = torch.from_numpy(ps._pad_last(lv.grid.numpy(), 8, True))
        assert torch.equal(g.grid, want)
        assert torch.equal(g.seg_table[:, :lv.seg_table.shape[1]],
                           lv.seg_table)
        if kernel_limit == "default":
            assert g.fences8 is not None
            assert torch.equal(g.search_tree,
                               st.with_search_tables(
                                   st.Level("up", want, lv.seg_table,
                                            lv.ring_mem_tab, 0)).search_tree)
        else:
            assert g.fences8 is None and g.grid_i32 is None
    pF, povf = ps.make_table_sharded_step(psh, caps, pmesh)(
        *ps.shard_batch(pmesh, *batch))
    assert np.array_equal(pF.numpy().astype(np.int64), _i64(F))
    assert np.array_equal(povf.numpy(), np.asarray(ovf))
    assert not povf.any() and (pF[st.C_VALID] > 0).any()


def test_run_path_level_xform_none_is_bit_identical():
    """_run_path with level_xform None, or an identity hook, returns what
    the JAX package's _run_path returns: F, bound, overflow and level
    totals."""
    path, (lo, hi, owner), caps = _tables_fixture()
    want = sj._map_batch_jit(path, lo, hi, owner, caps)  # jit(_run_path)
    ppath = _port_path(path)
    args = [st.coords(ppath, x) for x in (lo, hi, owner)]
    for xform in (None, lambda lv: lv):
        got = st._run_path(ppath, *args, caps, level_xform=xform)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().astype(np.int64), _i64(w))


def _ring_fixture(seed, lo_seg, hi_seg, lo_len, hi_len, n, bseed, max_len):
    aln = jax_random_alignment(seed=seed, max_genomes=6 if seed != 11 else 5,
                               min_genomes=5 if seed != 11 else 4,
                               min_segments=lo_seg, max_segments=hi_seg,
                               min_segment_length=lo_len,
                               max_segment_length=hi_len, store_dna=False)
    src, tgt = _leaf_pair(aln)
    path = sj.PathData.build(aln, src, tgt)
    return path, _batch(aln.open_genome(src), n, bseed, max_len)


_RING_CASES = {
    # tests/test_ring_sharded.py: seeds 5 and 23, and the owner-preservation
    # case (seed 11, D = 4)
    5: (5, 48, 96, 4, 9, 64, 3, 16),
    23: (23, 48, 96, 4, 9, 64, 3, 16),
    11: (11, 32, 64, 5, 12, 16, 9, 10),
}


def _ring_both(path, batch, caps, D):
    mesh = js.make_mesh(D, 1)
    F, ovf = jr.make_ring_sharded_step(jr.build_ring_path(path, D), caps,
                                       mesh)(*js.shard_batch(mesh, *batch))
    pmesh = ps.make_mesh(D, 1, device="cpu")
    pF, povf = pr.make_ring_sharded_step(
        pr.build_ring_path(_port_path(path), D), caps, pmesh)(
        *ps.shard_batch(pmesh, *batch))
    return (_i64(F), np.asarray(ovf)), (pF.numpy(), povf.numpy())


@pytest.mark.parametrize("case,D", [(5, 8), (23, 8), (5, 4), (23, 4),
                                    (11, 4)])
def test_ring_sharded_step_equals_jax(case, D):
    """make_ring_sharded_step: F and the overflow flags equal the JAX
    package's on test_ring_sharded.py's seeds, at D = 8 and D = 4."""
    path, batch = _ring_fixture(*_RING_CASES[case])
    cap = (512, 256, 1024, 1024) if case != 11 else (256, 256, 512, 512)
    caps = tuple(cap for _ in path.levels)
    (F, ovf), (pF, povf) = _ring_both(path, batch, caps, D)
    assert pF.shape == F.shape and np.array_equal(pF, F)
    assert np.array_equal(povf, ovf) and not povf.any()
    assert (pF[st.C_VALID] > 0).any()


@pytest.mark.parametrize("cap_send", [1, 3])
def test_ring_sharded_send_overflow_equals_jax(cap_send):
    """With cap_send too small the buckets overflow: the port's flags equal
    the JAX package's, the dropped fragments land in the cut-off spare
    region (nothing is written out of range) and F equals JAX's."""
    path, batch = _ring_fixture(*_RING_CASES[5])
    caps = tuple((512, cap_send, 1024, 1024) for _ in path.levels)
    (F, ovf), (pF, povf) = _ring_both(path, batch, caps, 8)
    assert ovf.any() and np.array_equal(povf, ovf)
    assert np.array_equal(pF, F)


def _maf(builder, aln, ref, slices):
    b = builder(aln, ref, ucsc_names=True)
    blocks = list(b.feed(slices))
    t = b.flush_end()
    if t:
        blocks.append(t)
    return "\n".join(blocks)


def test_sharded_column_step_equals_jax():
    """The sharded column step at D = 8 over a 6,144-column window: every
    job's (out, total, overflow) equals the JAX package's, and the MAF
    assembled from collect_sharded equals JAX's and iter_slices_exact's
    bytes."""
    kw = dict(seed=4, max_genomes=6, min_genomes=5, min_segment_length=8,
              max_segment_length=30, min_segments=300, max_segments=500)
    jaln, paln = jax_random_alignment(**kw), create_random_alignment(**kw)
    ref = [n for n in jaln.genome_names() if jaln.tree.is_leaf(n)][0]
    W = 6144
    assert jaln.open_genome(ref).length >= W
    edges = np.linspace(0, W, 9).astype(np.int64)

    eng = cj.DeviceColumnEngine(jaln, ref)
    caps_all, oc_all = cj.size_sharded_caps(eng, edges)
    mesh = js.make_mesh(8, 1)
    sh = NamedSharding(mesh, PartitionSpec("data"))
    outs = cj.make_sharded_column_step(eng, caps_all, oc_all, mesh)(
        jax.device_put(edges[:-1].copy(), sh),
        jax.device_put(edges[1:].copy(), sh))
    want = _maf(JaxBuilder, jaln, ref, cj.slices_from_frags(
        jaln, ref, 0, W, cj.collect_sharded(eng, outs, edges)))

    peng = ct.DeviceColumnEngine(paln, ref, device="cpu")
    pcaps, poc = ct.size_sharded_caps(peng, edges)
    assert (pcaps, poc) == (caps_all, oc_all)
    pouts = ct.make_sharded_column_step(peng, pcaps, poc,
                                        ps.make_mesh(8, 1, device="cpu"))(
        torch.from_numpy(edges[:-1].copy()),
        torch.from_numpy(edges[1:].copy()))
    assert len(pouts) == len(outs) == len(peng.jobs) > 1
    for (o, t, v), (po, pt, pv) in zip(outs, pouts):
        assert np.array_equal(po.numpy().astype(np.int64), _i64(o))
        assert np.array_equal(pt.numpy(), np.asarray(t))
        assert np.array_equal(pv.numpy(), np.asarray(v))
    got = _maf(MafBlockBuilder, paln, ref, ct.slices_from_frags(
        paln, ref, 0, W, ct.collect_sharded(peng, pouts, edges)))
    assert len(want) > 100_000 and got == want
    assert want == _maf(JaxBuilder, jaln, ref,
                        iter_slices_exact(jaln, ref, 0, W))


def test_graft_entry_dryrun_and_entry(capsys):
    """graft_entry.dryrun_multichip(8) on the CPU reports every check true
    in one JSON line; entry()'s step runs on the CPU and returns the JAX
    package's entry step's F and bound."""
    import __graft_entry__ as jax_entry

    from hal_tpu_torch import graft_entry

    rec = graft_entry.dryrun_multichip(8, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec and rec["ok"] is True
    for step in ("replicated_step", "table_sharded_step", "ring_sharded_step"):
        assert rec[step]["oracle_pairs_equal"] is True, step
        assert rec[step]["coverage_sum"] == rec[step]["coverage_expected"]
    for step in ("table_sharded_step", "ring_sharded_step"):
        assert rec[step]["coverage_hist_equal"] is True, step
    assert rec["column_step"]["maf_byte_equal"] is True
    assert rec["fixture"]["segments"] >= 100_000

    fn, args = graft_entry.entry(device="cpu")
    F, bound = fn(*args)
    jfn, jargs = jax_entry.entry()
    for a, b in zip(args, jargs):
        assert np.array_equal(a, b)
    jF, jbound = jfn(*jargs)
    assert F.device.type == "cpu" and int(bound) == int(jbound) > 0
    assert np.array_equal(F.numpy().astype(np.int64), _i64(jF))


def test_bench_scaling_cli():
    """The port's benchScaling on --device cpu reports the original's
    summary shape (tests/test_sharded.py::test_bench_scaling_harness) and
    says that it measures local-shard overhead, not multi-GPU scaling."""
    r = subprocess.run(
        [sys.executable, "-m", "hal_tpu_torch.tools.benchScaling",
         "--devices", "1,2", "--nIntervals", "2048", "--nGenomes", "4",
         "--nSegments", "100", "--iters", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(x) for x in r.stdout.splitlines()]
    summary = lines[-1]
    assert summary["metric"] == "sharded_scaling"
    assert [row["devices"] for row in summary["results"]] == [1, 2]
    assert summary["results"][0]["scaling_efficiency"] == 1.0
    assert "ring_intervals_per_s" in summary["results"][1]
    assert "table_sharded_intervals_per_s" in summary["results"][1]
    assert "not multi-GPU scaling" in summary["measures"]
    assert summary["device"] == "cpu"
