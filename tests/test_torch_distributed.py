"""The port's multi-process steps (hal_tpu_torch.parallel.distributed and
the mesh's collectives across processes) in two gloo processes on the CPU,
held against tests/test_multiprocess.py's single-process oracle and
against the same steps in one process.

Each worker is this file run as a script:

    python tests/test_torch_distributed.py <process_id> <num_processes>
        <port> <outdir>

It joins a 2-process gloo group at tcp://localhost:<port> (its own free
port) and runs, at one local shard a process, distributed_coverage and
merge_sorted_blocks on tests/mp_worker.py's fixture (seed 17); then, at two
local shards a process (D = 4), the replicated, table-sharded and
ring-sharded steps.  The worker imports nothing of hal_tpu.  Tolerance:
exact equality."""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mp_fixture():
    """tests/mp_worker.py's alignment and batch, from the port's randgen."""
    from hal_tpu_torch.randgen import create_random_alignment

    aln = create_random_alignment(seed=17, max_genomes=5, min_genomes=4,
                                  min_segments=6, max_segments=30,
                                  min_segment_length=4, max_segment_length=12)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    rng = np.random.default_rng(3)
    n = 64
    lo = rng.integers(0, g.length - 2, n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 20, n), g.length)
    return aln, src, tgt, lo, hi


def _ring_fixture():
    """tests/test_ring_sharded.py's seed-5 alignment and batch, and the
    port's path on the CPU."""
    from hal_tpu_torch.ops.segmap_torch import PathData
    from hal_tpu_torch.randgen import create_random_alignment

    aln = create_random_alignment(seed=5, max_genomes=6, min_genomes=5,
                                  min_segments=48, max_segments=96,
                                  min_segment_length=4, max_segment_length=9,
                                  store_dna=False)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src = leaves[0]
    tgt = leaves[-1] if leaves[-1] != src else aln.root_name
    g = aln.open_genome(src)
    rng = np.random.default_rng(3)
    n = 64
    lo = rng.integers(0, max(g.length - 16, 1), n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 16, n), g.length).astype(np.int64)
    path = PathData.build(aln, src, tgt, device="cpu")
    return aln, tgt, path, (lo, hi, np.arange(n, dtype=np.int64))


RING_CAPS = (512, 256, 1024, 1024)
STEP_CAPS = 1024


def _d4_steps(mesh, aln, tgt, path, batch):
    """The replicated (mesh (2, 2) over 4 shards), table-sharded and
    ring-sharded steps at D = 4 on `mesh`'s process group; each returns
    this process's part."""
    from hal_tpu_torch.parallel import ring_sharded as pr
    from hal_tpu_torch.parallel import sharded as ps
    from hal_tpu_torch.parallel.mesh import Mesh

    caps = tuple((STEP_CAPS, STEP_CAPS) if lv.max_ring else STEP_CAPS
                 for lv in path.levels)
    grid = Mesh(2, 2, device=mesh.device, group=mesh.group)
    F1, cov = ps.make_sharded_step(path, caps, aln.open_genome(tgt).length,
                                   16, grid)(*ps.shard_batch(grid, *batch))
    args = ps.shard_batch(mesh, *batch)
    F2, ovf2 = ps.make_table_sharded_step(ps.shard_path_tables(path, mesh),
                                          caps, mesh)(*args)
    F3, ovf3 = pr.make_ring_sharded_step(
        pr.build_ring_path(path, 4), tuple(RING_CAPS for _ in path.levels),
        mesh)(*args)
    return {"rep_F": F1.numpy(), "rep_cov": cov.numpy(),
            "tab_F": F2.numpy(), "tab_ovf": ovf2.numpy(),
            "ring_F": F3.numpy(), "ring_ovf": ovf3.numpy()}


def worker(pid: int, nproc: int, port: str, outdir: str) -> None:
    sys.path.insert(0, REPO)
    import torch

    from hal_tpu_torch.ops import segmap_torch as st
    from hal_tpu_torch.ops import tables
    from hal_tpu_torch.parallel import distributed as dist

    with dist.initialize("localhost:" + port, nproc, pid,
                         device="cpu") as group:
        aln, src, tgt, lo, hi = _mp_fixture()
        n = len(lo)
        owner = np.arange(n, dtype=np.int64)
        path = st.PathData.build(aln, src, tgt, device="cpu")
        dtype = np.int32 if path.dtype == torch.int32 else np.int64
        lo, hi, owner = lo.astype(dtype), hi.astype(dtype), owner.astype(dtype)
        totals = tables.host_level_totals(aln, src, tgt, lo, hi)
        caps = tables.tight_caps(path, totals, slack=2.0)

        mesh = dist.global_mesh(group, 1, device="cpu")
        chunk = n // nproc
        s = pid * chunk
        glo, ghi, gown = dist.shard_global_batch(
            mesh, (lo[s:s + chunk], hi[s:s + chunk], owner[s:s + chunk]))
        hist = dist.distributed_coverage(path, caps,
                                         aln.open_genome(tgt).length, mesh,
                                         glo, ghi, gown)
        merged = dist.merge_sorted_blocks(np.sort(lo[s:s + chunk]),
                                          device="cpu", group=group)
        # unequal row counts a process: 2-column blocks sorted by rows
        rows = np.stack([lo, hi], axis=1)[pid::3][: 5 + 7 * pid]
        rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
        merged2 = dist.merge_sorted_blocks(rows, device="cpu", group=group)

        raln, rtgt, rpath, batch = _ring_fixture()
        d4 = _d4_steps(dist.global_mesh(group, 2, device="cpu"), raln, rtgt,
                       rpath, batch)
    np.savez(os.path.join(outdir, "proc%d.npz" % pid), hist=hist,
             merged=merged, merged2=merged2, **d4)
    print("proc %d ok" % pid)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_steps(tmp_path):
    """2 gloo processes: distributed_coverage and merge_sorted_blocks hold
    the same results on both processes, equal to test_multiprocess.py's
    single-process oracle; the P = 2 x L = 2 replicated, table-sharded and
    ring-sharded steps, concatenated in process order, equal the same steps
    over 4 local shards of one process."""
    from hal_tpu.ops import segmap_host as sm
    from hal_tpu.randgen import create_random_alignment
    from hal_tpu_torch.parallel.mesh import Mesh

    port = str(_free_port())
    env = dict(os.environ)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), "2", port,
         str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    r = [np.load(tmp_path / ("proc%d.npz" % k)) for k in range(2)]
    for key in ("hist", "merged", "merged2", "rep_cov"):
        assert np.array_equal(r[0][key], r[1][key]), key

    # test_multiprocess.py's single-process oracle
    aln = create_random_alignment(seed=17, max_genomes=5, min_genomes=4,
                                  min_segments=6, max_segments=30,
                                  min_segment_length=4, max_segment_length=12)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    tg = aln.open_genome(tgt)
    rng = np.random.default_rng(3)
    n = 64
    lo = rng.integers(0, g.length - 2, n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 20, n), g.length)
    diff = np.zeros(tg.length + 1, np.int64)
    for i in range(n):
        frags = sm.map_source(aln, src, lo[i:i + 1], hi[i:i + 1], tgt)
        np.add.at(diff, frags.tgt_lo, 1)
        np.add.at(diff, frags.tgt_hi, -1)
    want = np.cumsum(diff[:-1])
    assert want.sum() > 0 and np.array_equal(r[0]["hist"], want)
    assert np.array_equal(r[0]["merged"], np.sort(lo))
    rows = np.concatenate([np.stack([lo, hi], axis=1)[k::3][: 5 + 7 * k]
                           for k in range(2)])
    rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    assert len(r[0]["merged2"]) == 5 + 12
    assert np.array_equal(r[0]["merged2"], rows)

    raln, rtgt, rpath, batch = _ring_fixture()
    one = _d4_steps(Mesh(4, 1, device="cpu"), raln, rtgt, rpath, batch)
    assert np.array_equal(r[0]["rep_cov"], one["rep_cov"])
    for key in ("rep_F", "tab_F", "ring_F", "tab_ovf", "ring_ovf"):
        axis = 1 if key.endswith("_F") else 0
        got = np.concatenate([r[0][key], r[1][key]], axis=axis)
        assert np.array_equal(got, one[key]), key
    assert not one["ring_ovf"].any() and not one["tab_ovf"].any()
    assert (one["ring_F"][6] > 0).any()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
