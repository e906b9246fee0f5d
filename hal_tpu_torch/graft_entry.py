"""Driver entry points on the port — __graft_entry__.py's entry() (the
flagship step and its example arguments) and dryrun_multichip(n) (the
sharded steps at real scale against the host oracle).

dryrun_multichip runs in one process: its mesh is n local shards on one
device (parallel.mesh), whose collectives are tensor operations.  It
prints one JSON record and writes no file (the original also writes
MULTICHIP_DETAIL.json next to itself, ROADMAP §3.m).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def _bench_alignment(max_genomes=6, seed=0, n_bot=400, seg=40):
    from hal_tpu_torch.randgen import create_random_alignment

    return create_random_alignment(
        seed=seed, max_genomes=max_genomes, min_genomes=4,
        min_segment_length=seg, max_segment_length=seg + 10,
        min_segments=n_bot // 2, max_segments=n_bot)


def _leaf_pair(aln):
    names = aln.genome_names()
    leaves = [n for n in names if aln.tree.is_leaf(n)]
    src = leaves[0]
    tgt = leaves[-1] if len(leaves) > 1 and leaves[-1] != src else aln.root_name
    return src, tgt


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship path — the
    batched segment-map (liftover) traversal, segmap_torch._run_path — on
    `device`."""
    from hal_tpu_torch.ops import segmap_torch as st

    aln = _bench_alignment()
    src, tgt = _leaf_pair(aln)
    path = st.PathData.build(aln, src, tgt, device=device)
    n = 256
    caps = tuple(int(n * 4 * (min(lv.max_ring + 1, 4) if lv.max_ring else 1))
                 for lv in path.levels)
    g = aln.open_genome(src)
    rng = np.random.default_rng(0)
    lo = rng.integers(0, max(g.length - 50, 1), n)
    hi = np.minimum(lo + rng.integers(1, 50, n), g.length)
    owner = np.arange(n)

    def fn(lo, hi, owner):
        F, bound, _overflow, _lt = st._run_path(
            path, st.coords(path, lo), st.coords(path, hi),
            st.coords(path, owner), caps)
        return F, bound

    return fn, (lo, hi, owner)


def _frag_pairs(s_lo, s_hi, t_lo, t_hi, rev):
    """Fragments as their (src base, tgt base) pair set — the mapping's
    canonical form, insensitive to fragmentation and dedup layout."""
    ln = (s_hi - s_lo).astype(np.int64)
    tot = int(ln.sum())
    rep = np.repeat(np.arange(len(ln)), ln)
    k = np.arange(tot) - (np.cumsum(ln) - ln)[rep]
    src = s_lo[rep] + k
    tgt = np.where(rev[rep] > 0, t_hi[rep] - 1 - k, t_lo[rep] + k)
    return np.unique(np.stack([src, tgt], axis=1), axis=0)


def _valid_columns(F) -> np.ndarray:
    """F's valid columns as an int64 numpy matrix."""
    from hal_tpu_torch.ops.segmap_torch import C_VALID

    M = F.cpu().numpy().astype(np.int64)
    return M[:, M[C_VALID].astype(bool)]


def per_shard_caps(aln, src, tgt, path, lo, hi, n_shards, sim=None):
    """Exact per-shard capacities: host totals per contiguous data shard
    (the shard_batch layout), elementwise max across shards."""
    from hal_tpu_torch.ops import tables

    per = len(lo) // n_shards
    maxed = None
    sim = sim or tables._HostSim(aln, do_dupes=True)
    for k in range(n_shards):
        totals, _ = tables.host_path_totals(
            aln, src, tgt, lo[k * per:(k + 1) * per],
            hi[k * per:(k + 1) * per], sim=sim)
        maxed = totals if maxed is None else [
            (max(a, c), max(b, d)) for (a, b), (c, d) in zip(maxed, totals)]
    return tables.caps_from_totals(path, maxed, slack=1.0)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Build an n_devices-shard mesh on `device` and run the sharded steps
    at real scale: >= 8k intervals over a >= 100k-segment fixture, exact
    per-shard capacities, each step held to the host mapper (pair sets)
    and to the coverage mass (the histogram), and the sharded column step's
    MAF to iter_slices_exact.  Prints the record as one JSON line and
    returns it; raises on any failed check."""
    from hal_tpu_torch.io.maf_io import MafBlockBuilder
    from hal_tpu_torch.ops import column_torch as ct
    from hal_tpu_torch.ops import segmap_host as sm
    from hal_tpu_torch.ops import segmap_torch as st
    from hal_tpu_torch.ops import tables
    from hal_tpu_torch.ops.column import iter_slices_exact
    from hal_tpu_torch.parallel.ring_sharded import (build_ring_path,
                                                     make_ring_sharded_step)
    from hal_tpu_torch.parallel.sharded import (make_mesh, make_sharded_step,
                                                make_table_sharded_step,
                                                shard_batch,
                                                shard_path_tables)

    device = torch.device(device)
    detail = {"n_devices": n_devices, "device": str(device)}

    aln = _bench_alignment(max_genomes=6, n_bot=24000, seg=12)
    total_segs = sum(aln.open_genome(g).num_top_segments
                     + aln.open_genome(g).num_bottom_segments
                     for g in aln.genome_names())
    src, tgt = _leaf_pair(aln)
    path = st.PathData.build(aln, src, tgt, device=device)
    tg = aln.open_genome(tgt)
    sg = aln.open_genome(src)
    detail["fixture"] = {"genomes": aln.num_genomes, "segments": total_segs,
                         "path_levels": len(path.levels)}
    if total_segs < 100000:
        raise AssertionError("fixture of %d segments" % total_segs)

    n = 8192
    rng = np.random.default_rng(1)
    lo = rng.integers(0, max(sg.length - 24, 1), n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 24, n), sg.length).astype(np.int64)
    owner = np.arange(n, dtype=np.int64)

    # host oracle: the full mapping as a (src, tgt) base-pair set
    hf = sm.map_source(aln, src, lo, hi, tgt, do_dupes=True)
    want = _frag_pairs(hf.src_lo, hf.src_hi, hf.tgt_lo, hf.tgt_hi,
                      hf.rev.astype(np.int64))
    # expected histogram mass: the UN-deduped fragment multiset, which the
    # host twin of the device algebra counts exactly
    sim = tables._HostSim(aln, do_dupes=True)
    s_lo2, s_hi2 = lo.copy(), hi.copy()
    cur = src
    for nxt in aln.tree.path(src, tgt)[1:]:
        s_lo2, s_hi2, _sv, _rv = sim.level(cur, nxt, s_lo2, s_hi2, rings=True)
        cur = nxt
    want_cov = int((s_hi2 - s_lo2).sum())

    def device_pairs(F):
        M = _valid_columns(F)
        return _frag_pairs(M[st.C_SLO], M[st.C_SHI], M[st.C_TLO],
                          M[st.C_THI], M[st.C_REV])

    def check(ok, what):
        if not ok:
            raise AssertionError(what)

    # step 1: replicated tables, queries sharded over data, the coverage
    # histogram summed over data and sharded over coord
    n_coord = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_coord
    mesh = make_mesh(n_data, n_coord, device=device)
    caps = per_shard_caps(aln, src, tgt, path, lo, hi, n_data, sim)
    n_bins = 16 * n_coord
    frags, cov = make_sharded_step(path, caps, tg.length, n_bins, mesh)(
        *shard_batch(mesh, lo, hi, owner))
    got = device_pairs(frags)
    ok1 = np.array_equal(got, want)
    cov_ref = cov.cpu().numpy()
    detail["replicated_step"] = {
        "mesh": [n_data, n_coord], "intervals": n, "fragments": len(got),
        "oracle_pairs_equal": bool(ok1), "coverage_sum": int(cov_ref.sum()),
        "coverage_expected": want_cov}
    check(ok1, "replicated step diverges from the host mapper")
    check(int(cov_ref.sum()) == want_cov, "replicated step coverage mass")

    def host_cov(F):
        """The un-deduped coverage histogram of a step's fragments, binned
        as step 1 bins on the device (int64)."""
        M = _valid_columns(F)
        t_lo, t_hi = M[st.C_TLO], M[st.C_THI]
        b = np.clip(t_lo * n_bins // max(tg.length, 1), 0, n_bins - 1)
        h = np.zeros(n_bins, np.int64)
        np.add.at(h, b, t_hi - t_lo)
        return h

    # step 2: table-sharded traversal — each level's tables rest 1/D per
    # shard and are gathered just before its hop, then dropped
    mesh_flat = make_mesh(n_devices, 1, device=device)
    caps2 = per_shard_caps(aln, src, tgt, path, lo, hi, n_devices, sim)
    F2, ovf2 = make_table_sharded_step(shard_path_tables(path, mesh_flat),
                                       caps2, mesh_flat)(
        *shard_batch(mesh_flat, lo, hi, owner))
    check(not bool(ovf2.any().item()), "table-sharded step overflow")
    ok2 = np.array_equal(device_pairs(F2), want)
    cov2 = host_cov(F2)
    ok2c = int(cov2.sum()) == want_cov and np.array_equal(cov2, cov_ref)
    detail["table_sharded_step"] = {
        "mesh": [n_devices, 1], "intervals": n,
        "oracle_pairs_equal": bool(ok2), "coverage_sum": int(cov2.sum()),
        "coverage_expected": want_cov, "coverage_hist_equal": bool(ok2c),
        "oracle_pair_count": int(len(want))}
    check(ok2, "table-sharded step diverges from the host mapper")
    check(ok2c, "table-sharded coverage histogram diverges")

    # step 3: shard-LOCAL traversal — tables never rematerialize; fragments
    # move to the owning shard per level (one all_to_all)
    per = n // n_devices
    caps3 = tuple((tables._next_pow2(per * 8), tables._next_pow2(per * 8),
                   tables._next_pow2(per * 16), tables._next_pow2(per * 16))
                  for _ in path.levels)
    F3, ovf3 = make_ring_sharded_step(build_ring_path(path, n_devices),
                                      caps3, mesh_flat)(
        *shard_batch(mesh_flat, lo, hi, owner))
    check(not bool(ovf3.any().item()), "ring-sharded step overflow")
    ok3 = np.array_equal(device_pairs(F3), want)
    cov3 = host_cov(F3)
    ok3c = int(cov3.sum()) == want_cov and np.array_equal(cov3, cov_ref)
    detail["ring_sharded_step"] = {
        "mesh": [n_devices, 1], "intervals": n,
        "oracle_pairs_equal": bool(ok3), "coverage_sum": int(cov3.sum()),
        "coverage_expected": want_cov, "coverage_hist_equal": bool(ok3c)}
    check(ok3, "ring-sharded step diverges from the host mapper")
    check(ok3c, "ring-sharded coverage histogram diverges")

    # step 4: the device column engine with the window sharded over data;
    # the assembled MAF must equal the exact DFS engine's bytes
    eng = ct.DeviceColumnEngine(aln, src, device=device)
    W4 = min(int(sg.length), 6144)
    edges = np.linspace(0, W4, n_devices + 1).astype(np.int64)
    caps_all, oc_all = ct.size_sharded_caps(eng, edges)
    lo_sh, hi_sh = (torch.from_numpy(e).to(device)
                    for e in (edges[:-1].copy(), edges[1:].copy()))
    outs = ct.make_sharded_column_step(eng, caps_all, oc_all, mesh_flat)(
        lo_sh, hi_sh)
    frags4 = ct.collect_sharded(eng, outs, edges)

    def maf(slices):
        b = MafBlockBuilder(aln, src, ucsc_names=True)
        blocks = list(b.feed(slices))
        t = b.flush_end()
        if t:
            blocks.append(t)
        return "\n".join(blocks)

    got_maf = maf(ct.slices_from_frags(aln, src, 0, W4, frags4))
    want_maf = maf(iter_slices_exact(aln, src, 0, W4))
    ok4 = got_maf == want_maf
    detail["column_step"] = {
        "mesh": [n_devices, 1], "window_columns": int(W4),
        "programs": len(eng.jobs),
        "fragments": sum(len(s.s_lo) for ps in frags4.values()
                         for _o, s in ps),
        "maf_bytes": len(want_maf), "maf_byte_equal": bool(ok4)}
    check(ok4, "sharded device column engine MAF diverges from exact DFS")

    detail["ok"] = True
    sys.stdout.write(json.dumps(detail) + "\n")
    return detail
