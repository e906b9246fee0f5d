"""benchScaling on the torch port — hal_tpu.tools.benchScaling's sweep of
the sharded liftover + depth step (and its table-sharded, ring-sharded and
--column variants) over meshes of 1, 2, ... shards, reporting intervals/s
and the efficiency against the one-shard rate.

Mesh sizes are shard counts, and every shard is a local shard of this one
process on --device (hal_tpu_torch.parallel.mesh): on one GPU the sweep
measures the overhead of cutting a batch into shards, not multi-GPU
scaling, and its summary line says so.  The JSON keys are the original's,
plus "device" and "measures" in the summary.

    python -m hal_tpu_torch.tools.benchScaling --devices 1,2,4 --device cuda
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from hal_tpu_torch.tools import make_parser, tool_main

MEASURES = ("local-shard overhead on one device: every shard of a mesh is a "
            "local shard of one process, so this is not multi-GPU scaling")


def run(argv=None):
    p = make_parser("benchScaling", "Sharded-step scaling benchmark")
    p.add_argument("--devices", default="1,2,4,8",
                   help="comma list of mesh sizes, in local shards")
    p.add_argument("--nIntervals", type=int, default=1 << 16)
    p.add_argument("--nGenomes", type=int, default=6)
    p.add_argument("--nSegments", type=int, default=800)
    p.add_argument("--fixtureSizes", default="",
                   help="comma list of nSegments values to sweep; default: "
                        "just --nSegments")
    p.add_argument("--column", action="store_true",
                   help="also time the sharded device COLUMN step "
                        "(hal2maf structure discovery) per mesh size")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda",
                   help="torch device of every shard (default cuda)")
    o = p.parse_args(argv)

    device = torch.device(o.device)
    sizes = [int(x) for x in o.devices.split(",") if x]
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    sys.stderr.write("device %s (%s); mesh sizes %s in local shards\n"
                     % (device, kind, sizes))
    fixture_sizes = ([int(x) for x in o.fixtureSizes.split(",") if x]
                     or [o.nSegments])
    all_rows = []
    for n_segments in fixture_sizes:
        _sweep_fixture(o, n_segments, sizes, device, all_rows)
    if all_rows:
        print(json.dumps({"metric": "sharded_scaling", "results": all_rows,
                          "device": kind, "measures": MEASURES}))


def _timed(fn, iters: int, device) -> tuple:
    """(last result, seconds per call) of fn() after one warm call, the
    device synchronised before and after."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync()
    return out, (time.perf_counter() - t0) / iters


def _sweep_fixture(o, n_segments, sizes, device, all_rows):
    from hal_tpu_torch.ops.segmap_torch import PathData
    from hal_tpu_torch.parallel.ring_sharded import (build_ring_path,
                                                     make_ring_sharded_step)
    from hal_tpu_torch.parallel.sharded import (make_mesh, make_sharded_step,
                                                make_table_sharded_step,
                                                shard_batch,
                                                shard_path_tables)
    from hal_tpu_torch.randgen import create_random_alignment

    aln = create_random_alignment(
        seed=o.seed, max_genomes=o.nGenomes, min_genomes=o.nGenomes - 1,
        min_segment_length=40, max_segment_length=60,
        min_segments=n_segments // 2, max_segments=n_segments)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    src, tgt = leaves[0], leaves[-1]
    sg, tg = aln.open_genome(src), aln.open_genome(tgt)
    path = PathData.build(aln, src, tgt, device=device)

    rng = np.random.default_rng(0)
    n = o.nIntervals
    lo = rng.integers(0, max(sg.length - 100, 1), n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 100, n), sg.length).astype(np.int64)
    owner = np.arange(n, dtype=np.int64)

    base_rate = None
    for nd in sizes:
        mesh = make_mesh(nd, 1, device=device)
        per_dev = -(-n // nd)
        caps = tuple((int(per_dev * 8), int(per_dev * 8)) if
                     (lv.kind == "down" and lv.max_ring) else int(per_dev * 8)
                     for lv in path.levels)
        args = shard_batch(mesh, lo, hi, owner)
        step = make_sharded_step(path, caps, tg.length, 16, mesh)
        _out, dt = _timed(lambda: step(*args), o.iters, device)
        rate = n / dt
        if base_rate is None:
            base_rate = rate
        row = {"devices": nd, "fixture_segments": n_segments,
               "intervals_per_s": round(rate, 1),
               "scaling_efficiency": round(rate / (base_rate * nd), 3)}
        # table-sharded variant (tables rest 1/D per shard, gathered per hop)
        if nd > 1:
            tstep = make_table_sharded_step(shard_path_tables(path, mesh),
                                            caps, mesh)
            (_Ft, ovt), tdt = _timed(lambda: tstep(*args), o.iters, device)
            if not bool(ovt.any().item()):
                row["table_sharded_intervals_per_s"] = round(n / tdt, 1)
        # sharded device column engine (window data-parallel over the mesh)
        if o.column:
            from hal_tpu_torch.ops import column_torch as ct

            eng = ct.DeviceColumnEngine(aln, src, device=device)
            W = min(int(sg.length), 1 << 14)
            edges = np.linspace(0, W, nd + 1).astype(np.int64)
            caps_all, oc_all = ct.size_sharded_caps(eng, edges)
            cstep = ct.make_sharded_column_step(eng, caps_all, oc_all, mesh)
            lo_sh = torch.from_numpy(edges[:-1].copy()).to(device)
            hi_sh = torch.from_numpy(edges[1:].copy()).to(device)
            _outs, cdt = _timed(lambda: cstep(lo_sh, hi_sh), o.iters, device)
            row["column_cols_per_s"] = round(W / cdt, 1)
            row["column_programs"] = len(eng.jobs)
        # shard-local variant: tables never rematerialize; reports the
        # all_to_all routing overhead
        if nd > 1 and not path.para:
            rcaps = tuple((int(per_dev * 8), int(per_dev * 8),
                           int(per_dev * 16), int(per_dev * 16))
                          for _ in path.levels)
            rstep = make_ring_sharded_step(build_ring_path(path, nd), rcaps,
                                           mesh)
            (_Fr, ovf), rdt = _timed(lambda: rstep(*args), o.iters, device)
            if not bool(ovf.any().item()):
                row["ring_intervals_per_s"] = round(n / rdt, 1)
        all_rows.append(row)
        print(json.dumps(row))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
