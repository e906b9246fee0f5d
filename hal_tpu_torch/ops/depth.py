"""Alignment depth on the torch port — hal_tpu.ops.depth.

The host half is a copy of the original's (numpy only, imports pointing at
hal_tpu_torch): depth_counts, rle_decode, write_wiggle, write_wiggle_runs.

The device half is torch: per scope genome, the reference window is mapped
by the segment mapper (segmap_torch._run_path) and the fragments' source
intervals become a +1/-1 scatter into window + 1 int32 slots whose prefix
sum (kernels.cumsum_i32, the scan kernel) is the coverage; every genome's
coverage is accumulated on the device and fetched once.  The run-length
encoding of the counts also runs on the device (_n_runs, _pack), so a
drain moves (start, value) pairs instead of the dense vector.

Where the JAX package scatters with every capacity slot (slots that are not
valid adding 0) or drops rows with mode="drop", the rows that must not
count land in a spare region that is cut off (segmap_torch.spare_index).
"""

from __future__ import annotations

import numpy as np
import torch

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.ops import kernels
from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.ops import tables


# ------------------------------------------------------------------ host
# (copies of hal_tpu.ops.depth's host functions)

def depth_counts(aln: Alignment, ref: str, gs: int, ge: int, scope, scope_root,
                 count_dupes: bool = False, no_ancestors: bool = False) -> np.ndarray:
    """Counts over the reference window [gs, ge) in genome coordinates.

    count = (unique genomes aligned | total aligned positions) - 1, matching
    the reference's `--count` (which removes the reference's own
    contribution, halAlignmentDepth.cpp:258-280).
    """
    n = ge - gs
    diff = np.zeros(n + 1, np.int64)
    tree = aln.tree
    for g in sorted(scope):
        if no_ancestors and not tree.is_leaf(g):
            continue
        frags = sm.map_source(aln, ref, np.array([gs]), np.array([ge]), g,
                              do_dupes=True, coalescence_limit=scope_root)
        if len(frags) == 0:
            continue
        if count_dupes:
            np.add.at(diff, frags.src_lo - gs, 1)
            np.add.at(diff, frags.src_hi - gs, -1)
        else:
            # unique-genome indicator: union of fragment src intervals,
            # vectorized — sort by lo, running max of hi; an interval opens
            # a new union run iff its lo clears every earlier hi
            lo = np.sort(frags.src_lo, kind="stable")
            order = np.argsort(frags.src_lo, kind="stable")
            hi = np.maximum.accumulate(frags.src_hi[order])
            new = np.ones(len(lo), bool)
            new[1:] = lo[1:] > hi[:-1]
            idx = np.flatnonzero(new)
            starts = lo[idx]
            ends = np.empty(len(idx), np.int64)
            ends[:-1] = hi[idx[1:] - 1]
            ends[-1] = hi[-1]
            np.add.at(diff, starts - gs, 1)
            np.add.at(diff, ends - gs, -1)
    counts = np.cumsum(diff[:-1])
    return counts - 1  # remove the reference's own contribution


def rle_decode(starts: np.ndarray, values: np.ndarray, window: int) -> np.ndarray:
    """Dense int64 counts from (starts, values) runs over [0, window)."""
    if len(starts) == 0:
        return np.zeros(window, np.int64)
    lengths = np.diff(np.append(starts, window))
    return np.repeat(values.astype(np.int64), lengths)


def write_wiggle(out, seq_name: str, start: int, counts: np.ndarray, step: int = 1) -> None:
    """fixedStep wiggle emission (reference halAlignmentDepth.cpp:247-280)."""
    out.write("fixedStep chrom=%s start=%d step=%d\n" % (seq_name, start + 1, step))
    vals = counts[::step] if step > 1 else counts
    out.write("\n".join(str(int(v)) for v in vals))
    out.write("\n")


def write_wiggle_runs(out, seq_name: str, start: int, starts: np.ndarray,
                      values: np.ndarray, window: int, step: int = 1) -> None:
    """fixedStep emission straight from RLE runs — byte-identical to
    write_wiggle(rle_decode(starts, values, window)) but O(runs) string
    work at step 1 (the reference's fixedStep output IS a per-position
    dump; its value stream is what the runs compress)."""
    if step > 1:
        write_wiggle(out, seq_name, start,
                     rle_decode(starts, values, window), step)
        return
    out.write("fixedStep chrom=%s start=%d step=%d\n" % (seq_name, start + 1, step))
    lengths = np.diff(np.append(starts, window))
    out.write("".join(("%d\n" % v) * int(ln)
                      for v, ln in zip(values, lengths)))


# ---------------------------------------------------------------- device

def _depth_one(path: st.PathData, lo, hi, caps, window: int,
               count_dupes: bool):
    """One genome's coverage of the window [lo[0], hi[0]) as int32 (a 0/1
    indicator unless count_dupes), and the capacity overflow flag."""
    owner = torch.zeros(1, dtype=lo.dtype, device=lo.device)
    F, _bound, ovf, _ = st._run_path(path, lo, hi, owner, caps)
    valid = F[st.C_VALID] > 0
    s0 = st.spare_index(valid, (F[st.C_SLO] - lo[0]).clamp(0, window),
                     window + 1)
    s1 = st.spare_index(valid, (F[st.C_SHI] - lo[0]).clamp(0, window),
                     window + 1)
    one = torch.ones(F.shape[1], dtype=torch.int32, device=lo.device)
    d = torch.zeros(window + 1 + st.spare_width(F.shape[1]), dtype=torch.int32,
                    device=lo.device)
    d.index_add_(0, s0, one)
    d.index_add_(0, s1, -one)
    cover = kernels.cumsum_i32(d[:window + 1])[:window]
    if not count_dupes:
        cover = cover > 0
    return cover, ovf


def _change(counts):
    """True where a run of equal counts starts."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=counts.device),
                      counts[1:] != counts[:-1]])


def _n_runs(counts) -> torch.Tensor:
    return _change(counts).sum()


def _pack(counts, cap: int):
    """(2, cap) int32 wire of the runs' (start, value), the run total and
    the overflow flag (more than cap runs)."""
    n = counts.shape[0]
    change = _change(counts)
    rid = kernels.cumsum_i32(change.to(torch.int32)) - 1
    total = rid[-1] + 1
    pos = torch.arange(n, dtype=torch.int32, device=counts.device)
    idx = st.spare_index(change & (rid < cap), rid, cap)
    wire = torch.zeros((2, cap + st.spare_width(n)), dtype=torch.int32,
                       device=counts.device)
    wire[0].scatter_(0, idx, pos)
    wire[1].scatter_(0, idx, counts)
    return wire[:, :cap], total, total > cap


def rle_encode_device(counts_dev: torch.Tensor):
    """RLE a device int32 vector: returns (starts int64, values int64)
    numpy arrays — one scalar fetch to size the wire, then ONE fetch of
    the (2, n_runs-bucketed) int32 wire.  An empty vector gives empty
    arrays; a wire overflow raises RuntimeError."""
    if counts_dev.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    k = int(_n_runs(counts_dev).item())
    wire, _total, ovf = _pack(counts_dev, tables._bucket_cap(k))
    W = wire.cpu().numpy()
    if bool(ovf.item()):
        raise RuntimeError("device RLE overflow: %d runs sized, more found"
                           % k)
    return W[0, :k].astype(np.int64), W[1, :k].astype(np.int64)


class DepthEngine:
    """Device column-depth engine with a strict host-prep / device-run
    split.

    The constructor does ALL host work: per-genome PathData tables, exact
    full-traversal sizing (tables.host_path_totals — covers paralogy
    branches, so device overflow is an invariant violation rather than a
    retry), and the host-side dupe-count accumulations.

    run() does ONLY device work: every genome's program is launched
    back-to-back (nothing waits between genomes), the coverage vector is
    accumulated on the device, then ONE fetch of (overflow flags, counts).
    """

    def __init__(self, aln: Alignment, ref: str, gs: int, ge: int, scope,
                 scope_root, count_dupes: bool = False,
                 no_ancestors: bool = False, *, device):
        self.device = torch.device(device)
        self.window = int(ge - gs)
        self.gs, self.ge = int(gs), int(ge)
        self.count_dupes = count_dupes
        tree = aln.tree
        # per-alignment caches: PathData tables and the ring CSRs (the
        # host sim's, which the tables read too) are WINDOW-INDEPENDENT —
        # the halAlignmentDepth tool constructs one engine per window
        caches = getattr(aln, "_depth_caches", None)
        if caches is None:
            caches = aln._depth_caches = {
                "sim": tables._HostSim(aln, do_dupes=True), "paths": {}}
        sim = caches["sim"]
        path_cache = caches["paths"]
        self.jobs = []   # (path, lo, hi, caps)
        self.genomes = []  # the scope genome of each job
        host_base = np.zeros(self.window, np.int64)
        for g in sorted(scope):
            if no_ancestors and not tree.is_leaf(g):
                continue
            mrca = tree.lca(ref, g)
            limit = scope_root if scope_root != mrca else None
            if count_dupes and limit is not None:
                # paralogy branches return un-deduped fragments; dupe
                # COUNTS (not the unique indicator) need the host's
                # deduped set
                frags = sm.map_source(aln, ref, np.array([gs]),
                                      np.array([ge]), g, do_dupes=True,
                                      coalescence_limit=limit)
                d = np.zeros(self.window + 1, np.int64)
                np.add.at(d, frags.src_lo - gs, 1)
                np.add.at(d, frags.src_hi - gs, -1)
                host_base += np.cumsum(d[:-1])
                continue
            pkey = (ref, g, limit, str(self.device))
            path = path_cache.get(pkey)
            if path is None:
                path = path_cache[pkey] = st.PathData.build(
                    aln, ref, g, do_dupes=True, coalescence_limit=limit,
                    device=self.device, rings=sim.rings)
            totals, _final = tables.host_path_totals(
                aln, ref, g, [gs], [ge], do_dupes=True,
                coalescence_limit=limit, sim=sim)
            caps = tables.caps_from_totals(path, totals, slack=1.0)
            self.jobs.append((path, st.coords(path, [gs]),
                              st.coords(path, [ge]), caps))
            self.genomes.append(g)
        self._host_base = host_base
        # the drains' host work on these counts, done here once: their sum,
        # and a device copy that run_runs adds before the device RLE
        self._host_base_sum = float(host_base.sum())
        self._host_base_dev = (
            torch.from_numpy(host_base.astype(np.int32)).to(self.device)
            if host_base.any() else None)

    def _dispatch(self):
        total = torch.zeros(self.window, dtype=torch.int32,
                            device=self.device)
        ovfs = []
        for (path, lo, hi, caps) in self.jobs:
            cover, ovf = _depth_one(path, lo, hi, caps, self.window,
                                    self.count_dupes)
            total += cover
            ovfs.append(ovf)
        return total, ovfs

    @staticmethod
    def _check(ovfs):
        if ovfs and bool(torch.stack(ovfs).any().item()):
            # host-sized caps must never overflow; a truncated coverage
            # vector must not be returned silently
            raise RuntimeError(
                "device depth overflow under host-sized caps: host sizing "
                "algebra diverged from the device expansion")

    def run(self):
        """Dispatch all genomes, accumulate on device, fetch once.
        Returns (counts int64 ndarray, columns)."""
        total, ovfs = self._dispatch()
        self._check(ovfs)
        counts = total.cpu().numpy().astype(np.int64)
        counts += self._host_base
        return counts - 1, self.window

    def run_runs(self):
        """Dispatch + accumulate on device, then drain the counts as RLE
        (pos, value) runs instead of the dense vector.  Returns (starts
        int64, values int64, window) where values are the FINAL counts
        (host-base added, reference's own contribution removed);
        rle_decode(starts, values, window) equals run()'s counts exactly.
        The host mapper's dupe counts are added on the device before the
        RLE (the original adds them to the decoded vector on the host and
        encodes it again: the same runs)."""
        total, ovfs = self._dispatch()
        self._check(ovfs)
        if self._host_base_dev is not None:
            total += self._host_base_dev
        starts, vals = rle_encode_device(total)
        return starts, vals - 1, self.window

    def run_device_only(self):
        """Dispatch + accumulate, syncing on SCALARS only (overflow flags
        + the counts sum) — no window-sized download, so a benchmark times
        the device phase apart from the drain.  Returns (mean depth,
        columns, the on-device counts for a later drain)."""
        total, ovfs = self._dispatch()
        s = total.sum()
        self._check(ovfs)
        mean = ((float(s.item()) + self._host_base_sum) / self.window) - 1.0
        return mean, self.window, total


def depth_counts_device(aln: Alignment, ref: str, gs: int, ge: int, scope,
                        scope_root, count_dupes: bool = False,
                        no_ancestors: bool = False, *, device):
    """Device column-depth engine: per-genome window mapping stays on the
    device and reduces to a coverage vector there; only its RLE runs are
    transferred.  Returns (counts ndarray, columns processed) — counts
    equal depth_counts() exactly."""
    eng = DepthEngine(aln, ref, gs, ge, scope, scope_root,
                      count_dupes=count_dupes, no_ancestors=no_ancestors,
                      device=device)
    starts, vals, window = eng.run_runs()
    return rle_decode(starts, vals, window), window
