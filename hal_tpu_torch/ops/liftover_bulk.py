"""Bulk BED liftover.  The host halves (the host bulk_map, atomize_by_owner,
extract_runs_bulk) are a port copy of hal_tpu/ops/liftover_bulk.py:30-204
(numpy only; extract_runs_bulk keeps only its numpy branch, which gives
the same arrays as the optional native helper of the JAX package).  The
device branches (bulk_map(use_device=True), bulk_runs_device,
bulk_liftover_bed3) run the torch segment mapper.

Pipeline, with per-interval semantics identical to ops/liftover's
line-at-a-time path:

  1. one batched map (segmap_torch.map_batch on `device`, segmap_host on
     the host) with owner ids,
  2. owner-aware atomize + dedup with composite integer keys (owner-scaled
     positions) — pure numpy, no per-interval Python,
  3. run extraction: on the device (runs_packed) or on the host, where
     owners with no duplicated target interval go through a vectorized
     chain merge and owners with dupe classes through the exact
     extractSegment-semantics Python path (ops/liftover.extract_runs),
  4. bulk BED formatting.
"""

from __future__ import annotations

import numpy as np
import torch

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.ops import tables
from hal_tpu_torch.ops.liftover import extract_runs

LEN_BITS = 8  # run lengths < 2^8 on the wire: intervals of at most 255 bp


def _composite(owner, pos, scale):
    return owner * scale + pos


def bulk_map(aln: Alignment, src: str, tgt: str, lo, hi, do_dupes=True,
             use_device=True, coalescence_limit=None, *, device):
    """(src_lo, src_hi, tgt_lo, tgt_hi, rev, owner) fragments for a batch of
    intervals (owner = input index), un-atomized.  use_device=True runs the
    torch segment mapper on `device`; use_device=False the host mapper
    (segmap_host.map_source), as in hal_tpu.ops.liftover_bulk."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if use_device:
        path = st.PathData.build(aln, src, tgt, do_dupes=do_dupes,
                                 coalescence_limit=coalescence_limit,
                                 device=device)
        return st.map_batch(path, lo, hi)
    # host: map per batch with owner tracking by running the shared-fragment
    # machinery one owner-batch at a time is too slow; instead exploit that
    # map_source output src intervals lie within the input intervals, so
    # owners can be recovered by interval containment when inputs are
    # disjoint.  For the general case (overlapping inputs), map per interval.
    frags = []
    order = np.argsort(lo, kind="stable")
    disjoint = True
    last_hi = -1
    for i in order:
        if lo[i] < last_hi:
            disjoint = False
            break
        last_hi = hi[i]
    if disjoint and len(lo):
        f = sm.map_source(aln, src, lo, hi, tgt, do_dupes=do_dupes,
                          coalescence_limit=coalescence_limit)
        slo = np.asarray(lo)[order]
        own_sorted = np.asarray(order)
        j = np.searchsorted(slo, f.src_lo, side="right") - 1
        owner = own_sorted[np.clip(j, 0, max(len(slo) - 1, 0))]
        return (f.src_lo, f.src_hi, f.tgt_lo, f.tgt_hi, f.rev, owner.astype(np.int64))
    outs = []
    for i in range(len(lo)):
        f = sm.map_source(aln, src, lo[i:i+1], hi[i:i+1], tgt, do_dupes=do_dupes,
                          coalescence_limit=coalescence_limit)
        outs.append((f.src_lo, f.src_hi, f.tgt_lo, f.tgt_hi, f.rev,
                     np.full(len(f), i, np.int64)))
    if not outs:
        z = np.zeros(0, np.int64)
        return (z, z, z, z, np.zeros(0, np.uint8), z)
    return tuple(np.concatenate([o[k] for o in outs]) for k in range(6))


def atomize_by_owner(s_lo, s_hi, t_lo, t_hi, rev, owner, pos_scale):
    """Owner-local atomize + dedup (the per-line insertAndBreakOverlaps)."""
    n = len(s_lo)
    if n == 0:
        return s_lo, s_hi, t_lo, t_hi, rev, owner
    # owner-scoped boundary set via composite keys
    keys = np.unique(np.concatenate([_composite(owner, t_lo, pos_scale),
                                     _composite(owner, t_hi, pos_scale)]))
    k_lo = _composite(owner, t_lo, pos_scale)
    k_hi = _composite(owner, t_hi, pos_scale)
    i0 = np.searchsorted(keys, k_lo, side="right")
    i1 = np.searchsorted(keys, k_hi, side="left")
    counts = (i1 - i0) + 1
    total = int(counts.sum())
    off = np.cumsum(counts) - counts
    j = np.arange(total, dtype=np.int64)
    own_idx = np.searchsorted(off + counts, j, side="right")
    k = j - off[own_idx]
    lo_k = np.where(k == 0, t_lo[own_idx],
                    keys[np.minimum(i0[own_idx] + k - 1, len(keys) - 1)] % pos_scale)
    is_last = k == counts[own_idx] - 1
    hi_k = np.where(is_last, t_hi[own_idx],
                    keys[np.minimum(i0[own_idx] + k, len(keys) - 1)] % pos_scale)
    r = rev[own_idx]
    adv = np.where(r.astype(bool), t_hi[own_idx] - hi_k, lo_k - t_lo[own_idx])
    ns_lo = s_lo[own_idx] + adv
    out = (ns_lo, ns_lo + (hi_k - lo_k), lo_k, hi_k, r, owner[own_idx])
    # dedup on (owner, src, tgt, rev)
    key = np.stack([out[5], out[0], out[1], out[2], out[3],
                    out[4].astype(np.int64)], axis=1)
    _, idx = np.unique(key, axis=0, return_index=True)
    idx = np.sort(idx)
    return tuple(a[idx] for a in out)


def extract_runs_bulk(tg, s_lo, s_hi, t_lo, t_hi, rev, owner, pos_scale):
    """Runs per owner: vectorized for dupe-free owners, exact Python
    fallback for owners with dupe classes.

    Returns arrays (owner, run_tgt_lo, run_tgt_hi, run_src_start, run_rev)
    in per-owner set order."""
    n = len(s_lo)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, np.zeros(0, np.uint8)
    order = np.lexsort((rev, s_hi, s_lo, t_hi, t_lo, owner))
    s_lo, s_hi, t_lo, t_hi, rev, owner = (a[order] for a in
                                          (s_lo, s_hi, t_lo, t_hi, rev, owner))
    # dupe owners: same (owner, tgt_lo) appearing twice
    kk = _composite(owner, t_lo, pos_scale)
    dup_mask = np.zeros(n, bool)
    dup_mask[1:] = kk[1:] == kk[:-1]
    dup_owners = np.unique(owner[dup_mask])
    is_complex = np.isin(owner, dup_owners)

    # --- vectorized simple path --------------------------------------
    simp = ~is_complex
    so, ss_lo, ss_hi, st_lo, st_hi, srev = (owner[simp], s_lo[simp], s_hi[simp],
                                            t_lo[simp], t_hi[simp], rev[simp])
    m = len(so)
    out_owner = []
    out_lo = []
    out_hi = []
    out_src = []
    out_rev = []
    if m:
        seq_of = np.searchsorted(tg.seq_start, st_lo, side="right") - 1
        same_owner = so[1:] == so[:-1]
        same_rev = srev[1:] == srev[:-1]
        tgt_adj = st_lo[1:] == st_hi[:-1]
        src_adj = np.where(srev[:-1].astype(bool),
                           ss_lo[:-1] == ss_hi[1:],
                           ss_lo[1:] == ss_hi[:-1])
        same_seq = seq_of[1:] == seq_of[:-1]
        chain = same_owner & same_rev & tgt_adj & src_adj & same_seq
        starts = np.concatenate([[True], ~chain])
        first = np.flatnonzero(starts)
        last = np.append(first[1:] - 1, m - 1)
        out_owner.append(so[first])
        out_lo.append(st_lo[first])
        out_hi.append(st_hi[last])
        out_src.append(np.minimum(ss_lo[first], ss_lo[last]))
        out_rev.append(srev[first])

    # --- exact fallback for dupe owners ------------------------------
    if len(dup_owners):
        comp = is_complex
        co = owner[comp]
        cf = sm.Fragments(s_lo[comp], s_hi[comp], t_lo[comp], t_hi[comp], rev[comp])
        bounds = np.flatnonzero(np.concatenate([[True], co[1:] != co[:-1]]))
        ends = np.append(bounds[1:], len(co))
        for a, b in zip(bounds, ends):
            frag = sm.Fragments(cf.src_lo[a:b], cf.src_hi[a:b], cf.tgt_lo[a:b],
                                cf.tgt_hi[a:b], cf.rev[a:b])
            runs = extract_runs(frag, lambda p: int(np.searchsorted(tg.seq_start, p, side="right")) - 1)
            for run in runs:
                out_owner.append(np.array([co[a]], np.int64))
                out_lo.append(np.array([run[0].tgt_lo], np.int64))
                out_hi.append(np.array([run[-1].tgt_hi], np.int64))
                out_src.append(np.array([min(run[0].src_lo, run[-1].src_lo)], np.int64))
                out_rev.append(np.array([run[0].rev], np.uint8))

    if not out_owner:
        z = np.zeros(0, np.int64)
        return z, z, z, z, np.zeros(0, np.uint8)
    ro = np.concatenate(out_owner)
    rl = np.concatenate(out_lo)
    rh = np.concatenate(out_hi)
    rs = np.concatenate(out_src)
    rr = np.concatenate([x.astype(np.uint8) for x in out_rev])
    # per-owner ordering: set order then stable sort by src_start
    # (BedLineSrcLess) -> sort by (owner, src_start, tgt order) stably
    o2 = np.lexsort((rl, rs, ro))
    return ro[o2], rl[o2], rh[o2], rs[o2], rr[o2]


def bulk_runs_device(aln: Alignment, src: str, tgt: str, lo, hi, tg,
                     do_dupes=True, *, device):
    """Map + run merge + wire on the device, one copy to the host, decode;
    dupe-flagged owners are refined with the exact host extract_runs.
    Returns (owner, run_tgt_lo, run_tgt_hi, run_src_start, run_rev) like
    extract_runs_bulk, or None when the batch does not fit the 32-bit wire
    (coordinates >= 2^32 - 2, intervals > 255 bp, paralogy branches)."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    max_len = int((hi - lo).max()) if len(lo) else 0
    if max_len > 255:
        return None
    sim = tables._HostSim(aln, do_dupes)
    path = st.PathData.build(aln, src, tgt, do_dupes=do_dupes, device=device,
                             rings=sim.rings)
    if path.coord_kind == "int64":
        return None
    if path.para:
        return None  # branch caps need map_batch's retry loop
    totals, final = tables.host_path_totals(aln, src, tgt, lo, hi,
                                            do_dupes=do_dupes, sim=sim)
    caps = tables.caps_from_totals(path, totals)
    lo_d = st.coords(path, lo)
    hi_d = st.coords(path, hi)
    own_d = torch.arange(len(lo), dtype=path.dtype, device=path.device)
    F, _bound, ovf, _ = st._run_path(path, lo_d, hi_d, own_d, caps)
    out_cols = tables._bucket_cap(final)
    wire, total, rovf = st.runs_packed(
        F, lo_d, st.target_seq_grid(tg, device=path.device), out_cols,
        LEN_BITS)
    if bool((ovf | rovf).item()):
        return None  # capacity/packing overflow: caller falls back
    s_lo, s_hi, t_lo, t_hi, rev, own, dupes = tables.decode_runs_packed(
        st.wire_to_host(wire), int(total.item()), lo, out_cols, LEN_BITS)

    def seq_of(p):
        return int(np.searchsorted(tg.seq_start, p, side="right")) - 1

    keep = ~dupes[own]
    ro = [own[keep]]
    rl = [t_lo[keep]]
    rh = [t_hi[keep]]
    rs = [s_lo[keep]]
    rr = [rev[keep].astype(np.uint8)]
    for o in np.flatnonzero(dupes):
        m = own == o
        rows = np.unique(np.stack([s_lo[m], s_hi[m], t_lo[m], t_hi[m],
                                   rev[m]], axis=1), axis=0)
        fr = sm.atomize(sm.Fragments(rows[:, 0], rows[:, 1], rows[:, 2],
                                     rows[:, 3], rows[:, 4].astype(np.uint8)))
        for run in extract_runs(fr, seq_of):
            ro.append(np.array([o], np.int64))
            rl.append(np.array([run[0].tgt_lo], np.int64))
            rh.append(np.array([run[-1].tgt_hi], np.int64))
            rs.append(np.array([min(run[0].src_lo, run[-1].src_lo)], np.int64))
            rr.append(np.array([run[0].rev], np.uint8))
    ro, rl, rh, rs, rr = (np.concatenate(a) for a in (ro, rl, rh, rs, rr))
    o2 = np.lexsort((rl, rs, ro))
    return ro[o2], rl[o2], rh[o2], rs[o2], rr[o2]


def bulk_liftover_bed3(aln: Alignment, src: str, tgt: str, chroms, starts,
                       ends, strands=None, use_device=True, do_dupes=True,
                       out=None, *, device):
    """End-to-end BED3(-6) liftover of a whole batch; returns the output
    text (or writes it to `out`).  Semantics match Liftover.visit_line for
    bed_type <= 6 inputs, and the bytes match the JAX package's
    liftover_bulk.bulk_liftover_bed3."""
    sg = aln.open_genome(src)
    tg = aln.open_genome(tgt)
    seq_idx = np.array([sg.sequence_index(c) for c in chroms], np.int64)
    base = sg.seq_start[seq_idx]
    lo = base + np.asarray(starts, np.int64)
    hi = base + np.asarray(ends, np.int64)
    flip = np.zeros(len(lo), bool)
    dot = np.zeros(len(lo), bool)
    if strands is not None:
        strands = np.asarray(strands)
        flip = strands == "-"
        dot = strands == "."

    runs = (bulk_runs_device(aln, src, tgt, lo, hi, tg, do_dupes=do_dupes,
                             device=device)
            if use_device else None)
    if runs is not None:
        ro, rl, rh, rs, rr = runs
    else:
        frags = bulk_map(aln, src, tgt, lo, hi, do_dupes=do_dupes,
                         use_device=use_device, device=device)
        pos_scale = int(max(tg.length, sg.length) + 2)
        frags = atomize_by_owner(
            *[np.asarray(a, np.int64) if a.dtype != np.uint8 else a
              for a in frags], pos_scale)
        ro, rl, rh, rs, rr = extract_runs_bulk(tg, *frags, pos_scale)

    tsi = np.searchsorted(tg.seq_start, rl, side="right") - 1
    rel_lo = rl - tg.seq_start[tsi]
    rel_hi = rh - tg.seq_start[tsi]
    eff_rev = rr.astype(bool) ^ flip[ro]
    names = tg.seq_names
    if strands is not None:
        lines = ["%s\t%d\t%d\t\t0\t%s\n"
                 % (names[int(tsi[i])], rel_lo[i], rel_hi[i],
                    "." if dot[ro[i]] else ("-" if eff_rev[i] else "+"))
                 for i in range(len(ro))]
    else:
        lines = ["%s\t%d\t%d\n" % (names[int(tsi[i])], rel_lo[i], rel_hi[i])
                 for i in range(len(ro))]
    text = "".join(lines)
    if out is not None:
        out.write(text)
    return text
