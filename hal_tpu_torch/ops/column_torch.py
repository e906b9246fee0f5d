"""Device column engine on the torch port — hal_tpu.ops.column_jax.

hal2maf's column construction as batched traversal programs: for every
target genome in scope, one program per DFS ordinal (the MAIN canonical
descent and the paralogy-ring branches) maps the whole reference window
through split/hop/ring levels of the segment mapper (ops.segmap_torch),
and every fragment carries a radix-encoded DFS key, so that the MAF rows of
a column sort into the reference ColumnIterator's insertion order: (genome
name, sequence, program ordinal, key).  The original's module docstring
derives the program order and the keys.

The host half is a copy of the original's (numpy only, imports pointing at
hal_tpu_torch): ProgramSpec, ref_chain, build_programs, _St, ColumnHostSim
(the exact host twin that sizes the capacities), _target_frags_host,
slices_from_frags and iter_slices_hostsim.  One declared divergence: the
twin reads its ring CSRs from a tables.RingTables (the original builds its
own _RingCSR), and the engine's levels and split_plan read the same one,
so each genome's CSR is built once a set-up; the twin's outputs stay
equal to the original's.

The device half is torch: build_levels and level_meta, _ring_expand_keyed
(the ring expansion with DFS-key updates), _program_body (one program plus
the compaction of its valid fragments into a static (5, out_cols) wire, the
compaction's prefix sum by the scan kernel), run_program / run_fused /
run_fused_packed, and DeviceColumnEngine.  A window runs every program one
after the other from Python (the JAX package fuses them into one XLA
program); nothing waits between programs, and a packed window drains in
two fetches.  The engine builds each Level once, keyed by its op (kind,
genomes) — a program's levels are the same tables whatever the program.

A window's steps record hal_tpu_torch.tracing spans: column.dispatch
(sizing a new width and launching every program), column.sync (the
overflow flag's read), column.resize (the exact re-sizing after an
overflow), column.drain (the two fetches), column.collect (the
per-program decode and the identity rows) and column.postsplit (the
host cuts at the target grids a program's last level did not already
respect, split_plan); the counters column.frag_cols and
column.drain_cols add up the fragments the programs produced and the
columns the drain copied, column.postsplit_frags and
column.postsplit_skipped the fragments the post-split cut and those whose
cuts the plan left out.

Dtype rule (segmap_torch): the engine picks int32, uint32 or int64 as the
JAX package does, from the scope's genome sizes; uint32 levels run as
int64 tensors.  The DFS key space is checked against the PICKED dtype's
range (2^31, 2^32, 2^62), not the tensor's, so the port refuses exactly
the programs the JAX package refuses (KeySpaceError, a ValueError) and
hal2maf picks the same engine.

Supported flag surface: the default hal2maf configuration plus --noDupes
and --onlyOrthologs; noAncestors and target filtering are output-side
filters.  --unique / --maxRefGap / --global / --printTree take the native
C++ or exact-Python paths instead (tools/hal2maf.py chooses).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from hal_tpu_torch import tracing
from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.ops import tables


# --------------------------------------------------------------- programs

@dataclass
class ProgramSpec:
    """One traversal program for one target genome."""

    target: str
    ordinal: int                  # DFS order among the target's programs
    ops: list = field(default_factory=list)
    # ops entries: ("up", cur, nxt) | ("selfring", cur) | ("down", cur, nxt)

    @property
    def n_levels(self):
        return len(self.ops)


def ref_chain(tree, ref: str, scope_root: str) -> list:
    chain = [ref]
    while chain[-1] != scope_root:
        p = tree.parent(chain[-1])
        if p is None:
            break
        chain.append(p)
    return chain


def build_programs(aln: Alignment, ref: str, scope, scope_root,
                   no_dupes: bool = False, only_orthologs: bool = False):
    """{target -> [ProgramSpec, ...]} in DFS ordinal order per target.

    Mirrors the reference recursion's visit order (see module docstring);
    the MAIN program of the reference genome itself is the empty program
    (the identity row, ordinal 0).

    no_dupes: MAIN only, up-hops canonical-gated ("upc") and down-hops
    without rings ("downnr") — updateParent's canonical check plus the
    suppressed updateNextTopDup.  only_orthologs: branch programs (the
    reference-chain next_top_dup spread) are dropped but destination
    rings on the down path remain — updateChild's ring walk is not gated
    by onlyOrthologs in the recursion."""
    tree = aln.tree
    chain = ref_chain(tree, ref, scope_root)
    cidx = {g: i for i, g in enumerate(chain)}
    upk = "upc" if no_dupes else "up"
    downk = "downnr" if no_dupes else "down"
    out = {}
    for t in sorted(scope):
        m = tree.lca(ref, t)
        u = cidx[m]
        on_chain = t in cidx
        lo_j = cidx[t] if on_chain else u
        progs = []
        if not (no_dupes or only_orthologs):
            for j in range(len(chain) - 2, lo_j - 1, -1):
                ops = [("up", chain[i], chain[i + 1]) for i in range(j)]
                ops.append(("selfring", chain[j]))
                dp = tree.path(chain[j], t)
                ops += [("down", a, b) for a, b in zip(dp, dp[1:])]
                progs.append(ops)
        main = [(upk, chain[i], chain[i + 1]) for i in range(u)]
        dp = tree.path(m, t)
        main += [(downk, a, b) for a, b in zip(dp, dp[1:])]
        if on_chain:
            progs.insert(0, main)
        else:
            progs.append(main)
        out[t] = [ProgramSpec(target=t, ordinal=k, ops=ops)
                  for k, ops in enumerate(progs)]
    return out


# ------------------------------------------------------------- host twin
#
# Exact numpy mirror of the device algebra WITH key tracking: sizes the
# device capacities, serves as the order-oracle in tests, and is itself a
# complete (slow-ish) column engine for CPU-only callers.

@dataclass
class _St:
    """Fragment state: src interval + target interval + orientation + key."""

    s_lo: np.ndarray
    t_lo: np.ndarray
    ln: np.ndarray
    rev: np.ndarray
    key: np.ndarray

    def select(self, m):
        return _St(self.s_lo[m], self.t_lo[m], self.ln[m], self.rev[m],
                   self.key[m])


class ColumnHostSim:
    """Host twin: runs a ProgramSpec over a window, returning fragments
    with DFS keys plus the per-level (split_total, ring_total) sizing.
    self.rings holds the ring CSRs it reads."""

    def __init__(self, aln: Alignment):
        self.aln = aln
        self.tree = aln.tree
        self.rings = tables.RingTables(aln)

    # -- level primitives ------------------------------------------------
    @staticmethod
    def _split(st: _St, starts) -> tuple[_St, np.ndarray, int]:
        """Split fragment targets at the grid; returns (state', seg, total)."""
        t_hi = st.t_lo + st.ln
        i0 = np.searchsorted(starts, st.t_lo, side="right") - 1
        i1 = np.searchsorted(starts, t_hi - 1, side="right") - 1
        counts = np.maximum(i1 - i0 + 1, 0) * (st.ln > 0)
        total = int(counts.sum())
        own = np.repeat(np.arange(len(counts)), counts)
        offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
        seg = i0[own] + (np.arange(total) - offs[own])
        p_lo = np.maximum(st.t_lo[own], starts[seg])
        p_hi = np.minimum(t_hi[own], starts[seg + 1])
        keep = p_hi > p_lo
        own, seg, p_lo, p_hi = own[keep], seg[keep], p_lo[keep], p_hi[keep]
        rev = st.rev[own]
        adv = np.where(rev > 0, t_hi[own] - p_hi, p_lo - st.t_lo[own])
        return (_St(st.s_lo[own] + adv, p_lo, p_hi - p_lo, rev,
                    st.key[own]), seg, total)

    def _hop(self, st: _St, seg, starts, link, lrev, dst_start):
        li = link[seg] if len(link) else np.full(len(seg), NULL_INDEX)
        keep = li != NULL_INDEX
        st, seg, li = st.select(keep), seg[keep], li[keep]
        lr = (lrev[seg] if len(lrev) else np.zeros(len(seg), np.int64))
        off = st.t_lo - starts[seg]
        mirrored = starts[seg + 1] - (st.t_lo + st.ln)
        new_lo = np.where(lr > 0, dst_start[li] + mirrored,
                          dst_start[li] + off)
        return _St(st.s_lo, new_lo, st.ln,
                   st.rev ^ lr.astype(st.rev.dtype), st.key), li

    def _ring_members(self, genome_name, st: _St, seg, radix, member_base):
        """Ring expansion keyed by `seg` (walk order), member keys
        key*radix + (ordinal + member_base)."""
        g = self.aln.open_genome(genome_name)
        csr = self.rings[genome_name]
        rc = csr.rc[seg]
        total = int(rc.sum())
        if total == 0:
            return _St(*(np.zeros(0, np.int64) for _ in range(5))), 0
        own = np.repeat(np.arange(len(rc)), rc)
        offs = np.concatenate([[0], np.cumsum(rc)])[:-1]
        k = np.arange(total) - offs[own]
        midx = csr.rm[csr.ro[seg][own] + k]
        flip = csr.rf[csr.ro[seg][own] + k].astype(np.int64)
        starts = g.top_start
        offm = st.t_lo[own] - starts[seg[own]]
        mln = st.ln[own]
        nlo = np.where(flip > 0, starts[midx + 1] - offm - mln,
                       starts[midx] + offm)
        return _St(st.s_lo[own], nlo, mln,
                   st.rev[own] ^ flip.astype(st.rev.dtype),
                   st.key[own] * radix + (k + member_base)), total

    # -- one program -----------------------------------------------------
    def level_radix(self, op, is_last) -> int:
        kind = op[0]
        if kind in ("up", "upc", "downnr"):
            return 1
        if kind == "selfring":
            mr = self.rings[op[1]].max_ring
            return max(mr, 1)
        mr = self.rings[op[2]].max_ring
        return mr + 2 if mr else 1

    def run(self, spec: ProgramSpec, gs: int, ge: int,
            with_totals: bool = False):
        z = np.zeros(1, np.int64)
        st = _St(z + gs, z + gs, z + (ge - gs), np.zeros(1, np.int64), z.copy())
        totals = []
        ops = spec.ops
        for oi, op in enumerate(ops):
            is_last = oi == len(ops) - 1
            kind = op[0]
            if kind in ("up", "upc"):
                g = self.aln.open_genome(op[1])
                pg = self.aln.open_genome(op[2])
                st, seg, tot = self._split(st, g.top_start)
                totals.append((tot, 0))
                nt = g.num_top_segments
                link = np.asarray(g.top_parent[:nt], np.int64)
                if kind == "upc" and nt:
                    # canonical-only (noDupes): parent's child link must
                    # point back (updateParent's is_canonical gate)
                    slot = self.tree.child_index(op[2], op[1])
                    pi = np.clip(link, 0, max(pg.num_bottom_segments - 1, 0))
                    back = (pg.bot_child[pi, slot]
                            if pg.num_bottom_segments
                            else np.full(nt, NULL_INDEX))
                    canon = (link != NULL_INDEX) & (back == np.arange(nt))
                    link = np.where(canon, link, NULL_INDEX)
                st, _li = self._hop(st, seg, g.top_start, link,
                                    g.top_parent_reversed.astype(np.int64),
                                    pg.bot_start)
            elif kind == "selfring":
                g = self.aln.open_genome(op[1])
                st, seg, tot = self._split(st, g.top_start)
                radix = self.level_radix(op, is_last)
                members, rtot = self._ring_members(op[1], st, seg, radix, 0)
                totals.append((tot, rtot))
                st = members  # base dropped: members only
            else:
                g = self.aln.open_genome(op[1])
                cg = self.aln.open_genome(op[2])
                slot = self.tree.child_index(op[1], op[2])
                st, seg, tot = self._split(st, g.bot_start)
                nb = g.num_bottom_segments
                link = (g.bot_child[:nb, slot] if nb
                        else np.zeros(0, np.int64))
                lrev = (g.bot_child_reversed[:nb, slot].astype(np.int64)
                        if nb else np.zeros(0, np.int64))
                st, li = self._hop(st, seg, g.bot_start, link, lrev,
                                   cg.top_start)
                radix = self.level_radix(op, is_last)
                if radix > 1 and kind == "down":
                    members, rtot = self._ring_members(
                        op[2], st, li, radix, 1 if is_last else 0)
                    canon = radix - 1 if not is_last else 0
                    st = _St(
                        np.concatenate([st.s_lo, members.s_lo]),
                        np.concatenate([st.t_lo, members.t_lo]),
                        np.concatenate([st.ln, members.ln]),
                        np.concatenate([st.rev, members.rev]),
                        np.concatenate([st.key * radix + canon,
                                        members.key]))
                    totals.append((tot, rtot))
                else:
                    totals.append((tot, 0))
        if with_totals:
            return st, totals
        return st

    def key_space(self, spec: ProgramSpec) -> int:
        ks = 1
        for oi, op in enumerate(spec.ops):
            ks *= self.level_radix(op, oi == len(spec.ops) - 1)
        return ks


# ----------------------------------------------------------- assembly

def _target_frags_host(sim: ColumnHostSim, programs, gs: int, ge: int):
    """{target -> [(ordinal, _St), ...]} fragments via the host twin, each
    split at both of the target's segment grids (cut-superset; see module
    docstring)."""
    out = {}
    for t, specs in programs.items():
        g = sim.aln.open_genome(t)
        parts = []
        for spec in specs:
            st = sim.run(spec, gs, ge)
            if g.num_top_segments:
                st, _seg, _tot = sim._split(st, g.top_start)
            if g.num_bottom_segments:
                st, _seg, _tot = sim._split(st, g.bot_start)
            if len(st.s_lo):
                parts.append((spec.ordinal, st))
        out[t] = parts
    return out


def slices_from_frags(aln: Alignment, ref: str, gs: int, ge: int,
                      frags_by_target: dict, no_ancestors: bool = False,
                      targets=None):
    """Yield MAF-ready Slices over [gs, ge) from keyed fragments.

    frags_by_target: {target -> [(ordinal, _St), ...]} (host twin or
    decoded device output).  Rows are ordered (genome, seq, ordinal, key)
    = SequenceLess with DFS insertion order within a sequence; slices come
    out sorted_rows=True so the MafBlockBuilder consumes them as-is."""
    from hal_tpu_torch.ops.column import Row, Slice

    tree = aln.tree
    names = sorted(frags_by_target)
    cuts = {gs, ge}
    for t in names:
        for (_o, st) in frags_by_target[t]:
            cuts.update(st.s_lo.tolist())
            cuts.update((st.s_lo + st.ln).tolist())
    bnd = np.asarray(sorted(c for c in cuts if gs <= c <= ge), np.int64)
    nsl = max(len(bnd) - 1, 0)
    cols = {k: [] for k in ("sl", "gid", "seq", "tlo", "thi", "rev",
                            "ordn", "key")}
    for gid, t in enumerate(names):
        if no_ancestors and not tree.is_leaf(t):
            continue
        if targets and t not in targets and t != ref:
            continue
        gen = aln.open_genome(t)
        for (ordinal, st) in frags_by_target[t]:
            s_hi = st.s_lo + st.ln
            t_hi = st.t_lo + st.ln
            lo_i = np.searchsorted(bnd, st.s_lo, side="left")
            hi_i = np.searchsorted(bnd, s_hi, side="left")
            count = np.maximum(hi_i - lo_i, 0)
            total = int(count.sum())
            if not total:
                continue
            rep = np.repeat(np.arange(len(count)), count)
            offs = np.cumsum(count) - count
            sl = lo_i[rep] + (np.arange(total) - offs[rep])
            a = bnd[sl]
            b = bnd[sl + 1]
            rev = st.rev[rep].astype(bool)
            adv = a - st.s_lo[rep]
            t_hi_r = t_hi[rep] - adv
            t_lo_f = st.t_lo[rep] + adv
            tlo = np.where(rev, t_hi_r - (b - a), t_lo_f)
            thi = np.where(rev, t_hi_r, t_lo_f + (b - a))
            seq = np.searchsorted(gen.seq_start, st.t_lo[rep],
                                  side="right") - 1
            cols["sl"].append(sl)
            cols["gid"].append(np.full(total, gid))
            cols["seq"].append(seq)
            cols["tlo"].append(tlo)
            cols["thi"].append(thi)
            cols["rev"].append(rev)
            cols["ordn"].append(np.full(total, ordinal))
            cols["key"].append(st.key[rep])
    if cols["sl"]:
        sl, gid, seq, tlo, thi = (np.concatenate(cols[k]) for k in
                                  ("sl", "gid", "seq", "tlo", "thi"))
        rev = np.concatenate(cols["rev"])
        ordn, key = (np.concatenate(cols[k]) for k in ("ordn", "key"))
    else:
        sl = gid = seq = tlo = thi = ordn = key = np.zeros(0, np.int64)
        rev = np.zeros(0, bool)
    order = np.lexsort((key, ordn, seq, gid, sl))
    sl, gid, seq, tlo, thi, rev = (x[order] for x in
                                   (sl, gid, seq, tlo, thi, rev))
    starts = np.searchsorted(sl, np.arange(nsl), side="left")
    ends = np.searchsorted(sl, np.arange(nsl), side="right")
    for i in range(nsl):
        a, b = int(bnd[i]), int(bnd[i + 1])
        if b <= a or starts[i] == ends[i]:
            continue
        rows = [Row(names[gid[k]], int(seq[k]), int(tlo[k]), int(thi[k]),
                    bool(rev[k]))
                for k in range(starts[i], ends[i])]
        yield Slice(a, b, rows, sorted_rows=True)


def iter_slices_hostsim(aln: Alignment, ref: str, gs: int, ge: int,
                        scope=None, no_ancestors: bool = False,
                        targets=None, no_dupes: bool = False,
                        only_orthologs: bool = False):
    """Full host-twin column engine: program enumeration + keyed fragment
    runs + slice assembly.  Same output contract as
    column.iter_slices_exact for the supported flag surface."""
    from hal_tpu_torch.ops.column import compute_scope

    if scope is None:
        scope, scope_root = compute_scope(aln, ref)
    else:
        scope_root = min(scope, key=lambda n: aln.tree.depth(n))
    programs = build_programs(aln, ref, scope, scope_root,
                              no_dupes=no_dupes,
                              only_orthologs=only_orthologs)
    sim = ColumnHostSim(aln)
    frags = _target_frags_host(sim, programs, gs, ge)
    yield from slices_from_frags(aln, ref, gs, ge, frags,
                                 no_ancestors=no_ancestors, targets=targets)


# ---------------------------------------------------------- device path

class KeySpaceError(ValueError):
    """A program's DFS key space reaches the coordinate dtype's range."""


# the JAX package's coordinate dtypes and the DFS key range of each
_KMAX = {np.dtype(np.int32): 2 ** 31, np.dtype(np.uint32): 2 ** 32,
         np.dtype(np.int64): 2 ** 62}


def build_level(aln: Alignment, op, dtype, rings: tables.RingTables, *,
                device) -> st.Level:
    """The segmap_torch.Level of one program op, its rings from `rings`."""
    kind = op[0]
    if kind in ("up", "upc"):
        return st.build_up_level(aln, op[1], dtype,
                                 canonical_only=kind == "upc", device=device)
    if kind == "selfring":
        return st.build_selfring_level(aln, op[1], rings, dtype,
                                       device=device)
    return st.build_down_level(aln, op[1], op[2],
                               rings if kind == "down" else None, dtype,
                               device=device)


def build_levels(aln: Alignment, spec: ProgramSpec, dtype,
                 rings: tables.RingTables, *, device, cache: dict):
    """segmap_torch.Level objects for one ProgramSpec.  `cache` maps an op
    to its Level, so each op's Level is built once and shared by every
    program that runs it (the JAX package builds one per program)."""
    levels = []
    for op in spec.ops:
        lv = cache.get(op)
        if lv is None:
            lv = cache[op] = build_level(aln, op, dtype, rings,
                                         device=device)
        levels.append(lv)
    return tuple(levels)


def level_meta(sim: ColumnHostSim, spec: ProgramSpec):
    """Static per-level key metadata: (radix, member_base, canon_choice,
    drop_base) in the device program's consumption order."""
    meta = []
    for oi, op in enumerate(spec.ops):
        is_last = oi == len(spec.ops) - 1
        radix = sim.level_radix(op, is_last)
        if op[0] == "selfring":
            meta.append((radix, 0, 0, True))
        elif op[0] == "down" and radix > 1:
            meta.append((radix, 1 if is_last else 0,
                         0 if is_last else radix - 1, False))
        else:
            meta.append((1, 0, 0, False))
    return tuple(meta)


def _ring_expand_keyed(level: st.Level, F, ring_counts, ring_offsets,
                       cap_out: int, radix: int, member_base: int,
                       canon: int, drop_base: bool):
    """segmap_torch._ring_expand with DFS-key updates: members get
    key*radix + (walk_ordinal + member_base); the pass-through base gets
    key*radix + canon (or is dropped for selfring levels)."""
    dt = F.dtype
    own, offsets, total = st._expand_owner(ring_counts, cap_out)
    off_row = F[st.C_TLO] - F[st.C_AUX]
    ln_row = F[st.C_THI] - F[st.C_TLO]
    G = torch.cat(
        [F[:2], off_row[None, :], ln_row[None, :], F[4:6],
         offsets[None, :].to(dt), ring_offsets[None, :]], dim=0)
    R = G.index_select(1, own.long())
    j = torch.arange(cap_out, dtype=dt, device=F.device)
    k = j - R[6]
    nnz = max(level.ring_mem_tab.shape[1], 1)
    midx = torch.clamp(R[7] + k, 0, nnz - 1)
    MT = level.ring_mem_tab.index_select(1, midx.long())  # [start, next, flip]
    offm = R[2]
    ln = R[3]
    flip = MT[2]
    nlo = torch.where(flip > 0, MT[1] - offm - ln, MT[0] + offm)
    v = j < total.to(dt)
    mkey = R[5] * radix + k + member_base
    F2 = torch.stack(
        [R[0], R[1], nlo, nlo + ln, R[4] ^ flip, mkey, v.to(dt),
         torch.zeros_like(nlo)], dim=0)
    # F is the hop's own new matrix: its key and valid rows change in place
    F[st.C_OWN] = F[st.C_OWN] * radix + canon
    if drop_base:
        F[st.C_VALID] = 0
    return torch.cat([F, F2], dim=1), total, total > cap_out


def _program_body(levels, lo, hi, caps, meta, out_cols: int):
    """One program over the window [lo[0], hi[0]): returns its valid
    fragments [s_lo, t_lo, len, rev, key] compacted into a (5, out_cols)
    matrix, their total and the capacity overflow flag."""
    dt = lo.dtype
    dev = lo.device
    n = lo.shape[0]
    z = torch.zeros(n, dtype=dt, device=dev)
    F = torch.stack([lo, hi, lo, hi, z, z, (hi > lo).to(dt), z], dim=0)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for level, cap, (radix, member_base, canon, drop_base) in zip(
            levels, caps, meta):
        split_cap, ring_cap = cap if isinstance(cap, tuple) else (cap, cap)
        F, rc, ro, _stot, ov1 = st._split_hop(level, F, split_cap)
        overflow = overflow | ov1
        if level.max_ring > 0 and radix > 1:
            F, _rt, ov2 = _ring_expand_keyed(level, F, rc, ro, ring_cap,
                                             radix, member_base, canon,
                                             drop_base)
            overflow = overflow | ov2
        elif drop_base:
            # selfring in a genome with no paralogy: nothing survives
            F[st.C_VALID] = 0
    # compact [s_lo, t_lo, len, rev, key] into a static (5, out_cols)
    idx, total = st._compact_slots(F, out_cols)
    rows = torch.stack([F[st.C_SLO], F[st.C_TLO],
                        F[st.C_SHI] - F[st.C_SLO], F[st.C_REV],
                        F[st.C_OWN]], dim=0)
    return (st._scatter_cols(rows, idx, out_cols), total,
            overflow | (total > out_cols))


# the JAX package's jit entry of one program; torch runs it eagerly
run_program = _program_body


def run_fused(levels_all, lo, hi, caps_all, meta_all, out_cols_all):
    """Every program of a window, launched one after the other."""
    return tuple(_program_body(levels, lo, hi, caps, meta, oc)
                 for levels, caps, meta, oc in zip(
                     levels_all, caps_all, meta_all, out_cols_all))


def run_fused_packed(levels_all, lo, hi, caps_all, meta_all, out_cols_all):
    """run_fused with all outputs concatenated into ONE wire buffer, so a
    window drains in 2 fetches instead of 2 per program."""
    outs = run_fused(levels_all, lo, hi, caps_all, meta_all, out_cols_all)
    dev = lo.device
    big = (torch.cat([o for (o, _t, _v) in outs], dim=1) if outs
           else torch.zeros((5, 0), dtype=lo.dtype, device=dev))
    tots = (torch.stack([t for (_o, t, _v) in outs]) if outs
            else torch.zeros(0, dtype=torch.int32, device=dev))
    ovf = (torch.stack([v for (_o, _t, v) in outs]).any() if outs
           else torch.zeros((), dtype=torch.bool, device=dev))
    return big, tots, ovf


def _identity(gs: int, ge: int) -> _St:
    """The reference genome's identity fragment over [gs, ge)."""
    z = np.zeros(1, np.int64)
    return _St(z + gs, z + gs, z + (ge - gs), np.zeros(1, np.int64), z.copy())


def split_plan(aln: Alignment, sim: ColumnHostSim, programs,
               cache: dict) -> dict:
    """{(target, ordinal) -> grids}: the target's segment grids
    ("top_start", "bot_start", in that order) that the cut-superset
    post-split cuts a program's fragments at.

    A grid the target lacks is left out, as is the grid the program's last
    level lands on (the top grid after down, downnr and selfring, the
    bottom grid after up and upc) where that level leaves every fragment
    inside one of its segments: a fragment is cut at the source grid
    before it hops, so that holds when every link the level can follow
    joins two segments of equal length and every ring member it can emit
    has its source's length, and then the cut changes nothing.  The
    identity program (no ops) keeps both grids.  `cache` maps a last op
    to that check's result; the checks' passes over the genomes' arrays
    run on a thread pool (numpy releases the GIL in them)."""
    def landed(op):
        return "bot_start" if op[0] in ("up", "upc") else "top_start"

    have = {}
    for t in programs:
        g = aln.open_genome(t)
        have[t] = tuple(grid for grid, n in (
            ("top_start", g.num_top_segments),
            ("bot_start", g.num_bottom_segments)) if n)
    ops = sorted({s.ops[-1] for t, specs in programs.items() for s in specs
                  if s.ops and s.ops[-1][-1] == t
                  and landed(s.ops[-1]) in have[t]} - cache.keys())
    # per op: the (genome, grid) pairs its links join, and the genome
    # whose ring members it emits
    links, rings = {}, {}
    for op in ops:
        kind, cur, nxt = op[0], op[1], op[-1]
        g = aln.open_genome(cur)
        if kind in ("up", "upc"):
            links[op] = ((cur, "top_start"), g.top_parent[:g.num_top_segments],
                         (nxt, "bot_start"))
        elif kind == "selfring":
            rings[op] = cur
        else:
            nb = g.num_bottom_segments
            link = (g.bot_child[:nb, aln.tree.child_index(cur, nxt)] if nb
                    else np.zeros(0, np.int64))
            links[op] = ((cur, "bot_start"), link, (nxt, "top_start"))
            if kind == "down":
                rings[op] = nxt
    csrs = {n: sim.rings[n] for n in rings.values()}
    starts = {k: getattr(aln.open_genome(k[0]), k[1]) for k in
              {k for src, _l, dst in links.values() for k in (src, dst)}
              | {(n, "top_start") for n in rings.values()}}

    def check(op):
        if op in links:
            src, link, dst = links[op]
            # a NULL link (-1) reads the last length; only linked rows count
            bad = np.flatnonzero(lens[dst][link] != lens[src])
            if not (link[bad] == NULL_INDEX).all():
                return False
        if op in rings:
            # the CSR lists the members source by source, in source order
            csr, ln = csrs[rings[op]], lens[rings[op], "top_start"]
            return np.array_equal(ln[csr.rm], np.repeat(ln, csr.rc))
        return True

    with ThreadPoolExecutor() as ex:
        lens = dict(zip(starts, ex.map(np.diff, starts.values())))
        cache.update(zip(ops, ex.map(check, ops)))
    plan = {}
    for t, specs in programs.items():
        for s in specs:
            op = s.ops[-1] if s.ops else None
            done = landed(op) if op and op[-1] == t and cache.get(op) else None
            plan[t, s.ordinal] = tuple(x for x in have[t] if x != done)
    return plan


class DeviceColumnEngine:
    """Column construction on the device for a reference genome's windows.

    One traversal program per (target, DFS-ordinal); capacities are sized
    by the host twin on the first window of each width and reused (with
    overflow-triggered exact re-sizing) for subsequent equal-width
    windows, so steady-state windows are dispatch + one drain each.

    window_frags(gs, ge) returns {target: [(ordinal, _St), ...]} decoded
    from the device; window_slices(gs, ge) assembles MAF-ready Slices
    (byte-equal to column.iter_slices_exact through MafBlockBuilder).
    Raises KeySpaceError (a ValueError) at construction when a program's
    DFS key space reaches the picked dtype's range (callers fall back to
    the native / Python engines)."""

    def __init__(self, aln: Alignment, ref: str, scope=None, targets=None,
                 no_ancestors: bool = False, no_dupes: bool = False,
                 only_orthologs: bool = False, dtype=None, *, device):
        from hal_tpu_torch.ops.column import compute_scope

        self.aln = aln
        self.ref = ref
        self.device = torch.device(device)
        if scope is None:
            scope, scope_root = compute_scope(aln, ref)
        else:
            scope_root = min(scope, key=lambda n: aln.tree.depth(n))
        self.scope, self.scope_root = scope, scope_root
        self.targets = targets
        self.no_ancestors = no_ancestors
        self.sim = ColumnHostSim(aln)
        self.programs = build_programs(aln, ref, scope, scope_root,
                                       no_dupes=no_dupes,
                                       only_orthologs=only_orthologs)
        if dtype is None:
            mx = 0
            for n in scope:
                g = aln.open_genome(n)
                mx = max(mx, g.length, g.num_top_segments,
                         g.num_bottom_segments)
            dtype = (np.int32 if mx < 2 ** 31 - 2 else
                     np.uint32 if mx < 2 ** 32 - 2 else np.int64)
        self.dtype = np.dtype(dtype)
        kmax = _KMAX[self.dtype]
        self.coord_dtype = (torch.int32 if self.dtype == np.int32
                            else torch.int64)
        self.levels: dict = {}  # op -> Level, shared by the programs
        self.jobs = []  # (target, spec, levels, meta) — device programs
        for t in sorted(self.programs):
            for spec in self.programs[t]:
                if not spec.ops:
                    continue  # identity (ref main) — host-side row
                ks = self.sim.key_space(spec)
                if ks >= kmax:
                    raise KeySpaceError(
                        "DFS key space %d exceeds %s for %s program %d"
                        % (ks, self.dtype.name, t, spec.ordinal))
                self.jobs.append((t, spec,
                                  build_levels(aln, spec, self.dtype,
                                               self.sim.rings,
                                               device=self.device,
                                               cache=self.levels),
                                  level_meta(self.sim, spec)))
        self.lands_inside: dict = {}  # last op -> split_plan's check
        self.plan = split_plan(aln, self.sim, self.programs,
                               cache=self.lands_inside)
        self._caps: dict = {}   # (job_idx, width) -> (caps, out_cols)

    # -- sizing ---------------------------------------------------------
    def _size(self, job_idx: int, gs: int, ge: int, slack: float = 1.25):
        t, spec, _levels, meta = self.jobs[job_idx]
        st_, totals = self.sim.run(spec, gs, ge, with_totals=True)
        caps = []
        for (tot, rtot), (radix, _mb, _c, _db) in zip(totals, meta):
            c = tables._bucket_cap(max(int(tot * slack), 16))
            if rtot or radix > 1:
                caps.append((c, tables._bucket_cap(max(int(rtot * slack),
                                                       16))))
            else:
                caps.append(c)
        out_cols = tables._bucket_cap(max(int(len(st_.s_lo) * slack), 16))
        return tuple(caps), out_cols

    def _window(self, gs: int, ge: int):
        lo = torch.tensor([gs], dtype=self.coord_dtype, device=self.device)
        hi = torch.tensor([ge], dtype=self.coord_dtype, device=self.device)
        for ji in range(len(self.jobs)):
            key = (ji, ge - gs)
            if key not in self._caps:
                self._caps[key] = self._size(ji, gs, ge)
        return lo, hi

    def _with_identity(self, out: dict, gs: int, ge: int) -> dict:
        # the reference genome's identity program (empty op list)
        for spec in self.programs.get(self.ref, []):
            if not spec.ops:
                out[self.ref].append((spec.ordinal, _identity(gs, ge)))
        for t in out:
            out[t].sort(key=lambda p: p[0])
        return out

    def dispatch_window_packed(self, gs: int, ge: int):
        """One-wire dispatch: returns (big (5, sum_oc), tots (n_jobs,),
        ovf scalar) device values and the per-job out_cols — 2 fetches
        drain a whole window."""
        with tracing.span("column.dispatch"):
            lo, hi = self._window(gs, ge)
            caps_all = tuple(self._caps[(ji, ge - gs)][0]
                             for ji in range(len(self.jobs)))
            oc_all = tuple(self._caps[(ji, ge - gs)][1]
                           for ji in range(len(self.jobs)))
            big, tots, ovf = run_fused_packed(
                tuple(j[2] for j in self.jobs), lo, hi, caps_all,
                tuple(j[3] for j in self.jobs), oc_all)
        return big, tots, ovf, oc_all

    def collect_packed(self, big_np, tots_np, oc_all, gs: int, ge: int):
        """Host decode of a packed window (numpy inputs): the caller
        fetched `big` and `tots` (and checked ovf — an overflow means the
        caps cache needs the exact re-size path)."""
        with tracing.span("column.collect"):
            out: dict = {t: [] for t in self.programs}
            off = 0
            for ji, oc in enumerate(oc_all):
                t, spec, _levels, _meta = self.jobs[ji]
                k = int(tots_np[ji])
                M = big_np[:, off:off + k].astype(np.int64)
                off += oc
                out[t].append((spec.ordinal,
                               _St(M[0], M[1], M[2], M[3], M[4])))
            out = self._with_identity(out, gs, ge)
        return self._postsplit(out)

    def _overflowed(self, ovf) -> bool:
        with tracing.span("column.sync"):
            return bool(ovf.item())

    def window_frags(self, gs: int, ge: int) -> dict:
        """Keyed fragments for a window via the PACKED one-wire dispatch
        (2 host fetches per window).  An overflowing window re-sizes
        exactly and re-dispatches once."""
        big, tots, ovf, oc_all = self.dispatch_window_packed(gs, ge)
        if self._overflowed(ovf):
            with tracing.span("column.resize"):
                for ji in range(len(self.jobs)):
                    self._caps[(ji, ge - gs)] = self._size(ji, gs, ge,
                                                           slack=1.0)
            big, tots, ovf, oc_all = self.dispatch_window_packed(gs, ge)
            if self._overflowed(ovf):
                raise RuntimeError("column window overflow under exact host "
                                   "sizing")
        with tracing.span("column.drain"):
            big_np, tots_np = big.cpu().numpy(), tots.cpu().numpy()
        if tracing.on:
            tracing.count("column.frag_cols", int(tots_np.sum()))
            tracing.count("column.drain_cols", sum(oc_all))
        return self.collect_packed(big_np, tots_np, oc_all, gs, ge)

    def _postsplit(self, frags: dict) -> dict:
        # cut-superset: cut each program's fragments at the grids of its
        # target that its last level did not already respect (self.plan)
        cut = kept = 0
        with tracing.span("column.postsplit"):
            for t, parts in frags.items():
                g = self.aln.open_genome(t)
                split = []
                for (o, st_) in parts:
                    grids = self.plan[t, o]
                    if grids:
                        cut += len(st_.s_lo)
                    else:
                        kept += len(st_.s_lo)
                    for grid in grids:
                        st_, _s, _t2 = self.sim._split(st_, getattr(g, grid))
                    if len(st_.s_lo):
                        split.append((o, st_))
                frags[t] = split
        if tracing.on:
            tracing.count("column.postsplit_frags", cut)
            tracing.count("column.postsplit_skipped", kept)
        return frags

    def window_slices(self, gs: int, ge: int):
        yield from slices_from_frags(
            self.aln, self.ref, gs, ge, self.window_frags(gs, ge),
            no_ancestors=self.no_ancestors, targets=self.targets)

    def export_native(self, exporter, gs: int, ge: int) -> bytes:
        """MAF bytes for [gs, ge): device fragments -> native C++
        assembler (column_native.NativeMafExporter.export_frags)."""
        return exporter.export_frags(
            gs, ge, self.window_frags(gs, ge),
            no_ancestors=self.no_ancestors, targets=self.targets)


# ------------------------------------------------------- multichip step

def size_sharded_caps(eng: DeviceColumnEngine, edges):
    """Elementwise-max capacities across window shards (one exact host
    sizing per shard, so one set of capacities serves every shard)."""
    caps_all, oc_all = [], []
    for ji in range(len(eng.jobs)):
        caps_m = None
        oc_m = 0
        for k in range(len(edges) - 1):
            caps, oc = eng._size(ji, int(edges[k]), int(edges[k + 1]))
            if caps_m is None:
                caps_m = list(caps)
            else:
                caps_m = [tuple(max(a, b) for a, b in zip(c1, c2))
                          if isinstance(c1, tuple) else max(c1, c2)
                          for c1, c2 in zip(caps_m, caps)]
            oc_m = max(oc_m, oc)
        caps_all.append(tuple(caps_m))
        oc_all.append(oc_m)
    return tuple(caps_all), tuple(oc_all)


def make_sharded_column_step(eng: DeviceColumnEngine, caps_all, oc_all, mesh):
    """Column step with the reference window sharded over the mesh's data
    axis (a parallel.mesh.Mesh): each data shard runs EVERY column program
    on its sub-window with the engine's level tables (the hal2mafMP.py
    coordinate-slicing pattern).  Sub-window edges are cut points, so the
    shards' fragments concatenate into the global column structure
    (slices never span shards).

    Returns step(lo, hi) -> tuple per job of (out (n_local_data, 5,
    out_cols), total (n_local_data,), overflow (n_local_data,)): lo and hi
    hold one sub-window edge per local data shard."""
    jobs = eng.jobs

    def step(lo, hi):
        outs = [([], [], []) for _ in jobs]
        for lo_i, hi_i in zip(mesh.split(lo.to(eng.coord_dtype)),
                              mesh.split(hi.to(eng.coord_dtype))):
            for (_t, _spec, levels, meta), caps, oc, acc in zip(
                    jobs, caps_all, oc_all, outs):
                for a, x in zip(acc, _program_body(levels, lo_i, hi_i, caps,
                                                   meta, oc)):
                    a.append(x)
        return tuple((torch.stack(o), torch.stack(t), torch.stack(v))
                     for o, t, v in outs)

    return step


def collect_sharded(eng: DeviceColumnEngine, outs, edges):
    """Decode a sharded column step's outputs (every data shard's, in data
    order) into the engine's {target: [(ordinal, _St)]} form: fragments
    concatenated across shards; per-slice row order is unaffected because
    no slice spans a shard boundary."""
    out: dict = {t: [] for t in eng.programs}
    for ji, (o, tot, ovf) in enumerate(outs):
        t, spec, _levels, _meta = eng.jobs[ji]
        if bool(ovf.any().item()):
            raise RuntimeError("sharded column overflow")
        O = o.cpu().numpy()
        T = tot.cpu().numpy()
        M = np.concatenate([O[d, :, :int(T[d])].astype(np.int64)
                            for d in range(O.shape[0])], axis=1)
        out[t].append((spec.ordinal, _St(M[0], M[1], M[2], M[3], M[4])))
    return eng._postsplit(eng._with_identity(out, int(edges[0]),
                                             int(edges[-1])))
