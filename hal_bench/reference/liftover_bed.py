"""Plain reference of halLiftover's BED path for BED4-6 input: map each
line's interval (hal_bench.reference.mapper), atomize it per line, merge the
fragments into runs as the reference's BlockMapper::extractSegment does,
and write one BED line per run, sorted by source start.

_Frag, _can_merge_right and extract_runs are a frozen copy of
hal_tpu_torch/ops/liftover.py's (the reference's merge semantics,
liftover/impl/halBlockMapper.cpp:331-391); the line handling follows
Liftover.visit_line / lift_interval for BED6 lines without blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from hal_bench.reference.mapper import canonical, map_intervals


@dataclass
class _Frag:
    tgt_lo: int
    tgt_hi: int
    src_lo: int
    src_hi: int
    rev: bool


def _can_merge_right(a: _Frag, b: _Frag, query_cut: set[int]) -> bool:
    if a.rev != b.rev:
        return False
    if b.tgt_lo != a.tgt_hi:
        return False
    if a.rev:
        if a.src_lo != b.src_hi:
            return False
    else:
        if b.src_lo != a.src_hi:
            return False
    if (a.tgt_hi - 1) in query_cut:
        return False
    return True


def extract_runs(frags, seq_index_of) -> list[list[_Frag]]:
    """BlockMapper::extractSegment over an atomized fragment set.

    `seq_index_of(pos)` maps a target position to its sequence index (runs
    never span target sequences).  Returns runs in set-iteration (target)
    order; each run is the rank-0 chain of its dupe classes."""
    n = len(frags)
    if n == 0:
        return []
    order = np.lexsort((frags.rev, frags.src_hi, frags.src_lo, frags.tgt_hi, frags.tgt_lo))
    fl = [_Frag(int(frags.tgt_lo[i]), int(frags.tgt_hi[i]), int(frags.src_lo[i]),
                int(frags.src_hi[i]), bool(frags.rev[i])) for i in order]
    consumed = [False] * n
    query_cut: set[int] = set()
    runs: list[list[_Frag]] = []

    def cls_at(k: int) -> list[int]:
        """indices (into fl) of the unconsumed class starting at k."""
        out = [k]
        t0 = fl[k].tgt_lo
        j = k + 1
        while j < n:
            if consumed[j]:
                j += 1
                continue
            if fl[j].tgt_lo != t0:
                break
            out.append(j)
            j += 1
        return out

    def next_unconsumed(k: int) -> int:
        while k < n and consumed[k]:
            k += 1
        return k

    for h in range(n):
        if consumed[h]:
            continue
        head_seq = seq_index_of(fl[h].tgt_lo)
        run = [fl[h]]
        v1 = cls_at(h)
        nxt = next_unconsumed(v1[-1] + 1)
        while nxt < n:
            # collect v2: consecutive unconsumed, same target start, <= |v1|
            v2 = []
            j = nxt
            while j < n and len(v2) < len(v1):
                if consumed[j]:
                    j += 1
                    continue
                if v2 and fl[j].tgt_lo != fl[v2[-1]].tgt_lo:
                    break
                v2.append(j)
                j += 1
            if not v2:
                break
            ok = len(v1) == len(v2)
            for a, b in zip(v1, v2) if ok else ():
                if seq_index_of(fl[b].tgt_lo) != head_seq or not _can_merge_right(fl[a], fl[b], query_cut):
                    ok = False
                    break
            if not ok:
                break
            run.append(fl[v2[0]])
            consumed[v2[0]] = True
            v1 = v2
            nxt = next_unconsumed(v2[-1] + 1)
        if len(v1) > 1:
            query_cut.add(run[-1].tgt_hi - 1)
        runs.append(run)
    return runs


@dataclass
class _Frags:
    src_lo: np.ndarray
    src_hi: np.ndarray
    tgt_lo: np.ndarray
    tgt_hi: np.ndarray
    rev: np.ndarray

    def __len__(self) -> int:
        return len(self.src_lo)


def lift_bed(aln, src: str, tgt: str, lines, do_dupes: bool = True) -> str:
    """BED text that halLiftover writes for `lines`: (chrom, start, end,
    name, score, strand) tuples of source genome src, each within its
    sequence, lifted to tgt."""
    sg = aln.open_genome(src)
    tg = aln.open_genome(tgt)
    base = {n: int(sg.seq_start[i]) for i, n in enumerate(sg.seq_names)}
    lo = np.array([base[c] + s for c, s, *_ in lines], np.int64)
    hi = np.array([base[c] + e for c, _s, e, *_ in lines], np.int64)
    scale = max(int(sg.length), int(tg.length)) + 2
    F = canonical(map_intervals(aln, src, tgt, lo, hi, do_dupes), scale)
    starts = np.searchsorted(F[5], np.arange(len(lines)), side="left")
    ends = np.searchsorted(F[5], np.arange(len(lines)), side="right")

    def seq_of(p):
        return int(np.searchsorted(tg.seq_start, p, side="right")) - 1

    out = []
    for k, (_chrom, _s, _e, name, score, strand) in enumerate(lines):
        f = F[:, starts[k]:ends[k]]
        runs = extract_runs(_Frags(*f[:5]), seq_of)
        rows = []
        for run in runs:
            first, last = run[0], run[-1]
            si = seq_of(first.tgt_lo)
            off = int(tg.seq_start[si])
            if strand == ".":
                st = "."
            else:
                st = "-" if (first.rev ^ (strand == "-")) else "+"
            rows.append((min(first.src_lo, last.src_lo),
                         "%s\t%d\t%d\t%s\t%d\t%s\n"
                         % (tg.seq_names[si], first.tgt_lo - off,
                            last.tgt_hi - off, name, score, st)))
        rows.sort(key=lambda r: r[0])
        out.extend(text for _, text in rows)
    return "".join(out)
