"""Port copy of hal_tpu/analysis/intervals.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

Vectorized genomic-interval algebra (native replacement for the BedTools
calls in reference analysis/neutralIndel/turnoverRate.py:52-69 — sortBed,
mergeBed, intersectBed, subtractBed and `cat|sortBed|mergeBed` union).

An IntervalSet is a mapping sequence-name -> (N,2) int64 array of sorted,
merged half-open [start,end) intervals.  All set operations are O(n log n)
numpy; no per-interval Python loops.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IntervalSet", "merge_intervals"]


def merge_intervals(iv: np.ndarray) -> np.ndarray:
    """Sort and merge overlapping/adjacent [start,end) rows (mergeBed)."""
    iv = np.asarray(iv, dtype=np.int64).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    order = np.lexsort((iv[:, 1], iv[:, 0]))
    iv = iv[order]
    # running max of ends; a new run starts where start > max(prev ends)
    run_end = np.maximum.accumulate(iv[:, 1])
    new_run = np.empty(len(iv), dtype=bool)
    new_run[0] = True
    new_run[1:] = iv[1:, 0] > run_end[:-1]
    starts = iv[new_run, 0]
    ends = np.maximum.reduceat(iv[:, 1], np.flatnonzero(new_run))
    return np.stack([starts, ends], axis=1)


def _intersect_merged(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two merged interval arrays."""
    if len(a) == 0 or len(b) == 0:
        return np.empty((0, 2), dtype=np.int64)
    # for every a-row, the b-rows it can overlap form a contiguous range
    lo = np.searchsorted(b[:, 1], a[:, 0], side="right")
    hi = np.searchsorted(b[:, 0], a[:, 1], side="left")
    counts = hi - lo
    tot = int(counts.sum())
    if tot == 0:
        return np.empty((0, 2), dtype=np.int64)
    a_idx = np.repeat(np.arange(len(a)), counts)
    offs = np.arange(tot) - np.repeat(np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(lo, counts) + offs
    s = np.maximum(a[a_idx, 0], b[b_idx, 0])
    e = np.minimum(a[a_idx, 1], b[b_idx, 1])
    keep = e > s
    return np.stack([s[keep], e[keep]], axis=1)


def _subtract_merged(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a minus b, both merged (subtractBed)."""
    if len(a) == 0:
        return np.empty((0, 2), dtype=np.int64)
    if len(b) == 0:
        return a.copy()
    # complement of b within each a interval = a ∩ complement(b)
    # complement(b) over (-inf, +inf): gaps between b rows
    comp_s = np.concatenate(([np.iinfo(np.int64).min], b[:, 1]))
    comp_e = np.concatenate((b[:, 0], [np.iinfo(np.int64).max]))
    comp = np.stack([comp_s, comp_e], axis=1)
    comp = comp[comp[:, 1] > comp[:, 0]]
    return _intersect_merged(a, comp)


class IntervalSet:
    """Per-sequence merged interval sets with BED I/O."""

    def __init__(self, data: dict[str, np.ndarray] | None = None):
        self.data: dict[str, np.ndarray] = {}
        if data:
            for k, v in data.items():
                v = np.asarray(v, dtype=np.int64).reshape(-1, 2)
                if len(v):
                    self.data[k] = merge_intervals(v)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_bed(cls, stream) -> "IntervalSet":
        if isinstance(stream, str):
            with open(stream) as f:
                return cls.from_bed(f)
        raw: dict[str, list] = {}
        for line in stream:
            line = line.strip()
            if not line or line[0] == "#" or line.startswith(("track", "browser")):
                continue
            t = line.split()
            if len(t) < 3:
                continue
            raw.setdefault(t[0], []).append((int(t[1]), int(t[2])))
        return cls({k: np.array(v) for k, v in raw.items()})

    @classmethod
    def from_rows(cls, names, starts, ends) -> "IntervalSet":
        raw: dict[str, list] = {}
        for n, s, e in zip(names, starts, ends):
            raw.setdefault(n, []).append((int(s), int(e)))
        return cls({k: np.array(v) for k, v in raw.items()})

    # -- algebra -----------------------------------------------------------
    def _binary(self, other: "IntervalSet", fn) -> "IntervalSet":
        out = IntervalSet()
        for k in self.data:
            r = fn(self.data[k], other.data.get(k, np.empty((0, 2), dtype=np.int64)))
            if len(r):
                out.data[k] = r
        return out

    def intersect(self, other: "IntervalSet") -> "IntervalSet":
        return self._binary(other, _intersect_merged)

    def subtract(self, other: "IntervalSet") -> "IntervalSet":
        return self._binary(other, _subtract_merged)

    def union(self, other: "IntervalSet") -> "IntervalSet":
        out = IntervalSet()
        for k in set(self.data) | set(other.data):
            rows = [x for x in (self.data.get(k), other.data.get(k)) if x is not None]
            out.data[k] = merge_intervals(np.concatenate(rows))
        return out

    def total_length(self) -> int:
        return int(sum((v[:, 1] - v[:, 0]).sum() for v in self.data.values()))

    def is_empty(self) -> bool:
        return self.total_length() == 0

    def overlap_counts(self, names, starts, ends) -> np.ndarray:
        """For each query row, the number of set intervals it overlaps
        (intersectBed -a query -b set -wa emits one copy per pair,
        analysis/neutralIndel/backgroundRate.py:41-44)."""
        out = np.zeros(len(names), dtype=np.int64)
        for k, sub in _group_rows(names, starts, ends).items():
            b = self.data.get(k)
            if b is None:
                continue
            idx, s, e = sub
            lo = np.searchsorted(b[:, 1], s, side="right")
            hi = np.searchsorted(b[:, 0], e, side="left")
            out[idx] = hi - lo
        return out

    # -- I/O -----------------------------------------------------------------
    def write_bed(self, stream) -> None:
        if isinstance(stream, str):
            with open(stream, "w") as f:
                self.write_bed(f)
            return
        for k in sorted(self.data):
            for s, e in self.data[k]:
                stream.write("%s\t%d\t%d\n" % (k, s, e))


def _group_rows(names, starts, ends):
    groups: dict[str, list] = {}
    for i, n in enumerate(names):
        groups.setdefault(n, []).append(i)
    out = {}
    for n, idx in groups.items():
        idx = np.asarray(idx)
        out[n] = (idx, np.asarray(starts, dtype=np.int64)[idx],
                  np.asarray(ends, dtype=np.int64)[idx])
    return out
