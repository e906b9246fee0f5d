"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W
power limit) and the bytes each hand kernel of the port needs for a call,
counted from its shapes: every input read once, every output written once,
whatever the kernel reads again.  The count is of the work, so a kernel
that replaces one of these is read on the same yardstick.  (The same
arithmetic as chip_smoke.py's kernel table.)"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def searchsorted_bytes(grid, q, tables=None) -> int:
    """searchsorted_right / searchsorted_right_u32: the grid and the queries
    read, one result of the query's type written.  The search tables are a
    layout of the grid and are not counted again."""
    return _nbytes(grid) + 2 * _nbytes(q)


def scan_bytes(x) -> int:
    """cumsum_i32 / cummax_i32: x read, the scan written."""
    return 2 * _nbytes(x)
