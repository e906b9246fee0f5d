"""maf.drain_used_pct: the share of the columns the column engine's drain
copies that hold fragments: the port's counters column.frag_cols (the
programs' totals) over column.drain_cols (their padded out_cols, sized
with 1.25 slack in bucketed steps), summed over the window."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    used = pt.counter(run, "column.frag_cols")
    cols = pt.counter(run, "column.drain_cols")
    if used is None or not cols:
        return None
    return 100.0 * used / cols
