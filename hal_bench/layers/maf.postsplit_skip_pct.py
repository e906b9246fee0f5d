"""maf.postsplit_skip_pct: the share of the fragments the column engine's
post-split receives that it leaves uncut, because each program's last
level already respects the target's grids (the port's counters
column.postsplit_skipped over it plus column.postsplit_frags, summed over
the window).  A port without these counters reads nothing."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    skipped = pt.counter(run, "column.postsplit_skipped")
    cut = pt.counter(run, "column.postsplit_frags")
    if skipped is None or cut is None or not skipped + cut:
        return None
    return 100.0 * skipped / (skipped + cut)
