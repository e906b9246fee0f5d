"""maf.direct_write_pct: the share of the assembled columns that the
native assembler wrote directly, in blocks that closed inside their
window, against those it left staged in the block still open at the
window's end (the port's counters assembly.direct_cols and
assembly.staged_cols, summed over the window).  A port without these
counters reads nothing."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    direct = pt.counter(run, "assembly.direct_cols")
    staged = pt.counter(run, "assembly.staged_cols")
    if direct is None or staged is None or not direct + staged:
        return None
    return 100.0 * direct / (direct + staged)
