"""maf.postsplit_ms: host milliseconds a window spends cutting every
target's fragments at its own segment grids (the port's column.postsplit
span, DeviceColumnEngine._postsplit)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "column.postsplit")
