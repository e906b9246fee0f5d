"""maf.drain_ms: host milliseconds a window spends copying the packed
wire and the programs' totals to the host (the port's column.drain span:
big.cpu() and tots.cpu() in DeviceColumnEngine.window_frags)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "column.drain")
