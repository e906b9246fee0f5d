"""maf.dispatch_ms: host milliseconds a window spends dispatching the
column engine's programs (the port's column.dispatch span, inside
DeviceColumnEngine.dispatch_window_packed: the window's capacities and the
eager launch of every program, run_fused_packed)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "column.dispatch")
