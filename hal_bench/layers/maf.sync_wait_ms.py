"""maf.sync_wait_ms: host milliseconds a window waits on the device for
the column programs' overflow flag (the port's column.sync span around
DeviceColumnEngine.window_frags's ovf.item())."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "column.sync")
