"""maf.collect_ms: host milliseconds a window spends decoding the drained
wire into each program's fragments and adding the reference's identity
rows (the port's column.collect span in DeviceColumnEngine.collect_packed)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "column.collect")
