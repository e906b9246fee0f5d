"""maf.launch_us: host microseconds of the column engine's dispatch a
device kernel: the port's column.dispatch span over the window's device
kernels (the profiler's activities other than Memcpy and Memset; the
programs launch nearly all of them).  None without a device trace."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    s = pt.span_s(run, "column.dispatch")
    n = pt.device_kernels(run)
    if s is None or not n:
        return None
    return 1e6 * s / n
