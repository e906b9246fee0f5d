"""lift.map_device_ms: device milliseconds a request takes in kernels, the
profiler's trace summed over the window without its copies and fills
(lift.copy_device_ms reads those); on the liftover cells every kernel is
the segment mapper's (segmap_torch._run_path and its levels)."""

COPIES = ("Memcpy", "Memset")


def read(run):
    if run.device is None:
        return None
    t = sum(e - s for n, s, e in run.device if not n.startswith(COPIES))
    return run.per_request_ms(t)
