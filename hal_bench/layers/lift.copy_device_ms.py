"""lift.copy_device_ms: device milliseconds a request takes in copies
between host and device and in fills (the profiler's Memcpy and Memset
activities over the window): the intervals' upload in
BatchMapper.dispatch, the fragments' download in BatchMapper.decode, and
the path tables' upload where a request builds its mapper."""

COPIES = ("Memcpy", "Memset")


def read(run):
    if run.device is None:
        return None
    t = sum(e - s for n, s, e in run.device if n.startswith(COPIES))
    return run.per_request_ms(t)
