"""maf.redispatch_pct: the share of windows that the column engine
dispatched twice, because the capacities sized on an earlier window of
the same width overflowed and were sized again on the host twin
(DeviceColumnEngine.window_frags calls dispatch_window_packed once a
window, twice on overflow)."""

WRAPS = [("hal_tpu_torch.ops.column_torch",
          "DeviceColumnEngine.dispatch_window_packed")]


def read(run):
    n = sum(1 for name, s, _e in run.spans
            if name == WRAPS[0][1] and run.w0 <= s <= run.w1)
    return 100.0 * (n - run.n_requests) / run.n_requests
