"""maf.engine_ms: host milliseconds a window spends in the device column
engine (column_torch.DeviceColumnEngine.window_frags: sizing and
re-sizing on the host twin, dispatch, the drain, collect_packed and the
post-split), its wait on the device included."""

WRAPS = [("hal_tpu_torch.ops.column_torch", "DeviceColumnEngine.window_frags")]


def read(run):
    return run.per_request_ms(run.span_s("DeviceColumnEngine.window_frags"))
