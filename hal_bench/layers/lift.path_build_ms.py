"""lift.path_build_ms: host milliseconds a request spends building the
segment mapper (segmap_torch.BatchMapper.__init__: PathData.build, the
levels' tables, ring CSRs, page and search tables, their copies to the
device).  Liftover.convert_batched builds one in every call."""

WRAPS = [("hal_tpu_torch.ops.segmap_torch", "BatchMapper.__init__")]


def read(run):
    return run.per_request_ms(run.span_s("BatchMapper.__init__"))
