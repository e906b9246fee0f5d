"""maf.assemble_ms: host milliseconds a window spends in the native MAF
assembly (column_native.NativeMafExporter.export_frags, the sort into row
precedence and the C++ entry machine, and finish)."""

_M = "hal_tpu_torch.ops.column_native"
WRAPS = [(_M, "NativeMafExporter.export_frags"),
         (_M, "NativeMafExporter.finish")]


def read(run):
    return run.per_request_ms(sum(run.span_s(w[1]) for w in WRAPS))
