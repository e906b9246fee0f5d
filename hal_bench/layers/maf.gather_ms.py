"""maf.gather_ms: host milliseconds a window spends gathering the
fragments' rows by target, with each row's sequence by np.searchsorted,
and concatenating them (the port's assembly.gather span in
NativeMafExporter.export_frags)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "assembly.gather")
