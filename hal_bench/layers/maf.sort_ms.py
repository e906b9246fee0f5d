"""maf.sort_ms: host milliseconds a window spends sorting the rows
into MAF row precedence (np.lexsort and the reorder) and finding the cuts
(np.unique) (the port's assembly.sort span in
NativeMafExporter.export_frags)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "assembly.sort")
