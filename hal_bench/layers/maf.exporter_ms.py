"""maf.exporter_ms: host milliseconds a window spends building and
freeing its native MAF exporter (the port's assembly.init span,
NativeMafExporter.__init__ with one ce_add_genome a genome, and
assembly.close, the handle's ce_free)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "assembly.init", "assembly.close")
