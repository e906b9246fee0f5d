"""maf.entry_machine_ms: host milliseconds a window spends in the native
MAF entry machine, ce_export_frags, and copying out its text (the port's
assembly.entry_machine span in NativeMafExporter.export_frags)."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "assembly.entry_machine")
