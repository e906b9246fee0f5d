"""maf.write_ms: host milliseconds a window spends writing its planned MAF
text, ce_write_frags, and copying it out (the port's assembly.write span,
inside assembly.entry_machine).  A port without the span reads
nothing."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "assembly.write")
