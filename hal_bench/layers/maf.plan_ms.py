"""maf.plan_ms: host milliseconds a window spends planning its MAF blocks
in the native assembler, ce_plan_frags: the block machine run over the
window's fragments without text (the port's assembly.plan span, inside
assembly.entry_machine).  A port without the span reads nothing."""

from hal_bench import program_trace as pt

pt.enable()


def read(run):
    return pt.per_request_ms(run, "assembly.plan")
