"""maf.device_idle_pct: the share of the traced window in which no
kernel or copy ran on the device."""


def read(run):
    return run.idle_pct()
