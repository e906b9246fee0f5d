"""setup_s: process start to the first timed request's submission: making
the alignment and the requests' pools from the seed, building the port's
objects (path tables, engines, the kernels' and native builds on a
checkout's first run) and warming every shape the window uses."""


def read(run):
    return run.setup_s
