"""intervals_per_s: BED intervals of the requests completed in the window,
over the window's seconds (all the work and all the time)."""


def read(run):
    return run.units / run.window_s
