"""boundary_wait_frac (program counter): the growth of
``Simulator.rebuild_wait_total`` over the window (the host's waits on
background rebuilds at adoptions), as a share of the window's wall time,
in %."""


def read(ctx):
    return 100.0 * ctx.wait_s / ctx.window_s
