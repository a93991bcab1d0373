"""particle_steps_per_s (host clock): N times every step completed in the
measured window, over the window's wall time, which ends in one device
synchronize and holds every boundary wait and snapshot write."""


def read(ctx):
    return ctx.config["n"] * ctx.steps / ctx.window_s
