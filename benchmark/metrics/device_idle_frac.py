"""device_idle_frac (device trace): 1 - the union of the device's
intervals (kernels, copies, memsets) over the traced window's length, in
%."""


def read(ctx):
    tr = ctx.tr
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
