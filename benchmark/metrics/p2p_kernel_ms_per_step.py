"""p2p_kernel_ms_per_step (device trace): the summed duration of the P2P
kernel's instances in the traced window, over the steps traced."""


def read(ctx):
    if not ctx.tr["p2p_count"]:
        return None
    return ctx.tr["p2p_ms"] / ctx.tr["steps"]
