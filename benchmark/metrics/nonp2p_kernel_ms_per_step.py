"""nonp2p_kernel_ms_per_step (device trace): every device interval of the
traced window but the P2P kernel's (far field, step arithmetic, the
boundary's repad and uploads), summed, over the steps traced."""


def read(ctx):
    return ctx.tr["other_ms"] / ctx.tr["steps"]
