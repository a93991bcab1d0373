"""p2p_roofline_frac (device trace): the least time one H100 could take
for the work the near lists of the traced steps need (``work.py``, frozen
in the benchmark), over the P2P kernel's traced time, in %."""


def read(ctx):
    if not ctx.tr["p2p_count"] or not ctx.p2p_bound_ms:
        return None
    return 100.0 * ctx.p2p_bound_ms / ctx.tr["p2p_ms"]
