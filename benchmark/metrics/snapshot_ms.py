"""snapshot_ms (program span, the harness's host clock around each
``utils/io.write_state`` call): the median over the window's snapshots,
in ms; nothing in a run that writes none."""

import statistics


def read(ctx):
    s = getattr(ctx, "snapshot_s", None)
    return 1e3 * statistics.median(s) if s else None
