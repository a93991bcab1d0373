"""near_entries_per_row (program counter): the near-field (P2P) entries
of the list builds in the traced tail over their sub-leaf rows, each
summed over the builds (``kd.lists.near_entries`` over
``kd.lists.near_rows``): the stale margin's cost to the P2P kernel and to
the host's list build.  Nothing where no build recorded them (a program
without the counters)."""

from benchmark import program_spans as S


def read(ctx):
    tot = S.totals() or {}
    rows = tot.get("kd.lists.near_rows", {}).get("count", 0)
    if not rows:
        return None
    return tot["kd.lists.near_entries"]["count"] / rows
