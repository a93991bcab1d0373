"""host_rebuild_s (program counter): the mean of
``sum(KdFmmEngine.last_build_times)`` over the full re-sorts adopted in
the window, sampled right after each adoption; nothing when none was."""


def read(ctx):
    s = ctx.full_build_s
    return sum(s) / len(s) if s else None
