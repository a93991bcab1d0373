"""upward_ms_per_step (program counter): the ``fmm.refresh`` (geometry
refresh) and ``fmm.upward`` (leaf frame, P2M, M2M) stages' sampled device
time (timing events inside the captured step: one replay a window, taken
for each of its steps) over the steps the samples cover, in ms."""

from benchmark import program_spans as S


def read(ctx):
    return S.stage_ms_per_step("fmm.refresh", "fmm.upward")
