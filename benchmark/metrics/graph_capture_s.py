"""graph_capture_s (program counter): the growth of
``StepGraph.capture_seconds`` over the whole measured window (the step
graph's captures, warm-ups included), in s."""


def read(ctx):
    return getattr(ctx, "capture_s", None)
