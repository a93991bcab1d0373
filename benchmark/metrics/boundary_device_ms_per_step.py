"""boundary_device_ms_per_step (program counter): the stream time from
one recorded run of window steps' end to the next one's start (timing
events the program records before a run's first step and after its last:
the boundary's device work plus the device waiting for the host), summed,
over the steps of the runs those gaps open (``sim.boundary.device``), in
ms."""

from benchmark import program_spans as S


def read(ctx):
    return S.per_count_ms("sim.boundary.device")
