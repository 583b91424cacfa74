"""Host milliseconds per profiled batch inside the program's own
``mask`` spans (m3d_torch/trace.py), less the host's waits in their
reads and table copies: how long the host takes to issue the stage.
Read over the traced run's profiled batches (perfbench/program_trace.py),
whose host time the profiler lengthens: it is not comparable with
``stage_ms.mask``, which is the unprofiled window's device time. None
where the program records nothing."""

from perfbench import program_trace


def read(run):
    return program_trace.stage_host_ms(run, "mask")
