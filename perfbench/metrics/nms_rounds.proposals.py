"""Fixpoint NMS rounds per profiled batch in the proposal layer (the
``nms.rounds`` counter of the program's ``proposals`` span,
m3d_torch/trace.py): each round is one [B, N, N] product and one host
read. Read over the profiled batches (perfbench/program_trace.py); None
where the program records nothing."""

from perfbench import program_trace


def read(run):
    return program_trace.counter(run, "proposals", "nms.rounds")
