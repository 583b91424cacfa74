"""Host milliseconds per profiled batch that the program's inference call
waits for the card in its own host reads and table copies, all sites
(the ``infer`` span's wait in m3d_torch/trace.py). Read over the profiled
batches (perfbench/program_trace.py); None where the program records
nothing."""

from perfbench import program_trace


def read(run):
    return program_trace.mean(run, lambda c: c["infer"]["wait_ms"])
