"""Share of the mask head's rows that hold a live ROI: 100 x the
``rows.live`` counter of the program's ``mask`` span over its
``rows.computed`` (m3d_torch/trace.py; adaptive: the live count over the
launched chunks' rows, monolithic: the valid slots over every padded
slot). Read over the profiled batches (perfbench/program_trace.py); None
where the program records nothing."""

from perfbench import program_trace


def read(run):
    return program_trace.rows_useful_pct(run, "mask")
