"""Share of its roofline reached by the roialign_fc kernel in the traced batches:
the least time of its calls' work (perfbench/roofline.py: each input byte
read once, each output byte written once, operations at the H100's
published peaks) over the device time of the kernels launched inside the
``m3d_torch::roialign_fc``
op's range (the profiler's device time of the op, whatever implements
it). None where the op did not run."""

from perfbench import roofline

OP = "m3d_torch::roialign_fc"
CAPTURE = [("m3d_torch.ops.roialign3d", "roialign_fc")]


def read(run):
    seconds = run.trace.op_device_s.get(OP, 0.0) if run.trace else 0.0
    calls = run.captured.get(f"{CAPTURE[0][0]}.{CAPTURE[0][1]}", [])
    if seconds <= 0 or not calls:
        return None
    least = sum(roofline.bound_s(*roofline.fc_args_work(args)) for args in calls)
    return 100.0 * least / seconds
