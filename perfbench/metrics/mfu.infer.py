"""The whole step's share of the H100's bf16 peak (989 TFLOP/s) over the
window: 2 x the multiply-adds of every convolution and matrix product of
the forward at the configuration's shapes (perfbench/roofline.py
``step_flops``), with the per-ROI heads counted at the rows the inputs make
live (valid proposals for the classifier, valid detections for the mask
head), whichever graph ran; over the window's seconds."""

from perfbench.roofline import BF16_FLOPS, step_flops


def read(run):
    if run.window_s <= 0 or not run.live:
        return None
    f = step_flops(run.config)
    ops = sum(run.batch * f["image"]
              + live["classifier_rows"] * f["classifier_row"]
              + live["mask_rows"] * f["mask_row"] for live in run.live)
    return 100.0 * ops / (run.window_s * BF16_FLOPS)
