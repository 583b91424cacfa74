"""Per-epoch device profiling hook (port of m3d/train/profiling.py).

With ``PROFILE_DIR`` set, one steady-state epoch is traced with
``torch.profiler`` (CPU and, on a card, CUDA activities) and written as a
Chrome trace into PROFILE_DIR. The first epoch after FROM_EPOCH is skipped,
since it holds the first calls' set-up, and the second is traced, with the
program's spans (m3d_torch/trace.py) on, so the trace names its stages
(``m3d.<span>`` ranges); their records are dropped.
``StepClock`` times each training step and the host time to take its batch.
"""

from __future__ import annotations

import os
import time

import torch

from m3d_torch import trace


class EpochProfiler:
    def __init__(self, config):
        self.dir = getattr(config, "PROFILE_DIR", None) or None
        self.target = int(getattr(config, "FROM_EPOCH", 0)) + 1
        self.prof = None

    def maybe_start(self, epoch: int):
        if self.dir and epoch == self.target and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            trace.enable()

    def maybe_stop(self, epoch: int):
        if self.prof is not None and epoch == self.target:
            trace.disable()
            trace.take()
            self.prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"epoch_{epoch}.trace.json")
            self.prof.export_chrome_trace(path)
            self.prof = None
            print(f"[EpochProfiler] epoch {epoch} trace -> {path}")


class StepClock:
    """Per training step: host milliseconds to take the batch from the
    prefetch queue (the assembly and the start of the copy of the batch
    that refills it included), the step's milliseconds, by CUDA events on a card
    (host clock on the CPU), and its loss. ``records`` holds one dict per
    step."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.records: list[dict] = []
        self._host_ms = 0.0

    def take(self, it):
        t = time.perf_counter()
        batch = next(it)
        self._host_ms = (time.perf_counter() - t) * 1e3
        return batch

    def run(self, fn, *args):
        """``fn(*args)``, timed; fn must end in a host read of its result,
        a metrics dict with a "loss"."""
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t = time.perf_counter()
            out = fn(*args)
            ms = (time.perf_counter() - t) * 1e3
        self.records.append({"host_ms": self._host_ms, "step_ms": ms,
                             "loss": out["loss"]})
        return out
