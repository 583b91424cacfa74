"""Reading a ``torch.profiler`` trace of a few batches (the busy-union and
sync arithmetic of the port's smoke run, extended): device
busy seconds over the traced window, host synchronisations inside the
program's calls, each ``torch.library`` op's device time (the kernels
launched inside its range, whatever implements it), the device operations
that took most time, and the idle gaps named by what the host was doing.

The harness marks each traced batch with ``record_function("perfbench.batch")``
and the program's call inside it with ``"perfbench.entry"``; stage spans add
``"stage.<name>"`` ranges.
"""

from __future__ import annotations

from collections import defaultdict

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def merged(spans):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """What the harness reads from one profiled stretch of batches."""

    def __init__(self, prof, batches: int):
        import torch

        kinds = torch.autograd.DeviceType
        events = list(prof.events())
        cpu = [e for e in events if e.device_type == kinds.CPU]
        self.batches = batches
        marks = [e for e in cpu if e.name == "perfbench.batch"]
        self.lo = min(e.time_range.start for e in marks)
        self.hi = max(e.time_range.end for e in marks)
        dev = [e for e in events if e.device_type == kinds.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("perfbench.", "stage."))
               and e.time_range.end > self.lo and e.time_range.start < self.hi]
        self.device = [(max(e.time_range.start, self.lo),
                        min(e.time_range.end, self.hi), e.name) for e in dev]
        self.window_s = (self.hi - self.lo) / 1e6
        self.busy_s = sum(e - s for s, e in merged(
            [(s, e) for s, e, _ in self.device])) / 1e6
        entries = [(e.time_range.start, e.time_range.end) for e in cpu
                   if e.name == "perfbench.entry"]
        self.syncs = sum(1 for e in cpu if e.name in SYNC_CALLS and any(
            s <= e.time_range.start <= t for s, t in entries))
        self.cpu = cpu
        self.op_device_s = defaultdict(float)
        for e in cpu:
            if "::" in e.name and not e.name.startswith("aten::"):
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = e.cuda_time_total
                self.op_device_s[e.name] += total / 1e6

    def top_device_ops(self, n: int = 10):
        by = defaultdict(float)
        for s, e, name in self.device:
            by[name] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle stretches of the device inside the traced window, summed
        by what the host was doing at each one's middle: the innermost
        host range open then, under its stage."""
        import heapq

        busy = merged([(s, e) for s, e, _ in self.device])
        edges = [self.lo] + [x for iv in busy for x in iv] + [self.hi]
        gaps = sorted(((a + b) / 2, b - a) for a, b in zip(edges[::2],
                                                           edges[1::2])
                      if b > a)
        evs = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in self.cpu if e.name != "perfbench.batch")
        active, i = [], 0
        by = defaultdict(float)
        for t, length in gaps:
            while i < len(evs) and evs[i][0] <= t:
                heapq.heappush(active, (evs[i][1], evs[i][0], evs[i][2]))
                i += 1
            while active and active[0][0] < t:
                heapq.heappop(active)
            if not active:
                by["host: between batches"] += length / 1e6
                continue
            stage = [nm for _, _, nm in active if nm.startswith("stage.")]
            inner = min(active, key=lambda a: a[0] - a[1])[2]
            where = stage[0] if stage else (
                "perfbench.entry" if any(nm == "perfbench.entry"
                                         for _, _, nm in active)
                else "harness")
            by[f"{where} / {inner}"] += length / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]
