"""Check the program's own spans and counters (``m3d_torch/trace.py``)
against the benchmark's outside view of the same cell, and measure what
the program's tracing costs when on:

    python3 perfbench/trace_check.py --workload <cell>[,<cell>...] \
        [--seed N] [--block-seconds S] [--out FILE] [--device cuda]

from the root of a checkout. Each cell is set up as the harness sets it up
(pool, entry, warm-up), then runs:

- a window of 8 blocks of ``--block-seconds``, the program's tracing off,
  on, on, off, off, on, on, off (the order cancels drift), with the
  benchmark's stage spans (``perfbench/spans.py``) on throughout: the
  median ms a batch with tracing off and on; and in the traced blocks, per
  batch, each stage span's device ms beside the benchmark's ``stage_ms``
  wrapper of the same batch, its host ms less its waits, the host reads by
  site and the NMS rounds;
- as many batches as the traced run profiles, under ``torch.profiler`` with
  tracing on, as the harness's ``trace_batches`` runs them: the program's
  host reads a batch by site beside the profiler's syncs inside the entry
  (``perfbench/profiling.py``), each sync outside an ``m3d.read.*`` range
  named with the ranges around it, the same batches' stage ms and NMS
  rounds, any device op named ``m3d.``, and the idle gaps.

Every count in one row comes from the same batches. One JSON line a cell
on standard output; all of them in ``--out``. Not part of any cell.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("trunk", "proposals", "classifier", "detection", "mask")


def batch_record(trace) -> dict:
    """The one call recorded since the last take, by stage and counter."""
    calls = trace.take()["calls"]
    assert len(calls) == 1, len(calls)
    t = trace.totals(calls[0])
    reads = Counter()
    for v in t.values():
        reads.update({k: n for k, n in v["counters"].items()
                      if k.startswith("host_reads")})
    return {"stages": {st: t[st] for st in STAGES if st in t},
            "wait_ms": t["infer"]["wait_ms"], "reads": reads,
            "rounds": {st: t[st]["counters"].get("nms.rounds", 0)
                       for st in ("proposals", "detection") if st in t}}


def summarise(records: list, bench: dict | None = None) -> dict:
    """Means over the batches' records; ``bench``: the benchmark's
    ``stage_ms`` of the same batches, by stage."""
    n = len(records)
    mean = statistics.mean
    out = {"batches": n,
           "host_reads": {k: v / n for k, v in sorted(
               sum((r["reads"] for r in records), Counter()).items())},
           "nms_rounds": {st: mean(r["rounds"].get(st, 0) for r in records)
                          for st in ("proposals", "detection")},
           "wait_ms": mean(r["wait_ms"] for r in records), "stages": {}}
    for st in STAGES:
        got = [r["stages"][st] for r in records if st in r["stages"]]
        if not got:
            continue
        row = out["stages"][st] = {
            "device_ms": mean(g["device_ms"] or 0.0 for g in got),
            "host_less_wait_ms": mean(g["host_ms"] - g["wait_ms"]
                                      for g in got)}
        if bench is not None:
            row["stage_ms"] = mean(bench[st])
    return out


def profiled_syncs(prof, batches: int) -> dict:
    """The profiler's syncs inside the entry, split into those inside a
    program read's range and the rest, each named by its ranges."""
    import torch

    from perfbench.profiling import SYNC_CALLS, Trace

    kinds = torch.autograd.DeviceType
    events = list(prof.events())
    cpu = [e for e in events if e.device_type == kinds.CPU]
    inside = [(e.time_range.start, e.time_range.end) for e in cpu
              if e.name == "perfbench.entry"]
    reads = [(e.time_range.start, e.time_range.end) for e in cpu
             if e.name.startswith("m3d.read.")]
    matched, missed = 0, Counter()
    for e in cpu:
        t = e.time_range.start
        if e.name not in SYNC_CALLS or not any(s <= t <= u
                                               for s, u in inside):
            continue
        if any(s <= t <= u for s, u in reads):
            matched += 1
            continue
        around = sorted((x.time_range.end - x.time_range.start, x.name)
                        for x in cpu if x.name not in SYNC_CALLS
                        and x.time_range.start <= t <= x.time_range.end)
        missed[f"{e.name} in {[nm for _, nm in around[:3]]}"] += 1
    tr = Trace(prof, batches)
    return {"profiler_syncs": tr.syncs / batches,
            "inside_program_reads": matched / batches,
            "outside_program_reads": dict(missed),
            "m3d_device_ops": sorted({e.name for e in events
                                      if e.device_type == kinds.CUDA
                                      and e.name.startswith("m3d.")
                                      and not getattr(e, "is_user_annotation",
                                                      False)}),
            "idle_gaps": tr.idle_gaps(), "device_ops": tr.top_device_ops(),
            "busy_s": tr.busy_s, "window_s": tr.window_s}


def check_cell(name: str, seed: int, block_s: float, device: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from m3d_torch import trace
    from perfbench import harness, volumes
    from perfbench.spans import StageSpans

    t0 = time.perf_counter()
    cell = harness.Cell(ROOT, name)
    tr = cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mc = cell.config["model"]
    pool = volumes.make_pool(
        (int(mc["IMAGE_SIZE"]), int(mc["IMAGE_SIZE"]), int(mc["IMAGE_DEPTH"])),
        tr["objects"], int(tr["per_source"]), int(tr["shift"]),
        int(tr["source_seed"]), seed, dev,
        float(mc.get("VOXEL_Z_OVER_Y", 1.0)))
    entry = cell.entry_cls(cell.config, tr, seed, dev, ROOT)
    order = volumes.batch_order(seed, pool.shape[0], int(tr["batch"]))

    def one():
        images = pool[torch.as_tensor(next(order), device=dev)]
        return harness.to_host(entry(images))

    out = {"cell": name, "seed": seed}
    with torch.no_grad():
        for _ in range(int(tr["warmup_batches"])):
            one()
        harness.cuda_sync(dev)
        out["setup_s"] = time.perf_counter() - t0
        spans = StageSpans(entry.spans(), cuda)
        ms = {False: [], True: []}
        records, bench = [], defaultdict(list)
        try:
            for on in (False, True, True, False, False, True, True, False):
                if on:
                    trace.enable()
                start = time.perf_counter()
                while time.perf_counter() - start < block_s:
                    b0 = time.perf_counter()
                    one()
                    ms[on].append((time.perf_counter() - b0) * 1e3)
                    spans.end_batch()
                    if on:
                        records.append(batch_record(trace))
                        for st in STAGES:
                            if spans.per_batch[st]:
                                bench[st].append(spans.per_batch[st][-1])
                trace.disable()
        finally:
            trace.disable()
            spans.restore()
        med = {on: statistics.median(v) for on, v in ms.items()}
        out["window"] = {
            "batch_ms_off": med[False], "batch_ms_on": med[True],
            "batches_off": len(ms[False]), "batches_on": len(ms[True]),
            "tracing_on_cost_pct": 100.0 * (med[True] / med[False] - 1.0),
            **summarise(records, bench)}

        n = int(tr["trace_batches"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        records = []
        trace.enable()
        try:
            with profile(activities=acts) as prof:
                for _ in range(n):
                    with record_function("perfbench.batch"):
                        images = pool[torch.as_tensor(next(order),
                                                      device=dev)]
                        with record_function("perfbench.entry"):
                            got = entry(images)
                        harness.to_host(got)
                    records.append(batch_record(trace))
        finally:
            trace.disable()
        out["profiled"] = {**summarise(records), **profiled_syncs(prof, n)}
    entry.close()
    if cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True,
                    help="one cell, or several joined by commas")
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--block-seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".perfbench_cache",
                                                  "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    found = []
    for i, name in enumerate(args.workload.split(",")):
        r = check_cell(name, args.seed + i, args.block_seconds, args.device)
        found.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(found, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
