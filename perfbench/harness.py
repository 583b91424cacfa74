"""One run of one cell: set up, warm up, measure for ``seconds``, check the
outputs against the reference, and build the result line.

Everything that belongs to one piece is found by name:

- the cell: its entry in ``BENCHMARK.json`` ``workloads`` and
  ``perfbench/workloads/<cell>.json`` (the limits of the check and its
  parameters);
- the configuration: ``BENCHMARK.json`` ``configs[].file``;
- the traffic mix: ``perfbench/traffic/<traffic>.json``, read by the one
  generator (perfbench/volumes.py) and the one closed loop below; it names
  the program's entry, ``perfbench/entries/<entry>.py``;
- each metric: ``perfbench/metrics/<metric>.py``, whose ``read(run)``
  returns a number or None (nothing to read: the metric is left out).

A metric module may set ``CAPTURE = [(module name, function name)]``: the
traced run records those calls' arguments during its traced batches, for
the reader's work counts.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import random
import sys
import time

import torch

from perfbench import volumes
from perfbench.spans import StageSpans

FORBIDDEN = ("jax", "jaxlib", "flax", "m3d")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's pieces, found by name from the root of a checkout."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.pkg = os.path.join(root, "perfbench")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; have "
                             f"{sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.spec["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            self.pkg, "traffic", f"{self.spec['traffic']}.json"))
        self.check = load_json(os.path.join(self.pkg, "workloads",
                                            f"{name}.json"))
        self.entry_cls = load_module(
            os.path.join(self.pkg, "entries", f"{self.traffic['entry']}.py"),
            f"perfbench_entry_{self.traffic['entry']}").Entry

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on), as BENCHMARK.json lists them."""
        if not trace:
            return [m for m in self.bench["end_to_end"]
                    if self.name in m.get("workloads", [self.name])]
        mine = {m["name"] for m in self.metrics(False)}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in mine)]

    def reader(self, name: str):
        return load_module(os.path.join(self.pkg, "metrics", f"{name}.py"),
                           f"perfbench_metric_{name.replace('.', '_')}")


class Run:
    """What metric readers read: the host clock's window, the spans and
    the trace of a traced run, the work counts."""

    def __init__(self, cell: Cell):
        self.config = cell.config["model"]
        self.batch = int(cell.traffic["batch"])
        self.batch_ms: list[float] = []
        self.live: list[dict] = []
        self.window_s = 0.0
        self.volumes = 0
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.spans = None
        self.trace = None
        self.captured: dict = {}


def cuda_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def to_host(out: dict) -> dict:
    return {k: v.cpu() for k, v in out.items()}


def sample_batches(k: int, seed: int):
    """Reservoir sampling of ``k`` window batches, seeded."""
    rng = random.Random(seed)
    kept: list = []
    seen = 0

    def offer(item):
        nonlocal seen
        seen += 1
        if len(kept) < k:
            kept.append(item)
        else:
            j = rng.randrange(seen)
            if j < k:
                kept[j] = item
    return kept, offer


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float | None = None,
             substitute=None, log=sys.stderr, all_numbers=False) -> dict:
    """One run; returns the result line's dict. ``substitute(cell, entry,
    seed, device)`` returns a callable that takes the program's place (the
    control, a planted fault); None runs the program. ``all_numbers`` adds
    every number the check worked out, compared or not."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell = Cell(root, workload)
    run = Run(cell)
    tr = cell.traffic
    if tr.get("loop", "closed") != "closed":
        raise SystemExit(f"traffic {cell.spec['traffic']!r}: only the closed "
                         "loop is built")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model_cfg = cell.config["model"]
    shape = (int(model_cfg["IMAGE_SIZE"]), int(model_cfg["IMAGE_SIZE"]),
             int(model_cfg["IMAGE_DEPTH"]))
    t_pool = time.perf_counter()
    pool = volumes.make_pool(shape, tr["objects"], int(tr["per_source"]),
                             int(tr["shift"]), int(tr["source_seed"]), seed,
                             dev, float(model_cfg.get("VOXEL_Z_OVER_Y", 1.0)))
    t_entry = time.perf_counter()
    entry = cell.entry_cls(cell.config, tr, seed, dev, root)
    t_warm = time.perf_counter()
    call = entry if substitute is None else substitute(cell, entry, seed,
                                                       dev)
    order = volumes.batch_order(seed, pool.shape[0], run.batch)

    def one_batch(idx):
        images = pool[torch.as_tensor(idx, device=dev)]
        return to_host(call(images))

    with torch.no_grad():
        warm = volumes.batch_order(seed + 1, pool.shape[0], run.batch)
        for _ in range(int(tr["warmup_batches"])):
            one_batch(next(warm))
        cuda_sync(dev)
        run.setup_s = time.perf_counter() - t0
        print(f"setup {run.setup_s:.3f} s: start and imports "
              f"{t_pool - t0:.3f}, pool {t_entry - t_pool:.3f}, model and "
              f"weights {t_warm - t_entry:.3f}, warm-up "
              f"{t0 + run.setup_s - t_warm:.3f}", file=log, flush=True)

        spans = None
        if trace:
            spans = run.spans = StageSpans(entry.spans(), cuda)
        kept, offer = sample_batches(int(cell.check["check_batches"]), seed)
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            idx = next(order)
            b0 = time.perf_counter()
            out = one_batch(idx)
            end = time.perf_counter()
            run.batch_ms.append((end - b0) * 1e3)
            run.live.append(entry.live(out))
            if spans is not None:
                spans.end_batch()
            offer((idx, out))
        run.window_s = end - start
        run.volumes = len(run.batch_ms) * run.batch
        if cuda:
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        print(f"window {run.window_s:.3f} s, {len(run.batch_ms)} batches",
              file=log, flush=True)

        if trace:
            trace_batches(run, cell, entry, call, pool, order, cuda)
            spans.restore()

    entry.close()
    del call, entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    run.captured = {}

    t_check = time.perf_counter()
    ok, table, failed, numbers = cell.entry_cls.CHECK.run_check(
        cell, pool, kept, seed, dev, root)
    print(f"check {time.perf_counter() - t_check:.3f} s over {len(kept)} "
          f"batches", file=log, flush=True)
    result = {"correct": ok, "attempted": run.volumes,
              "failed": failed, "metrics": metrics,
              "device": device_info(run, cuda)}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    if all_numbers:
        result["numbers"] = numbers
    result["checks"] = table
    return result


def trace_batches(run: Run, cell: Cell, entry, call, pool, order, cuda):
    """``trace_batches`` more batches under torch.profiler, with the
    captures the cell's per-layer readers ask for."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.profiling import Trace
    from perfbench.spans import Capture

    targets = set()
    for m in cell.metrics(True):
        for mod, fn in getattr(cell.reader(m["name"]), "CAPTURE", ()):
            targets.add((mod, fn))
    cap = Capture([(importlib.import_module(mod), fn)
                   for mod, fn in sorted(targets)])
    n = int(cell.traffic["trace_batches"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    cap.on = True
    try:
        with profile(activities=acts) as prof:
            for _ in range(n):
                idx = next(order)
                with record_function("perfbench.batch"):
                    images = pool[torch.as_tensor(idx, device=pool.device)]
                    with record_function("perfbench.entry"):
                        out = call(images)
                    to_host(out)
                run.spans.open = []     # the stage means are the window's
    finally:
        cap.on = False
        cap.restore()
    run.trace = Trace(prof, n)
    run.captured = cap.calls


def device_info(run: Run, cuda: bool) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes),
            "host_cpu": host_cpu()}


def host_cpu() -> str:
    """The host CPU's model and core count: the adaptive cells are
    host-paced, so their numbers move with it."""
    import platform

    name = "model unknown"
    try:
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith(("model name", "Model", "CPU part"))),
                        name)
    except OSError:
        pass
    return f"{name} ({platform.machine()}) x{os.cpu_count()}"
