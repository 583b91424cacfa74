"""The per-layer metrics that read the program's own spans and counters
(perfbench/program_trace.py): a tiny traced CPU cell reads all of them,
with the program's tracing off through the warm-up and the window, on
through the profiled batches and off after; where ``m3d_torch.trace`` is
not found they are left out."""

from __future__ import annotations

import json

from conftest import REPO
from test_perfbench_harness import run_in

PROGRAM_METRICS = (
    [f"stage_host_ms.{s}" for s in ("trunk", "proposals", "classifier",
                                    "detection", "mask")]
    + ["host_wait_ms.infer", "nms_rounds.proposals", "nms_rounds.detection",
       "roi_rows_useful_pct.classifier", "roi_rows_useful_pct.mask"])

CELL = """
import json, sys, torch
torch.set_num_threads(2)
from perfbench import harness
if {hide}:                                  # a program without the module
    from perfbench import program_trace
    program_trace._trace().disable()
    program_trace._trace = lambda: None
seen = []                                   # (profiler on, tracing on)

def substitute(cell, entry, seed, device):
    def call(images):
        t = sys.modules.get("m3d_torch.trace")
        seen.append((torch.autograd._profiler_enabled(),
                     bool(t and t._on)))
        return entry(images)
    return call

r = harness.run_cell({root!r}, {cell!r}, 987654321987, 1.0, True, "cpu",
                     substitute=substitute)
t = sys.modules.get("m3d_torch.trace")
print(json.dumps({{"metrics": r["metrics"], "seen": seen,
                   "after": bool(t and t._on)}}))
"""


def traced(root, cell, hide=False):
    p = run_in(root, CELL.format(root=root, cell=cell, hide=hide))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_traced_cell_reads_the_program_metrics(tiny_root):
    for cell in ("tiny-bench128-adaptive-B4", "tiny-bench128-mono-B4"):
        out = traced(tiny_root, cell)
        got = out["metrics"]
        assert set(PROGRAM_METRICS) <= set(got), cell
        window = [on for prof, on in out["seen"] if not prof]
        profiled = [on for prof, on in out["seen"] if prof]
        assert window and not any(window), cell
        assert profiled and all(profiled), cell
        assert out["after"] is False
        for name in PROGRAM_METRICS:
            assert got[name]["value"] >= 0, (cell, name)
        for s in ("classifier", "mask"):
            assert 0 < got[f"roi_rows_useful_pct.{s}"]["value"] <= 100
        assert got["nms_rounds.proposals"]["value"] >= 1


def test_program_without_trace_leaves_them_out(tiny_root):
    got = traced(tiny_root, "tiny-bench128-adaptive-B4", hide=True)["metrics"]
    assert not set(PROGRAM_METRICS) & set(got)
    assert "stage_ms.classifier" in got


def test_trace_check_on_a_tiny_cell(tiny_root):
    """perfbench/trace_check.py on the CPU: the program's reads and rounds
    of the profiled batches, each sync-free there, the window's costs and
    the stage rows beside the benchmark's own spans."""
    import os
    import subprocess
    import sys

    out = os.path.join(tiny_root, "trace_check.json")
    p = subprocess.run(
        [sys.executable, "perfbench/trace_check.py", "--workload",
         "tiny-bench128-adaptive-B4,tiny-bench128-mono-B4", "--seed",
         "3000000019", "--block-seconds", "0.3", "--device", "cpu", "--out",
         out], cwd=tiny_root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=os.pathsep.join([tiny_root, REPO])))
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out) as f:
        found = json.load(f)
    assert [r["cell"] for r in found] == ["tiny-bench128-adaptive-B4",
                                          "tiny-bench128-mono-B4"]
    for r in found:
        w, prof = r["window"], r["profiled"]
        assert w["batches_off"] > 0 and w["batches_on"] > 0
        for part in (w, prof):
            reads = part["host_reads"]
            assert reads["host_reads"] == sum(
                v for k, v in reads.items() if k != "host_reads")
            assert reads["host_reads.nms.fixpoint"] == sum(
                part["nms_rounds"].values())
            assert set(part["stages"]) == {"trunk", "proposals",
                                           "classifier", "detection", "mask"}
        assert set(w["stages"]["classifier"]) == {
            "device_ms", "host_less_wait_ms", "stage_ms"}
        assert prof["profiler_syncs"] == 0          # no card, no syncs
        assert prof["m3d_device_ops"] == []
