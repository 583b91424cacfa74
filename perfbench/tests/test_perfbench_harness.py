"""The harness on the CPU at a tiny size: pieces found by name, the result
line's schema, the run's refusal without a card, and what a run loads."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import REPO


def tree_hashes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "perfbench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def run_in(root: str, code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


CELL = """
import json, sys, torch
torch.set_num_threads(2)
from perfbench import harness
r = harness.run_cell({root!r}, {cell!r}, {seed}, 1.0, {trace}, "cpu")
print(json.dumps({{"result": r, "modules": sorted(
    {{m.split(".")[0] for m in sys.modules}})}}))
"""


def run_cell(root, cell, seed=12345678901, trace=False):
    p = run_in(root, CELL.format(root=root, cell=cell, seed=seed,
                                 trace=trace))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_new_pieces_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new
    files and entries run without an edit to any file already there."""
    from conftest import make_root, tiny_cell

    root = make_root(str(tmp_path / "b"))
    before = tree_hashes(root)
    pb = os.path.join(root, "perfbench")
    twin = tiny_cell("bench128-adaptive-B4")
    with open(os.path.join(pb, "traffic", f"{twin}.json")) as f:
        traffic = json.load(f)
    traffic["objects"] = [2, 4]
    with open(os.path.join(pb, "traffic", "throwaway-mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "workloads", f"{twin}.json")) as f:
        check = f.read()
    with open(os.path.join(pb, "workloads", "throwaway-cell.json"), "w") as f:
        f.write(check)
    with open(os.path.join(pb, "metrics", "throwaway_batches.py"), "w") as f:
        f.write("def read(run):\n    return len(run.batch_ms)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "throwaway-cell", "config": "tiny",
                               "traffic": "throwaway-mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "throwaway_batches", "unit": "count",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["throwaway-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = run_cell(root, "throwaway-cell")["result"]
    assert out["metrics"]["throwaway_batches"]["value"] >= 1
    assert "setup_s" in out["metrics"]
    after = tree_hashes(root)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(tiny_root, trace):
    out = run_cell(tiny_root, "tiny-bench128-mono-B4",
                   trace=trace)
    r = out["result"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["correct"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for row in r["checks"].values():
        assert set(row) == {"value", "limit"}
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        per_layer = {m["name"] for m in bench["per_layer"]}
        assert set(r["metrics"]) <= per_layer
        assert {"stage_ms.trunk", "stage_ms.mask", "mfu.infer"} <= set(
            r["metrics"])
    else:
        assert set(r["metrics"]) == {"infer_vol_per_s", "infer_batch_p95_ms",
                                     "setup_s"}


def test_run_modules_are_the_port_alone(tiny_root):
    """Nothing a run loads has the top-level name jax, jaxlib, flax or m3d
    (whole names: m3d_torch is the port)."""
    mods = set(run_cell(tiny_root, "tiny-bench128-adaptive-B4")
               ["modules"])
    assert not mods & {"jax", "jaxlib", "flax", "m3d"}
    assert "m3d_torch" in mods


def test_reference_loads_nothing_of_the_program():
    code = ("import sys\nimport perfbench.reference.maskrcnn, "
            "perfbench.reference.anchors, perfbench.check_infer, "
            "perfbench.weights, perfbench.roofline, perfbench.volumes\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = run_in(REPO, code)
    assert p.returncode == 0, p.stderr
    mods = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not mods & {"m3d_torch", "m3d", "jax", "jaxlib", "flax"}


def test_run_refuses_without_a_card(tmp_path):
    """No card: exit 1 and no result line, also from a directory that
    holds only BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copytree(os.path.join(REPO, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "bench128-adaptive-B4", "--seed", "4294967297", "--seconds",
             "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
        assert p.returncode != 0
        assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "bench128-mono-B4", "--seed", "7", "--seconds", "3", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
