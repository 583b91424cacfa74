"""Fixtures of the benchmark's own tests: a copy of the benchmark with a tiny
configuration and two tiny cells added as new files, the way a later change
adds a configuration or a cell. Card-only tests carry the ``cuda`` marker
and skip inside the ``card`` fixture where no card is present.

    python -m pytest perfbench/tests -q                 # CPU
    python -m pytest perfbench/tests -q -m cuda         # on the card
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# The widths of the port's tiny test model, at 64 x 64 x 8 and z-stride 1.
TINY_MODEL = dict(
    IMAGE_SIZE=64, IMAGE_DEPTH=8,
    BACKBONE_STRIDES=[[4, 4, 1], [8, 8, 1], [16, 16, 1], [32, 32, 1],
                      [64, 64, 1]],
    RPN_ANCHOR_SCALES=[8, 16, 24, 32, 48], RPN_ANCHOR_RATIOS=[0.5, 1.0],
    PRE_NMS_LIMIT=512, POST_NMS_ROIS_INFERENCE=64, DETECTION_MAX_INSTANCES=8,
    DETECTION_MIN_CONFIDENCE=0.2, FPN_CLASSIF_FC_LAYERS_SIZE=64,
    HEAD_CONV_CHANNEL=32, TOP_DOWN_PYRAMID_SIZE=32)


def tiny_cell(cell: str) -> str:
    """The tiny twin of a committed cell: its entry, its check and its
    limits, at the tiny configuration."""
    return f"tiny-{cell}"


def make_root(dest: str, dtype: str = "bfloat16", base: str = "bench128-r50"
              ) -> str:
    """A checkout-like tree at ``dest``: BENCHMARK.json and perfbench/ as
    committed, plus a tiny configuration (seeded weights) and, for every
    committed cell, its tiny twin, each added as new files and entries."""
    os.makedirs(dest, exist_ok=True)
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(dest, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(dest, "perfbench")
    with open(os.path.join(pb, "configs", f"{base}.json")) as f:
        model = json.load(f)["model"]
    model.update(TINY_MODEL, COMPUTE_DTYPE=dtype)
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump({"source": "test", "reduced": [], "weights": {
            "kind": "seed"}, "model": model}, f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for w in list(bench["workloads"]):
        cell = tiny_cell(w["name"])
        with open(os.path.join(pb, "traffic", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        traffic.update(batch=2, objects=[3, 5], per_source=2, warmup_batches=1,
                       trace_batches=2)
        with open(os.path.join(pb, "traffic", f"{cell}.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(pb, "workloads", f"{w['name']}.json")) as f:
            check = json.load(f)
        check["check_batches"] = 2
        with open(os.path.join(pb, "workloads", f"{cell}.json"), "w") as f:
            json.dump(check, f)
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": cell, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
