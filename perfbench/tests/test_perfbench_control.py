"""The check fails what it must: the control (the reference in float8 in
the program's place) and the planted faults, each run through the rest of
a tiny twin of every committed cell on the CPU, under that cell's own
limits, come out not correct; the program comes out correct."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import REPO, tiny_cell

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
FAULTS = ["half_batch", "altered_answer", "topk_reversed",
          "proposal_nms_skipped", "detection_nms_skipped"]


def run(root, cell, seed, substitute=None):
    from perfbench import control, harness

    torch.set_num_threads(2)
    with open(os.devnull, "w") as log:
        return harness.run_cell(root, tiny_cell(cell), seed, 1.0, False,
                                "cpu", log=log,
                                substitute=control.SUBSTITUTES.get(substitute))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [4, 2 ** 33 + 5])
def test_program_is_correct(tiny_root, seed, cell):
    r = run(tiny_root, cell, seed)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(tiny_root, seed, cell):
    r = run(tiny_root, cell, seed, "control")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(tiny_root, cell, fault):
    r = run(tiny_root, cell, 21, fault)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0
