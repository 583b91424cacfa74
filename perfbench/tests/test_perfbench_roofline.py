"""The yardstick's arithmetic on hand-worked shapes."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import REPO, TINY_MODEL
from perfbench import roofline


def test_bound_takes_the_slowest_unit():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, f32_ops=67e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, bf16_ops=989e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, f32_ops=134e9) == pytest.approx(2e-3)


def test_compact_work_by_hand():
    """One live row at p = 2 on a 4^3 level, samples at voxel corners 0
    and 1 on each axis (taps 0-2): 27 voxels of C = 4 channels read, the
    [2, 2, 2, 4] row written in bf16, 16 flops an output element; a second,
    dead row is written but reads nothing."""
    fms = [torch.zeros(1, 4, 4, 4, 4, dtype=torch.bfloat16)] + [
        torch.zeros(1, 2, 2, 2, 4, dtype=torch.bfloat16)] * 3
    pos = torch.tensor([[0.0, 1.0]] * 3 + [[2.0, 3.0]] * 3).reshape(2, 3, 2)
    levels = torch.tensor([0, 0], dtype=torch.int32)
    bat = torch.zeros(2, dtype=torch.int32)
    nbytes, f32 = roofline.compact_work(levels, bat, 1, pos, fms)
    assert roofline.touched_voxels(levels, bat, 1, pos, fms) == 27
    assert nbytes == 2 * 8 * 4 * 2 + 27 * 4 * 2 + 12 * 4 + 16 + 4
    assert f32 == 16 * 8 * 4


def test_fc_work_by_hand():
    """Two rows in bounds at p = 1 with one tap each (weight 1 at slab
    column 0) on distinct voxels: 2 voxels read, 2 taps."""
    fms = [torch.zeros(1, 4, 4, 4, 64, dtype=torch.bfloat16)] * 4
    w = torch.zeros(2, 1, 2)
    w[:, :, 0] = 1.0
    origins = torch.tensor([[0, 0, 0], [1, 1, 1]], dtype=torch.int32)
    wk = torch.zeros(8, 64, dtype=torch.bfloat16)
    args = (torch.zeros(2, dtype=torch.int32), torch.zeros(2,
            dtype=torch.int32), origins, w, w, w, fms, wk,
            torch.tensor([0, 2], dtype=torch.int32))
    nbytes, f32, bf16 = roofline.fc_args_work(args)
    assert f32 == 2 * 2 * 64
    assert bf16 == 2 * 2 * 64 * 8
    assert nbytes == (2 * 8 * 4 + 64 * 8 * 2 + 2 * 64 * 2 + 20 * 2
                      + 2 * 1 * 6 * 4 + 8)


def test_step_flops_by_hand():
    """The per-ROI heads at the tiny widths, worked out: classifier
    p^3 C F + F^2 + 7 F K multiply-adds; mask head four 3^3 convs and the
    dilated one at m^3, the 2x transposed conv, the 1^3 conv at (2m)^3."""
    with open(os.path.join(REPO, "perfbench", "configs",
                           "bench128-r50.json")) as f:
        cfg = json.load(f)["model"]
    cfg.update(TINY_MODEL)
    f = roofline.step_flops(cfg)
    p, c, fc, k, m, cc = 7, 32, 64, 2, 14, 32
    assert f["classifier_row"] == 2 * (p ** 3 * c * fc + fc * fc
                                       + 7 * fc * k)
    mask = (m ** 3 * 27 * (c * cc + 4 * cc * cc) + m ** 3 * cc * cc * 8
            + (2 * m) ** 3 * cc * k)
    assert f["mask_row"] == 2 * mask
    # The stem alone: 7^3 x 1 channel into 64 at 32 x 32 x 8.
    assert f["image"] > 2 * 32 * 32 * 8 * 64 * 343
