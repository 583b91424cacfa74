"""The port's NMS (m3d_torch/ops/nms3d.py) against JAX's: the blockwise
greedy and the numpy oracle on seeded cases (ragged blocks, max_output > N,
all invalid, ties, long suppression chains), and ``nms_3d``'s dispatch past
FIXPOINT_MAX_N. Indices and validity must be equal exactly. The card test
at N = 30000 is in tests/test_torch_kernels.py (no JAX there).
"""

import numpy as np
import pytest
import torch

from m3d.ops import nms3d as JN
from m3d_torch.ops import nms3d as TN

T = torch.from_numpy


def _boxes(rng, n, lo_hi=(0.0, 0.6), ext=(0.1, 0.35)):
    lo = rng.uniform(*lo_hi, (n, 3)).astype(np.float32)
    return np.concatenate([lo, lo + rng.uniform(*ext, (n, 3))],
                          -1).astype(np.float32)


def _chain(n, step=0.3):
    """Unit boxes shifted by ``step`` along y: each overlaps the next at
    IoU 0.54 and the one after at 0.25, so at threshold 0.5 greedy keeps
    every other box and each kill waits on the one before it."""
    y = np.arange(n, dtype=np.float32) * step
    z = np.zeros(n, np.float32)
    return np.stack([y, z, z, y + 1, z + 1, z + 1], -1)


def _clusters(rng, n, centers=12, jitter=0.04):
    """Dense clusters of jittered boxes around a few centers (RPN-like
    proposals around objects): many overlaps above the threshold."""
    c = rng.uniform(0.1, 0.6, (centers, 3)).astype(np.float32)
    size = rng.uniform(0.15, 0.3, (centers, 3)).astype(np.float32)
    k = rng.randint(0, centers, n)
    lo = c[k] + rng.normal(0, jitter, (n, 3)).astype(np.float32)
    hi = lo + size[k] * rng.uniform(0.8, 1.2, (n, 3)).astype(np.float32)
    return np.concatenate([lo, hi], -1).astype(np.float32)


def _case(name, rng):
    """(boxes [B, N, 6], scores [B, N], valid [B, N] or None, thr, k)."""
    if name == "ragged":        # N not a multiple of the block
        b = np.stack([_boxes(rng, 301) for _ in range(2)])
        s = rng.uniform(size=(2, 301)).astype(np.float32)
        return b, s, rng.uniform(size=(2, 301)) < 0.9, 0.3, 40
    if name == "k_above_n":     # max_output > N
        b = _boxes(rng, 90)[None]
        return b, rng.uniform(size=(1, 90)).astype(np.float32), None, 0.2, 150
    if name == "all_invalid":
        b = np.stack([_boxes(rng, 130) for _ in range(2)])
        s = rng.uniform(size=(2, 130)).astype(np.float32)
        return b, s, np.zeros((2, 130), bool), 0.3, 20
    if name == "ties":          # a handful of distinct scores
        b = np.stack([_boxes(rng, 200) for _ in range(2)])
        s = (np.round(rng.uniform(size=(2, 200)) * 4) / 4).astype(np.float32)
        return b, s, None, 0.2, 60
    if name == "chain":         # one suppression chain across all blocks
        b = _chain(257)[None]
        s = np.linspace(1.0, 0.0, 257, dtype=np.float32)[None]
        return b, s, None, 0.5, 200
    if name == "clusters":
        b = np.stack([_clusters(rng, 400) for _ in range(2)])
        s = rng.uniform(size=(2, 400)).astype(np.float32)
        return b, s, rng.uniform(size=(2, 400)) < 0.95, 0.4, 120
    raise ValueError(name)


CASES = ["ragged", "k_above_n", "all_invalid", "ties", "chain", "clusters"]


@pytest.mark.parametrize("name", CASES)
def test_blockwise_matches_jax_and_oracle(name):
    rng = np.random.RandomState(CASES.index(name))
    boxes, scores, valid, thr, k = _case(name, rng)
    idx, ok = TN.nms_3d_blockwise(T(boxes), T(scores), thr, k,
                                  valid=None if valid is None else T(valid),
                                  block_size=64)
    assert idx.shape == ok.shape == (boxes.shape[0], k)
    for b in range(boxes.shape[0]):
        vb = None if valid is None else valid[b]
        ji, jv = JN.nms_3d_blockwise(boxes[b], scores[b], thr, k, valid=vb,
                                     block_size=64)
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        s = scores[b] if vb is None else np.where(vb, scores[b], -np.inf)
        live = np.isfinite(s)
        want = np.flatnonzero(live)[TN.nms_3d_numpy(
            boxes[b][live], scores[b][live], thr, k)]
        np.testing.assert_array_equal(idx[b][ok[b]].numpy(), want)
    if name == "chain":
        assert ok[0].sum() == 129   # every other box of 257


@pytest.mark.parametrize("name", ["ragged", "ties", "clusters"])
def test_blockwise_equals_fixpoint(name):
    """Below the threshold both branches give the same result."""
    rng = np.random.RandomState(10 + CASES.index(name))
    boxes, scores, valid, thr, k = _case(name, rng)
    v = None if valid is None else T(valid)
    for got, want in zip(
            TN.nms_3d_blockwise(T(boxes), T(scores), thr, k, valid=v,
                                block_size=32),
            TN.nms_3d_fixpoint(T(boxes), T(scores), thr, k, valid=v)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", ["ragged", "ties", "chain", "clusters"])
def test_numpy_oracle_matches_jax(name):
    rng = np.random.RandomState(20 + CASES.index(name))
    boxes, scores, _, thr, k = _case(name, rng)
    for b in range(boxes.shape[0]):
        np.testing.assert_array_equal(
            TN.nms_3d_numpy(boxes[b], scores[b], thr, k),
            JN.nms_3d_numpy(boxes[b], scores[b], thr, k))
    assert TN.nms_3d_numpy(np.zeros((0, 6), np.float32),
                           np.zeros(0, np.float32), 0.5, 4).shape == (0,)


def test_dispatch_past_fixpoint_max_n_matches_jax(monkeypatch):
    """N = FIXPOINT_MAX_N + 1 takes the blockwise branch, allocates no
    [N, N] IoU, and returns JAX's nms_3d indices and validity exactly."""
    assert TN.FIXPOINT_MAX_N == JN.FIXPOINT_MAX_N == 16384
    n = TN.FIXPOINT_MAX_N + 1
    rng = np.random.RandomState(30)
    boxes = _clusters(rng, n, centers=400, jitter=0.01)
    scores = rng.uniform(size=n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.97
    shapes = []
    real_iou = TN.pairwise_iou

    def spy_iou(*a, **kw):
        out = real_iou(*a, **kw)
        shapes.append(tuple(out.shape))
        return out

    def no_fixpoint(*a, **kw):
        raise AssertionError("fixpoint branch taken above FIXPOINT_MAX_N")

    monkeypatch.setattr(TN, "pairwise_iou", spy_iou)
    monkeypatch.setattr(TN, "nms_3d_fixpoint", no_fixpoint)
    idx, ok = TN.nms_3d(T(boxes[None]), T(scores[None]), 0.3, 300,
                        valid=T(valid[None]))
    assert shapes and max(s[-2] for s in shapes) == 128
    ji, jv = JN.nms_3d(boxes, scores, 0.3, 300, valid=valid)
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    assert 0 < int(ok.sum()) <= 300


def test_dispatch_at_fixpoint_max_n_takes_fixpoint(monkeypatch):
    """N <= FIXPOINT_MAX_N stays on the fixpoint, as in JAX."""
    called = []
    monkeypatch.setattr(TN, "nms_3d_blockwise",
                        lambda *a, **kw: called.append(1))
    rng = np.random.RandomState(31)
    boxes = _boxes(rng, 64)[None]
    scores = rng.uniform(size=(1, 64)).astype(np.float32)
    idx, ok = TN.nms_3d(T(boxes), T(scores), 0.3, 10)
    assert not called and idx.shape == (1, 10)

