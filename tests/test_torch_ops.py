"""m3d_torch ops against m3d's: box math, SAME/VALID 3D convolution, batched
fixpoint NMS (ties included), and flat / compact pyramid ROIAlign (the
compact one against both JAX's gather fallback and its Pallas kernel in
interpret mode). The port runs in float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3d import boxes as JB
from m3d.config import Config
from m3d.image_meta import default_meta
from m3d.ops.conv3d import ZConv as JZConv
from m3d.ops.nms3d import nms_3d_fixpoint, nms_3d_numpy
from m3d.ops.roialign3d import (_axis_positions, compute_roi_levels,
                                pyramid_roi_align_compact,
                                pyramid_roi_align_flat)
from m3d_torch import boxes as TB
from m3d_torch.checkpoints import params_from_jax, restore_by_name
from m3d_torch.ops import roialign3d as TR
from m3d_torch.ops.conv3d import ZConv
from m3d_torch.ops.nms3d import nms_3d

T = torch.from_numpy


def _random_boxes(rng, shape, lo_hi=(0.0, 0.7), ext=(0.02, 0.3)):
    lo = rng.uniform(*lo_hi, shape + (3,)).astype(np.float32)
    return np.concatenate([lo, lo + rng.uniform(*ext, shape + (3,))],
                          -1).astype(np.float32)


def test_box_math_matches_jax():
    rng = np.random.RandomState(0)
    a = _random_boxes(rng, (2, 17))
    b = _random_boxes(rng, (2, 9))
    d = rng.randn(2, 17, 6).astype(np.float32) * 3
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TB.apply_deltas(T(a), T(d)).numpy(),
                               np.asarray(JB.apply_deltas(a, d)), **close)
    np.testing.assert_allclose(
        TB.apply_deltas(T(a), T(d), clip_log_scale=False).numpy(),
        np.asarray(JB.apply_deltas(a, d, clip_log_scale=False)), **close)
    np.testing.assert_allclose(TB.overlaps_3d(T(a[0]), T(b[0])).numpy(),
                               np.asarray(JB.overlaps_3d(a[0], b[0])), **close)
    np.testing.assert_allclose(TB.box_volume(T(a)).numpy(),
                               np.asarray(JB.box_volume(a)), **close)
    flat = a.copy()
    flat[..., 3:] = flat[..., :3]          # degenerate boxes
    np.testing.assert_array_equal(
        TB.enforce_min_size(T(flat), 1e-6, 1 / 8).numpy(),
        np.asarray(JB.enforce_min_size(flat, 1e-6, 1 / 8)))
    shape = (64.0, 48.0, 8.0)
    np.testing.assert_allclose(TB.denorm_boxes(T(a), shape).numpy(),
                               np.asarray(JB.denorm_boxes(a, shape)), **close)
    np.testing.assert_allclose(TB.norm_boxes(T(a * 70), shape).numpy(),
                               np.asarray(JB.norm_boxes(a * 70, shape)),
                               **close)


CONV_CASES = [
    # kernel, strides, padding, dilation, input spatial
    ((3, 3, 3), (1, 1, 1), "SAME", (1, 1, 1), (6, 5, 4)),
    ((3, 3, 3), (1, 1, 1), "SAME", (2, 2, 2), (7, 6, 5)),
    ((3, 3, 3), (2, 2, 1), "SAME", (1, 1, 1), (8, 7, 4)),      # asymmetric
    ((7, 7, 7), (2, 2, 2), [(3, 3)] * 3, (1, 1, 1), (9, 8, 8)),
    ((1, 1, 1), (2, 2, 2), "VALID", (1, 1, 1), (6, 6, 4)),
    ((2, 3, 2), (1, 2, 2), "SAME", (1, 1, 1), (5, 7, 6)),      # even kernel
    ((3, 3, 3), (1, 1, 1), "VALID", (1, 1, 1), (3, 3, 3)),     # full extent
]


@pytest.mark.parametrize("k,s,pad,dil,spatial", CONV_CASES)
def test_zconv_matches_jax(k, s, pad, dil, spatial):
    rng = np.random.RandomState(1)
    x = rng.randn(2, *spatial, 3).astype(np.float32)
    jm = JZConv(5, k, strides=s, padding=pad, kernel_dilation=dil,
                dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), x)
    variables = jax.tree.map(
        lambda v: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) * 0.1,
        variables)
    ref = np.asarray(jm.apply(variables, x))
    tm = ZConv(3, 5, k, s, pad, dil, dtype=torch.float32)
    assert restore_by_name(tm, params_from_jax(variables))["missing"] == 0
    got = tm(T(x)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _nms_case(rng, n, ties=False):
    boxes = _random_boxes(rng, (n,), (0.0, 0.6), (0.1, 0.35))
    scores = rng.uniform(size=n).astype(np.float32)
    if ties:  # a handful of distinct values, as bf16 probabilities give
        scores = np.round(scores * 4) / 4
    return boxes, scores


@pytest.mark.parametrize("n,k,thr,ties", [(60, 20, 0.3, False),
                                           (60, 80, 0.1, False),
                                           (120, 40, 0.2, True)])
def test_nms_matches_jax(n, k, thr, ties):
    rng = np.random.RandomState(n + k)
    cases = [_nms_case(rng, n, ties) for _ in range(3)]
    valid = rng.uniform(size=(3, n)) < 0.9
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    idx, ok = nms_3d(T(boxes), T(scores), thr, k, valid=T(valid))
    for b in range(3):
        ji, jv = nms_3d_fixpoint(boxes[b], scores[b], thr, k, valid=valid[b])
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))


def test_nms_ties_lower_index_first():
    """Equal scores keep the lower index first, as jnp.argsort / lax.top_k
    order them, and the greedy keep set equals the numpy oracle's."""
    rng = np.random.RandomState(3)
    boxes = _random_boxes(rng, (50,), (0.0, 0.5), (0.2, 0.4))
    scores = np.full(50, 0.5, np.float32)
    scores[::7] = 0.75
    idx, ok = nms_3d(T(boxes[None]), T(scores[None]), 0.2, 50)
    kept = idx[0][ok[0]].numpy()
    np.testing.assert_array_equal(kept, nms_3d_numpy(boxes, scores, 0.2, 50))
    ji, jv = nms_3d_fixpoint(boxes, scores, 0.2, 50)
    np.testing.assert_array_equal(kept, np.asarray(ji)[np.asarray(jv)])
    tied = kept[scores[kept] == 0.5]
    assert (np.diff(tied) > 0).all()


def _pyramid(rng, b, c, depth=8):
    return [rng.randn(b, 16, 16, depth, c).astype(np.float32),
            rng.randn(b, 8, 8, depth, c).astype(np.float32),
            rng.randn(b, 4, 4, max(depth // 2, 1), c).astype(np.float32),
            rng.randn(b, 2, 2, max(depth // 4, 1), c).astype(np.float32)]


def test_positions_and_levels_match_jax():
    rng = np.random.RandomState(4)
    boxes = _random_boxes(rng, (40,), (0.0, 0.5), (0.01, 0.5))
    size = rng.randint(2, 40, 40).astype(np.float32)
    for p in (1, 7, 14):
        np.testing.assert_array_equal(
            TR.axis_positions(T(boxes[:, 0]), T(boxes[:, 3]), T(size),
                              p).numpy(),
            np.asarray(_axis_positions(boxes[:, 0], boxes[:, 3], size, p)))
    shp = tuple(np.full(40, s, np.float32) for s in (64.0, 64.0, 8.0))
    np.testing.assert_array_equal(
        TR.compute_roi_levels(T(boxes), tuple(T(s) for s in shp)).numpy(),
        np.asarray(compute_roi_levels(boxes, shp)))


def test_roialign_flat_matches_jax():
    rng = np.random.RandomState(5)
    cfg = Config(IMAGE_SIZE=64, IMAGE_DEPTH=8)
    meta = np.tile(default_meta(cfg)[None], (2, 1))
    feats = _pyramid(rng, 2, 6)
    boxes = _random_boxes(rng, (30,), (-0.1, 0.8), (0.0, 0.6))
    boxes[3] = [0.3] * 6                       # degenerate
    boxes[4] = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]  # the whole image
    boxes[5] = [np.nan] * 6                    # scrubbed to zeros
    bidx = rng.randint(0, 2, 30).astype(np.int32)
    for p in (7, 3):
        ref = np.asarray(pyramid_roi_align_flat(boxes, bidx, meta, feats, p))
        got = TR.pyramid_roi_align_flat(T(boxes), T(bidx), T(meta),
                                        [T(f) for f in feats], p).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _compact_inputs(rng, c, counts, n_per):
    """Compacted flat list: live rows image-major first, then padding rows
    (zero boxes with arbitrary image indices)."""
    cfg = Config(IMAGE_SIZE=64, IMAGE_DEPTH=16)
    b = len(counts)
    meta = np.tile(default_meta(cfg)[None], (b, 1))
    feats = _pyramid(rng, b, c, depth=16)
    n = b * n_per
    boxes_f = np.zeros((n, 6), np.float32)
    batch_f = rng.randint(0, b, n).astype(np.int32)
    r = 0
    for img, cnt in enumerate(counts):
        boxes_f[r:r + cnt] = _random_boxes(rng, (cnt,), (0.0, 0.5),
                                           (0.05, 0.5))
        batch_f[r:r + cnt] = img
        r += cnt
    return boxes_f, batch_f, meta, feats


@pytest.mark.parametrize("total_kind", ["zero", "one", "mid", "all"])
def test_roialign_compact_matches_jax_gather(total_kind):
    rng = np.random.RandomState(6)
    counts = {"zero": [0, 0, 0], "one": [1, 0, 0], "mid": [3, 0, 2],
              "all": [4, 4, 4]}[total_kind]
    boxes_f, batch_f, meta, feats = _compact_inputs(rng, 8, counts, 4)
    total = sum(counts)
    ref = np.asarray(pyramid_roi_align_compact(boxes_f, batch_f, total, meta,
                                               feats, 14))
    got = TR.pyramid_roi_align_compact(
        T(boxes_f), T(batch_f), torch.tensor(total, dtype=torch.int32),
        T(meta), [T(f) for f in feats], 14).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (got[total:] == 0).all()


@pytest.mark.parametrize("total", [0, 1, 3, 6])
def test_roialign_compact_matches_pallas_interpret(total):
    """The port against m3d's compact Pallas kernel, run in interpret mode."""
    rng = np.random.RandomState(7)
    counts = [min(total, 3), 0, max(total - 3, 0)]
    boxes_f, batch_f, meta, feats = _compact_inputs(rng, 128, counts, 2)
    ref = np.asarray(pyramid_roi_align_compact(
        boxes_f, batch_f, total, meta, feats, 14, interpret=True))
    got = TR.pyramid_roi_align_compact(
        T(boxes_f), T(batch_f), torch.tensor(total, dtype=torch.int32),
        T(meta), [T(f) for f in feats], 14).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (got[total:] == 0).all()
