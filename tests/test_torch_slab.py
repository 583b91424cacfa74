"""m3d_torch's slab-contract ROIAlign entries against m3d's, the port in
float32 on the CPU (where every kernel wrapper runs its plain version):
slab weights and geometry, the padded gather entry, the padded kernel entry
(#3, ``_kernel_vmem``), the slab kernel entry (#4, ``_kernel``) with its
``bounds`` edge cases and the span-tiered branch, and the fused
ROIAlign + FC (#2/#5, ``_kernel_slab_fc_kron`` / ``_kernel_slab_fc``) with
its fit/fallback split. JAX's Pallas entries run in interpret mode.
"""

import numpy as np
import pytest
import torch

from m3d.config import Config
from m3d.image_meta import default_meta
from m3d.ops import roialign3d as JR
from m3d.ops.conv3d import conv3d_fc as j_conv3d_fc
from m3d.ops.pallas_roialign import pallas_pyramid_roi_align
from m3d_torch.ops import roialign3d as TR
from m3d_torch.ops import roialign_compact as TC
from m3d_torch.ops import roialign_fc as TF
from m3d_torch.ops import roialign_slab as TS
from m3d_torch.ops.conv3d import conv3d_fc

T = torch.from_numpy
# Float32 on both sides; the slab entries sum in another order than the
# gather (three contractions vs eight corner products): a few ulps of the
# O(10) pooled values.
ATOL = 1e-5


def _case(rng, c, n, b=2, depth=16, f=None):
    cfg = Config(IMAGE_SIZE=64, IMAGE_DEPTH=depth, NUM_CLASSES=2)
    meta = np.tile(default_meta(cfg)[None], (b, 1))
    feats = [rng.randn(b, 16, 16, depth, c).astype(np.float32),
             rng.randn(b, 8, 8, depth, c).astype(np.float32),
             rng.randn(b, 4, 4, max(depth // 2, 1), c).astype(np.float32),
             rng.randn(b, 2, 2, max(depth // 4, 1), c).astype(np.float32)]
    lo = rng.uniform(-0.1, 0.6, (b, n, 3)).astype(np.float32)
    ext = rng.uniform(0.0, 0.9, (b, n, 3)).astype(np.float32)
    boxes = np.clip(np.concatenate([lo, lo + ext], -1), 0, 1)
    boxes[0, 1] = [0.3] * 6                     # degenerate
    boxes[-1, -1] = 0.0                         # a zero (padding) slot
    kern = None
    if f:
        kern = (rng.randn(7, 7, 7, c, f) * 0.01).astype(np.float32)
    return boxes, meta, feats, kern


def _tfeats(feats):
    return [T(f) for f in feats]


def _torch_weight(kern):
    """flax conv kernel [ky, kx, kz, C, F] -> torch [F, C, ky, kx, kz]."""
    return T(np.ascontiguousarray(kern.transpose(4, 3, 0, 1, 2)))


def test_axis_slab_weights_and_geometry_match_jax():
    rng = np.random.RandomState(0)
    n, p = 40, 7
    dim = rng.randint(1, 33, n).astype(np.float32)
    lo = rng.uniform(-0.2, 0.9, n).astype(np.float32)
    hi = lo + rng.uniform(0, 0.8, n).astype(np.float32)
    pos = np.asarray(JR._axis_positions(lo, hi, dim, p))
    for slab, align, odim in [(16, 1, None), (8, 1, None), (24, 8, 32.0),
                              (32, 8, 40.0), (32, 1, 32.0)]:
        od = None if odim is None else np.full(n, odim, np.float32)
        jo, jw = JR._axis_slab_weights(pos, dim, slab, align=align,
                                       origin_dim=od)
        to, tw = TR.axis_slab_weights(T(pos), T(dim), slab, align=align,
                                      origin_dim=None if od is None
                                      else T(od))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-7)
    _, _, feats, _ = _case(rng, 4, 3, depth=64)
    assert TR.slab_sizes(_tfeats(feats)) == JR.slab_sizes(feats)


def test_padded_gather_matches_jax():
    rng = np.random.RandomState(1)
    boxes, meta, feats, _ = _case(rng, 6, 9)
    boxes[1, 2] = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    ref = np.asarray(JR.pyramid_roi_align(boxes, meta, feats, 7))
    got = TR.pyramid_roi_align(T(boxes), T(meta), _tfeats(feats), 7)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_padded_kernel_entry_matches_pallas_interpret():
    """#3: pyramid_roi_align_pallas (slab=None) against JAX's VMEM branch
    in interpret mode; on the CPU the padded wrapper runs its plain
    version, and counts no launch."""
    rng = np.random.RandomState(2)
    boxes, meta, feats, _ = _case(rng, 128, 6)
    ref = np.asarray(JR.pyramid_roi_align_pallas(boxes, meta, feats, 14,
                                                 interpret=True))
    before = TC.PADDED.launches
    got = TR.pyramid_roi_align_pallas(T(boxes), T(meta), _tfeats(feats), 14)
    assert TC.PADDED.launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # The CPU route of the auto dispatch is the padded gather: same function.
    auto = TR.pyramid_roi_align_auto(T(boxes), T(meta), _tfeats(feats), 14)
    np.testing.assert_allclose(auto.numpy(), ref, rtol=0, atol=ATOL)


def _slab_inputs(rng, n=12, c=128, slab=(16, 16, 16), random_weights=False):
    """The slab contract's inputs (routing from random boxes, weights from
    axis_slab_weights or random) and JAX's zero-padded levels."""
    boxes, meta, feats, _ = _case(rng, c, n // 2)
    tf = _tfeats(feats)
    boxes_f, levels, batch = TR._flat_rows(T(boxes), T(meta), 4)
    (sy, sx, sz), pdims_lut = TR._slab_geometry(tf, slab)
    rd, pos = TR._level_positions(boxes_f, levels, tf, 7)
    origins, wy, wx, wz = TR._slab_weights(pos, rd, pdims_lut[levels.long()],
                                           (sy, sx, sz))
    if random_weights:
        wy, wx, wz = (T(rng.randn(*w.shape).astype(np.float32)
                        * (rng.uniform(size=w.shape) < 0.3))
                      for w in (wy, wx, wz))
    padded = [np.pad(f, [(0, 0)] + [(0, int(pd) - s) for pd, s in
                                    zip(pdims_lut[i].tolist(), f.shape[1:4])]
                     + [(0, 0)]) for i, f in enumerate(feats)]
    return (levels, batch, origins, wy, wx, wz, tf), padded, (sy, sx, sz)


@pytest.mark.parametrize("bounds", [(0, 0), (0, 1), (0, 12), (5, 4),
                                    (11, 1), ("random", 12)])
def test_slab_entry_matches_pallas_interpret(bounds):
    """#4: the slab wrapper (plain version on the CPU) against JAX's
    pallas_pyramid_roi_align in interpret mode, on the same origins and
    weights; JAX reads zero-padded levels, the port the unpadded ones. Rows
    outside bounds are zero in the port (unwritten on the TPU)."""
    rng = np.random.RandomState(3)
    rand = bounds[0] == "random"
    bounds = (0, 12) if rand else bounds
    args, padded, slab = _slab_inputs(rng, random_weights=rand)
    levels, batch, origins, wy, wx, wz, tf = args
    tb = torch.tensor(bounds, dtype=torch.int32)
    ref = np.asarray(pallas_pyramid_roi_align(
        levels.numpy(), batch.numpy(), origins.numpy(), wy.numpy(),
        wx.numpy(), wz.numpy(), padded, 7, slab=slab, interpret=True,
        bounds=np.asarray(bounds, np.int32)))
    before = TS.KERNEL.launches
    got = TS.roialign_slab(*args, tb).numpy()
    assert TS.KERNEL.launches == before
    lo, hi = bounds[0], bounds[0] + bounds[1]
    np.testing.assert_allclose(got[lo:hi], ref[lo:hi], rtol=0,
                               atol=ATOL * (10 if rand else 1))
    assert (got[:lo] == 0).all() and (got[hi:] == 0).all()
    # Levels given zero-padded, as the TPU entry takes them: same result.
    got_p = TS.roialign_slab(*args[:6], _tfeats(padded), tb).numpy()
    np.testing.assert_allclose(got_p, got, rtol=0, atol=1e-6)


def test_tiered_slab_branch_matches_jax():
    """The span-tiered branch (explicit slab) against JAX's, interpret."""
    rng = np.random.RandomState(4)
    boxes, meta, feats, _ = _case(rng, 128, 8)
    ref = np.asarray(JR.pyramid_roi_align_pallas(
        boxes, meta, feats, 7, slab=(16, 16, 16), interpret=True))
    got = TR.pyramid_roi_align_pallas(T(boxes), T(meta), _tfeats(feats), 7,
                                      slab=(16, 16, 16))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    gather = np.asarray(JR.pyramid_roi_align(boxes, meta, feats, 7))
    np.testing.assert_allclose(got.numpy(), gather, rtol=0, atol=ATOL)


def test_conv3d_fc_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(5, 3, 3, 3, 4).astype(np.float32)
    kern = rng.randn(3, 3, 3, 4, 6).astype(np.float32)
    ref = np.asarray(j_conv3d_fc(x, kern, preferred_element_type=np.float32))
    got = conv3d_fc(T(x), _torch_weight(kern), out_dtype=torch.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def fc_case():
    rng = np.random.RandomState(6)
    boxes, meta, feats, kern = _case(rng, 128, 16, f=16)
    pooled = JR.pyramid_roi_align(boxes, meta, feats, 7)
    ref = np.asarray(j_conv3d_fc(
        np.asarray(pooled).reshape(-1, 7, 7, 7, 128), kern,
        preferred_element_type=np.float32)).reshape(2, 16, 16)
    return boxes, meta, feats, kern, ref


def _assert_fc_close(got, ref):
    # float32 both sides over K = 7^3 * 128 products; relative to the
    # largest output.
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=2e-5)


@pytest.mark.parametrize("kernel", ["kron", "separable"])
def test_fused_fc_matches_gather_and_conv3d_fc(fc_case, kernel):
    boxes, meta, feats, kern, ref = fc_case
    before = TF.KERNEL.launches
    got = TR.pyramid_roi_align_fc(T(boxes), T(meta), _tfeats(feats), 7,
                                  _torch_weight(kern), kernel=kernel)
    assert TF.KERNEL.launches == before and got.dtype == torch.float32
    _assert_fc_close(got.numpy(), ref)


def test_fused_fc_matches_kron_interpret(fc_case):
    """#2/#5 against JAX's fused entry with the kron kernel, interpret."""
    boxes, meta, feats, kern, _ = fc_case
    ref = np.asarray(JR.pyramid_roi_align_fc(boxes, meta, feats, 7, kern,
                                             interpret=True, kernel="kron"))
    got = TR.pyramid_roi_align_fc(T(boxes), T(meta), _tfeats(feats), 7,
                                  _torch_weight(kern), kernel="kron")
    _assert_fc_close(got.numpy(), ref)


@pytest.mark.parametrize("cap", [(8, 8, 16), (12, 12, 16)])
def test_fit_fallback_split_matches_gather(fc_case, cap, monkeypatch):
    """A small fc_slab_cap sends most rows through the slab kernel and
    conv3d_fc; both parts carry rows, and the combined, un-sorted result is
    the gather + conv3d_fc function."""
    boxes, meta, feats, kern, ref = fc_case
    seen = {}
    real_fc, real_slab = TR.roialign_fc, TR.roialign_slab

    def spy_fc(*a):
        seen["fc"] = a[-1].tolist()
        return real_fc(*a)

    def spy_slab(*a):
        seen["slab"] = a[-1].tolist()
        return real_slab(*a)

    monkeypatch.setattr(TR, "roialign_fc", spy_fc)
    monkeypatch.setattr(TR, "roialign_slab", spy_slab)
    got = TR.pyramid_roi_align_fc(T(boxes), T(meta), _tfeats(feats), 7,
                                  _torch_weight(kern), fc_slab_cap=cap)
    n_fit = seen["fc"][1]
    assert seen["fc"][0] == 0 and 0 < n_fit < 32, n_fit
    assert seen["slab"] == [n_fit, 32 - n_fit]
    _assert_fc_close(got.numpy(), ref)
    flat = TR.pyramid_roi_align_fc_flat(
        T(boxes.reshape(-1, 6)), torch.arange(2).repeat_interleave(16),
        T(meta), _tfeats(feats), 7, _torch_weight(kern), fc_slab_cap=cap)
    _assert_fc_close(flat.numpy(), ref.reshape(32, -1))


def test_fc_wrapper_bounds_and_weight_order():
    """roialign_fc on the slab contract: rows outside bounds are zero, rows
    inside equal the slab rows times the K-ordered weight (the layout the
    pooled [p, p, p, C] row flattens in)."""
    rng = np.random.RandomState(7)
    args, _, _ = _slab_inputs(rng, c=8)
    w = T(rng.randn(5, 8, 7, 7, 7).astype(np.float32))
    wk = TF.conv1_weight_fk(w, torch.float32)
    bounds = torch.tensor([3, 6], dtype=torch.int32)
    got = TF.roialign_fc(*args, wk, bounds)
    pooled = TS.roialign_slab(*args, bounds)
    ref = conv3d_fc(pooled, w, out_dtype=torch.float32).reshape(12, 5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (got[:3] == 0).all() and (got[9:] == 0).all()
    assert got[3:9].abs().sum() > 0


def _shape_pyramid(shapes):
    """Levels of the given (H, W, D) extents; only their shapes are read."""
    return [torch.zeros(1, *s, 1) for s in shapes]


BENCH_LEVELS = [(32, 32, 32), (16, 16, 16), (8, 8, 8), (4, 4, 4)]
# z-stride-1 pyramid whose depth is no multiple of 8: the exact-coverage
# slab is (32, 32, 40) and the levels are padded in z to place origins.
ANISO_LEVELS = [(32, 32, 36), (16, 16, 36), (8, 8, 36), (4, 4, 36)]


@pytest.mark.parametrize("levels_shape,tier", [
    (BENCH_LEVELS, (8, 8, 16)), (BENCH_LEVELS, (16, 16, 24)),
    (BENCH_LEVELS, (32, 32, 32)), (ANISO_LEVELS, None)])
def test_slab_weights_have_at_most_two_taps_at_i0_i1(levels_shape, tier):
    """The slab kernel's fast path rests on this: for random boxes on all
    four levels, every (row, axis, sample) of the weights the slab callers
    make (_slab_weights at a tier size, or at the exact-coverage slab) has
    at most 2 nonzero taps inside the level, at columns i0 and
    i1 = min(i0 + 1, slab - 1, dim - 1 - origin) of the clamped position;
    weights and origins are JAX's _axis_slab_weights'."""
    rng = np.random.RandomState(21)
    n = 400
    fms = _shape_pyramid(levels_shape)
    lo = rng.uniform(-0.2, 0.9, (n, 3)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.uniform(0.0, 1.0, (n, 3))
                            .astype(np.float32)], 1)
    boxes[: n // 2] = boxes[: n // 2].clip(0.0, 1.0)  # samples on 0 and dim-1
    boxes = T(boxes)
    levels = T((np.arange(n) % 4).astype(np.int32))
    slab, pdims_lut = TR._slab_geometry(fms)
    tier = slab if tier is None else tier
    pdims = pdims_lut[levels.long()]
    rd, pos = TR._level_positions(boxes, levels, fms, 7)
    origins, *ws = TR._slab_weights(pos, rd, pdims, tier)
    for a, w in enumerate(ws):
        dim = rd[:, a].float()
        jo, jw = JR._axis_slab_weights(
            pos[a].numpy(), dim.numpy(), tier[a], align=8 if a == 2 else 1,
            origin_dim=pdims[:, a].float().numpy())
        np.testing.assert_array_equal(origins[:, a].numpy(), np.asarray(jo))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)
        org = origins[:, a].float()[:, None]
        coords = org[..., None] + torch.arange(tier[a]).float()
        kept = (w != 0) & (coords >= 0) & (coords < dim[:, None, None])
        assert int(kept.sum(-1).max()) <= 2
        pc = torch.minimum(pos[a].clamp_min(0.0), dim[:, None] - 1.0)
        i0 = torch.floor((pc - org).clamp(0.0, tier[a] - 1.0))
        i1 = torch.minimum(i0 + 1.0, torch.clamp_max(
            dim[:, None] - 1.0 - org, float(tier[a] - 1)))
        cols = torch.arange(tier[a]).float()
        at_taps = (cols == i0[..., None]) | (cols == i1[..., None])
        assert not (kept & ~at_taps).any()
        # Some positions use both taps, some one (a sample on a voxel, or
        # at the level's last voxel), some none (outside the level).
        per = kept.sum(-1)
        assert (per == 2).any() and (per == 1).any() and (per == 0).any()
