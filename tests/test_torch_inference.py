"""m3d_torch's assembled Mask R-CNN and adaptive inference against m3d's at
a tiny config (64 x 64 x 8, narrow widths), JAX with COMPUTE_DTYPE float32 and
the port in float32 on the CPU; plus the bench-shape run on the tracked
checkpoint (slow).
"""

import os

import jax
import numpy as np
import pytest
import torch

from m3d.anchors import normalized_pyramid_anchors
from m3d.config import Config
from m3d.image_meta import default_meta
from m3d.models import inference as J_inf
from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
from m3d.models.mask_rcnn import init_params
from m3d_torch.checkpoints import load_params
from m3d_torch.config import Config as TConfig
from m3d_torch.models import inference as T_inf
from m3d_torch.models.mask_rcnn import MaskRCNN
from m3d_torch.ops import roialign_compact as TC
from test_torch_models import (CLOSE, F32, TINY, T, assert_close, port,
                               randomize)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_models():
    cfg, tcfg = Config(**TINY), TConfig(**TINY)
    jm = JMaskRCNN.from_config(cfg, mode="inference")
    v = randomize(init_params(jm, jax.random.PRNGKey(0)), 13)
    tm = port(MaskRCNN.from_config(tcfg, device="cpu"), v)
    image = np.random.RandomState(3).randn(2, 64, 64, 8, 1).astype(np.float32)
    meta = np.tile(default_meta(cfg)[None], (2, 1))
    anchors = normalized_pyramid_anchors(cfg)
    return jm, v, tm, image, meta, anchors


@torch.no_grad()
def test_mask_rcnn_stages_match_jax(tiny_models):
    jm, v, tm, image, meta, anchors = tiny_models
    feats = jm.apply(v, image, method=JMaskRCNN.extract_features)
    tfeats = tm.extract_features(T(image))
    for g, r in zip(tfeats, feats):
        assert_close(g, r)
    rpn = jm.apply(v, list(feats), method=JMaskRCNN.rpn_forward)
    trpn = tm.rpn_forward([T(np.array(f)) for f in feats])
    for g, r in zip(trpn, rpn):
        assert_close(g, r)
    # From here on both sides start from JAX's tensors.
    props, pvalid = jm.apply(v, rpn[1], rpn[2], anchors,
                             method=JMaskRCNN.propose)
    tprops, tpvalid = tm.propose(T(np.array(rpn[1])),
                                 T(np.array(rpn[2])), T(anchors))
    np.testing.assert_array_equal(tpvalid.numpy(), np.asarray(pvalid))
    assert_close(tprops, props, atol=1e-6)
    mf = [np.array(f) for f in feats[:4]]
    boxes = np.array(props).reshape(-1, 6)[:40]
    bidx = np.repeat(np.arange(2, dtype=np.int32), 64)[:40]
    cls = jm.apply(v, boxes, bidx, meta, mf,
                   method=JMaskRCNN.classify_rois_flat)
    tcls = tm.classify_rois_flat(T(boxes), T(bidx), T(meta),
                                 [T(f) for f in mf])
    for g, r in zip(tcls, cls):
        assert_close(g, r)
    aligned = jm.apply(v, boxes[:12], bidx[:12], 9, meta, mf,
                       method=JMaskRCNN.mask_align_compact)
    taligned = tm.mask_align_compact(T(boxes[:12]), T(bidx[:12]),
                                     torch.tensor(9, dtype=torch.int32),
                                     T(meta), [T(f) for f in mf])
    assert_close(taligned, aligned, atol=1e-5)
    masks = jm.apply(v, np.asarray(aligned)[None],
                     method=JMaskRCNN.apply_mask_head)
    assert_close(tm.apply_mask_head(taligned[None]), masks, atol=1e-5)


def _run_both(tiny_models, cls_chunk, mask_chunk, **model_kw):
    jm, v, tm, image, meta, anchors = tiny_models
    jm = jm.clone(**model_kw)
    ref = jax.device_get(jax.jit(lambda vv, img: J_inf.adaptive_inference(
        jm, vv, img, meta, anchors, classifier_chunk=cls_chunk,
        mask_chunk=mask_chunk))(v, image))
    saved = {k: getattr(tm, k) for k in model_kw}
    launches = TC.KERNEL.launches
    try:
        for k, val in model_kw.items():
            setattr(tm, k, val)
        got = T_inf.adaptive_inference(tm, image, meta, anchors,
                                       classifier_chunk=cls_chunk,
                                       mask_chunk=mask_chunk, device="cpu")
    finally:
        for k, val in saved.items():
            setattr(tm, k, val)
    assert TC.KERNEL.launches == launches    # CPU: the plain version
    return ref, got


@pytest.mark.parametrize("cls_chunk,mask_chunk", [(16, 4), (24, 3)])
def test_adaptive_inference_matches_jax(tiny_models, cls_chunk, mask_chunk):
    """The whole tiny adaptive path. Tolerance 1e-4: float32 both sides,
    differing only in summation order through a ResNet-50 trunk.

    One exemption, from the reference's own sampling rule: a sample whose
    position lies past size - 1 is zero, and a proposal clipped to the far
    border (a coordinate == 1.0) puts its last samples at size - 1 up to one
    ulp, so a 1e-7 difference in the proposal can zero a whole plane of its
    pooled features. Classifier outputs of such slots may differ; at most
    1 in 50 live proposal slots may, and every other output is held to 1e-4.
    """
    ref, got = _run_both(tiny_models, cls_chunk, mask_chunk)
    assert set(got) == set(ref)
    live = np.asarray(ref["detections_valid"])
    pvalid = np.asarray(ref["proposals_valid"])
    assert live.sum() > 0 and pvalid.sum() > 0
    np.testing.assert_array_equal(got["detections_valid"].numpy(), live)
    np.testing.assert_array_equal(got["proposals_valid"].numpy(), pvalid)
    for k in ("detections", "proposals", "mrcnn_masks"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **CLOSE)
    on_border = (np.asarray(ref["proposals"])[..., 3:] == 1.0).any(-1)
    off = np.zeros_like(pvalid)
    for k in ("mrcnn_probs", "mrcnn_bbox"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        bad = ~np.isclose(g, r, **CLOSE)
        off |= bad.reshape(bad.shape[:2] + (-1,)).any(-1)
    assert not (off & ~on_border).any(), np.argwhere(off & ~on_border)
    assert off.sum() <= pvalid.sum() / 50, off.sum()


def test_adaptive_inference_no_detections(tiny_models):
    ref, got = _run_both(tiny_models, 16, 4, detection_min_confidence=1.01)
    assert not got["detections_valid"].any()
    assert (got["mrcnn_masks"] == 0).all()
    np.testing.assert_array_equal(got["mrcnn_masks"].numpy(),
                                  np.asarray(ref["mrcnn_masks"]))


def test_chunked_roi_stage_zero_fills_skipped_chunks():
    x = torch.arange(2 * 10, dtype=F32).reshape(2, 10, 1) + 1
    out = T_inf.chunked_roi_stage(lambda c: (c * 2, c[..., 0]), x, 4, 3)
    assert out[0].shape == (2, 10, 1) and out[1].shape == (2, 10)
    np.testing.assert_array_equal(out[0][:, :6].numpy(), x[:, :6].numpy() * 2)
    assert (out[0][:, 6:] == 0).all() and (out[1][:, 6:] == 0).all()
    whole = T_inf.chunked_roi_stage(lambda c: (c + 1,), x, 0, 20)
    np.testing.assert_array_equal(whole[0].numpy(), x.numpy() + 1)
    none = T_inf.chunked_roi_stage(lambda c: (c + 1,), x, 0, 3)
    assert none[0].shape == x.shape and (none[0] == 0).all()


def test_default_chunks_match_jax(tiny_models):
    jm, v, tm, *_ = tiny_models
    bench_kw = dict(post_nms_rois=500, detection_max_instances=50)
    assert T_inf.default_chunks(tm) == J_inf.default_chunks(jm)
    for k, val in bench_kw.items():
        setattr(tm, k, val)
    try:
        assert T_inf.default_chunks(tm) == J_inf.default_chunks(
            jm.clone(**bench_kw)) == (125, 40)
    finally:
        tm.post_nms_rois, tm.detection_max_instances = 64, 8


@pytest.mark.slow
def test_bench_shape_matches_jax_on_tracked_checkpoint():
    """bench.py's workload (128^3, batch 4, tracked checkpoint, seeds
    1000+i) through both packages in float32 on the CPU."""
    import bench

    kw = dict(IMAGE_SIZE=128, IMAGE_DEPTH=128,
              BACKBONE_STRIDES=[(4, 4, 4), (8, 8, 8), (16, 16, 16),
                                (32, 32, 32), (64, 64, 64)],
              RPN_ANCHOR_SCALES=(16, 24, 32, 48, 64),
              RPN_ANCHOR_RATIOS=[0.75, 1.0, 1.33], PRE_NMS_LIMIT=6000,
              POST_NMS_ROIS_INFERENCE=500, DETECTION_MAX_INSTANCES=50,
              FPN_CLASSIF_FC_LAYERS_SIZE=512, COMPUTE_DTYPE="float32")
    cfg = Config(**kw)
    jm = JMaskRCNN.from_config(cfg, mode="inference")
    tree, _ = load_params(os.path.join(REPO, "weights",
                                       "bench_ckpt.f16.msgpack"))
    from m3d.train.checkpoints import restore_by_name as j_restore

    v, _ = j_restore(init_params(jm, jax.random.PRNGKey(0)), tree)
    tm = port(MaskRCNN.from_config(TConfig(**kw), device="cpu"), tree)
    image, gt = bench.make_volumes(4, 128)
    meta = np.tile(default_meta(cfg)[None], (4, 1))
    anchors = normalized_pyramid_anchors(cfg)
    chunks = J_inf.default_chunks(jm)
    ref = jax.device_get(jax.jit(lambda vv, img: J_inf.adaptive_inference(
        jm, vv, img, meta, anchors, classifier_chunk=chunks[0],
        mask_chunk=chunks[1]))(v, image))
    got = T_inf.adaptive_inference(tm, image, meta, anchors,
                                   classifier_chunk=chunks[0],
                                   mask_chunk=chunks[1], device="cpu")
    np.testing.assert_array_equal(got["detections_valid"].numpy(),
                                  np.asarray(ref["detections_valid"]))
    np.testing.assert_allclose(got["detections"].numpy(),
                               np.asarray(ref["detections"]), rtol=1e-3,
                               atol=1e-3)
