"""m3d_torch's monolithic inference graph against m3d's at the tiny config of
test_torch_inference.py, JAX with COMPUTE_DTYPE float32 and the port in
float32 on the CPU: ``MaskRCNN.forward`` against JAX ``MaskRCNN.__call__``,
``adaptive_inference`` with a stage's chunk None, and the two monolithic
stages on their own (the classifier's fused ROIAlign + FC path pins conv1's
K order against JAX's gather + conv1).

Off the TPU, JAX's ``classify_rois`` takes the gather path and runs conv1
itself, while the port's takes the fused entry (its plain version on the
CPU): the comparison holds the port's fused path to JAX's unfused one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3d.anchors import normalized_pyramid_anchors
from m3d.config import Config
from m3d.image_meta import default_meta
from m3d.models import inference as J_inf
from m3d.models.heads import ClassifierHead as JClassifierHead
from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
from m3d.models.mask_rcnn import init_params
from m3d.ops.conv3d import conv3d_fc as j_conv3d_fc
from m3d_torch.config import Config as TConfig
from m3d_torch.models import inference as T_inf
from m3d_torch.models.heads import ClassifierHead
from m3d_torch.models.mask_rcnn import MaskRCNN
from m3d_torch.ops import roialign3d as TR
from m3d_torch.ops import roialign_compact as TC
from m3d_torch.ops import roialign_fc as TF
from m3d_torch.ops import roialign_slab as TS
from test_torch_models import (CLOSE, F32, TINY, T, assert_close, port,
                               randomize)


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


def _launches():
    return (TC.KERNEL.launches, TC.PADDED.launches, TF.KERNEL.launches,
            TS.KERNEL.launches)


def _assert_outputs_match(ref, got):
    """Every output to 1e-4 (float32 both sides, other summation order),
    with test_adaptive_inference_matches_jax's one exemption: classifier
    outputs of proposals clipped to the far border, where the reference's
    own sampling rule flips on one ulp (at most 1 in 50 live slots)."""
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


def test_monolithic_forward_matches_jax(tiny_models):
    jm, v, tm, image, meta, anchors = tiny_models
    ref = jax.device_get(jax.jit(
        lambda vv, img: jm.apply(vv, img, meta, anchors))(v, image))
    feats = [torch.zeros(1, 2, 2, 2, 32)] * 4
    assert TR.fused_classifier_ok(7, feats)     # the fused path runs here
    before = _launches()
    got = tm.forward(T(image), T(meta), T(anchors))
    assert _launches() == before                # CPU: plain versions only
    _assert_outputs_match(ref, got)


@pytest.mark.parametrize("cls_chunk,mask_chunk",
                         [(None, 4), (16, None), (None, None), (0, 0)])
def test_adaptive_with_monolithic_stage_matches_jax(tiny_models, cls_chunk,
                                                    mask_chunk):
    """A chunk of None/0 runs that stage monolithically, as in JAX."""
    jm, v, tm, image, meta, anchors = tiny_models
    ref = jax.device_get(jax.jit(lambda vv, img: J_inf.adaptive_inference(
        jm, vv, img, meta, anchors, classifier_chunk=cls_chunk,
        mask_chunk=mask_chunk))(v, image))
    got = T_inf.adaptive_inference(tm, image, meta, anchors,
                                   classifier_chunk=cls_chunk,
                                   mask_chunk=mask_chunk, device="cpu")
    _assert_outputs_match(ref, got)


@torch.no_grad()
def test_monolithic_stages_match_jax(tiny_models):
    """classify_rois (port: fused ROIAlign + FC with conv1 permuted into the
    kernel's K order; JAX on the CPU: gather + conv1) and mask_rois, on
    JAX's own features and proposals."""
    jm, v, tm, image, meta, anchors = tiny_models
    feats = jm.apply(v, image, method=JMaskRCNN.extract_features)
    rpn = jm.apply(v, list(feats), method=JMaskRCNN.rpn_forward)
    props, _ = jm.apply(v, rpn[1], rpn[2], anchors, method=JMaskRCNN.propose)
    mf = [np.asarray(f) for f in feats[:4]]
    props = np.asarray(props)
    cls = jm.apply(v, props, meta, mf, method=JMaskRCNN.classify_rois)
    tcls = tm.classify_rois(T(props), T(meta), [T(f) for f in mf])
    on_border = (props[..., 3:] == 1.0).any(-1)
    for g, r in zip(tcls, cls):
        g, r = g.numpy(), np.asarray(r)
        bad = ~np.isclose(g, r, **CLOSE)
        bad = bad.reshape(bad.shape[:2] + (-1,)).any(-1)
        assert not (bad & ~on_border).any()
    boxes = props[:, :8]
    masks = jm.apply(v, boxes, meta, mf, method=JMaskRCNN.mask_rois)
    assert_close(tm.mask_rois(T(boxes), T(meta), [T(f) for f in mf]), masks,
                 atol=1e-5)


@torch.no_grad()
def test_classifier_from_fc_matches_jax():
    """ClassifierHead(from_fc=True) on conv1's output plus bias: the port's
    fused path (pooled rows times conv1_weight_fk, bias added in float32)
    against JAX's (conv3d_fc with the flax kernel, bias, from_fc=True), and
    both against the head's own conv1."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 7, 7, 7, 16).astype(np.float32)
    jm = JClassifierHead(7, 2, 24, dtype=jnp.float32)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 6)
    cp = v["params"]["mrcnn_class_conv1"]
    fc = np.asarray(j_conv3d_fc(x.reshape(6, 7, 7, 7, 16), cp["kernel"],
                                preferred_element_type=jnp.float32))
    fc = fc.reshape(2, 3, 24) + cp["bias"]
    ref = jm.apply(v, fc, from_fc=True)
    th = port(ClassifierHead(16, 7, 2, 24, F32), v)
    conv = th.mrcnn_class_conv1
    wk = TF.conv1_weight_fk(conv.weight, torch.float32)
    tfc = (T(x).reshape(6, -1) @ wk.t()).reshape(2, 3, 24) + conv.bias
    got = th(tfc, from_fc=True)
    for g, r, whole in zip(got, ref, jm.apply(v, x)):
        assert_close(g, r)
        assert_close(g, whole)
