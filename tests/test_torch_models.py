"""m3d_torch model modules against m3d's, JAX with COMPUTE_DTYPE float32 and
the port in float32 on the CPU: backbone, FPN, RPN head, classifier and mask
heads (with the transposed-conv kernel mapping), proposals and detections.
Weights are flax's, randomized from a numpy seed and converted by
params_from_jax. The assembled model is in test_torch_inference.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from m3d.anchors import normalized_pyramid_anchors
from m3d.config import Config
from m3d.image_meta import default_meta
from m3d.models.backbone import ResNet3D as JResNet3D
from m3d.models.detection import refine_detections_batch as j_refine
from m3d.models.fpn import FPN3D as JFPN3D
from m3d.models.heads import ClassifierHead as JClassifierHead
from m3d.models.heads import MaskHead as JMaskHead
from m3d.models.proposal import generate_proposals as j_proposals
from m3d.models.rpn_head import RPNHead as JRPNHead
from m3d_torch.checkpoints import params_from_jax, restore_by_name
from m3d_torch.models.backbone import ResNet3D
from m3d_torch.models.detection import refine_detections_batch
from m3d_torch.models.fpn import FPN3D
from m3d_torch.models.heads import ClassifierHead, ConvTranspose, MaskHead
from m3d_torch.models.proposal import generate_proposals, top_k_stable

T = torch.from_numpy
F32 = torch.float32
# Float32 on both sides; sums run in another order (XLA vs oneDNN), so the
# deep trunk carries ~1e-5 relative error.
CLOSE = dict(rtol=1e-4, atol=1e-4)

TINY = dict(
    IMAGE_SIZE=64, IMAGE_DEPTH=8, NUM_CLASSES=2,
    BACKBONE_STRIDES=[(4, 4, 1), (8, 8, 1), (16, 16, 1), (32, 32, 1),
                      (64, 64, 1)],
    RPN_ANCHOR_SCALES=(8, 16, 24, 32, 48), RPN_ANCHOR_RATIOS=[0.5, 1.0],
    PRE_NMS_LIMIT=512, POST_NMS_ROIS_INFERENCE=64, DETECTION_MAX_INSTANCES=8,
    DETECTION_MIN_CONFIDENCE=0.0, FPN_CLASSIF_FC_LAYERS_SIZE=64,
    HEAD_CONV_CHANNEL=32, TOP_DOWN_PYRAMID_SIZE=32, COMPUTE_DTYPE="float32")


def randomize(variables, seed):
    """Replace every leaf with seeded random values of a sane scale
    (kernels ~ 1/sqrt(fan_in), positive BN variances)."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.device_get(variables))
    out = {}
    for k, v in sorted(flat.items()):
        v = np.asarray(v)
        name = k[-1]
        if name == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            new = rng.randn(*v.shape) / np.sqrt(fan_in)
        elif name in ("var", "scale"):
            new = rng.uniform(0.5, 1.5, v.shape)
        else:
            new = rng.randn(*v.shape) * 0.1
        out[k] = new.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def port(module, variables):
    stats = restore_by_name(module, params_from_jax(variables))
    assert stats["missing"] == 0 and stats["skipped"] == 0, stats
    return module.eval()


def assert_close(got, ref, **kw):
    tol = dict(CLOSE, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)


@torch.no_grad()
def test_backbone_matches_jax():
    strides = ((4, 4, 1), (8, 8, 1), (16, 16, 1), (32, 32, 1), (64, 64, 1))
    x = np.random.RandomState(0).randn(1, 64, 64, 8, 1).astype(np.float32)
    jm = JResNet3D("resnet50", dtype=jnp.float32, level_strides=strides)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 1)
    ref = jm.apply(v, x)
    got = port(ResNet3D("resnet50", F32, strides), v)(T(x))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        scale = float(np.abs(np.asarray(r)).max())
        assert_close(g / scale, np.asarray(r) / scale)


@torch.no_grad()
def test_fpn_and_rpn_head_match_jax():
    rng = np.random.RandomState(2)
    cs = [rng.randn(1, 16 // f, 16 // f, 8, ch).astype(np.float32)
          for f, ch in ((1, 256), (2, 512), (4, 1024), (8, 2048))]
    up = ((2, 2, 1),) * 3
    jf = JFPN3D(32, (2, 2, 1), jnp.float32, upsample_factors=up)
    vf = randomize(jf.init(jax.random.PRNGKey(0), *cs), 3)
    ref = jf.apply(vf, *cs)
    got = port(FPN3D(channels=32, p6_stride=(2, 2, 1), dtype=F32,
                     upsample_factors=up), vf)(*map(T, cs))
    for g, r in zip(got, ref):
        assert_close(g, r)

    from m3d_torch.models.rpn_head import RPNHead

    jr = JRPNHead(2, 1, jnp.float32)
    vr = randomize(jr.init(jax.random.PRNGKey(0), np.asarray(ref[0])), 4)
    tr = port(RPNHead(32, 2, 1, F32), vr)
    for lvl in ref:
        for g, r in zip(tr(T(np.array(lvl))), jr.apply(vr, lvl)):
            assert_close(g, r)


@torch.no_grad()
def test_classifier_head_matches_jax():
    x = np.random.RandomState(5).randn(2, 3, 7, 7, 7, 16).astype(np.float32)
    jm = JClassifierHead(7, 2, 24, dtype=jnp.float32)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 6)
    # Large logits exercise the +-10 clip.
    v["params"]["mrcnn_class_logits"]["kernel"] *= 40.0
    ref = jm.apply(v, x)
    got = port(ClassifierHead(16, 7, 2, 24, F32), v)(T(x))
    assert float(np.abs(np.asarray(ref[0])).max()) == 10.0
    for g, r in zip(got, ref):
        assert_close(g, r)


@torch.no_grad()
def test_deconv_kernel_mapping():
    """flax ConvTranspose(SAME, stride 2) computes out[2i+j] = x[i] W[1-j]:
    a one-hot flax kernel lands where the loader's spatial flip puts it."""
    import flax.linen as nn

    x = np.random.RandomState(8).randn(1, 3, 2, 4, 2).astype(np.float32)
    jm = nn.ConvTranspose(3, (2, 2, 2), strides=(2, 2, 2), dtype=jnp.float32,
                          name="mrcnn_mask_deconv")
    for tap in [(0, 0, 0), (1, 0, 1), (0, 1, 1), (1, 1, 0)]:
        kernel = np.zeros((2, 2, 2, 2, 3), np.float32)
        kernel[tap] = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
        bias = np.zeros(3, np.float32)
        v = {"params": {"mrcnn_mask_deconv": {"kernel": kernel,
                                              "bias": bias}}}
        ref = np.asarray(jm.apply({"params": v["params"]["mrcnn_mask_deconv"]},
                                  x))
        tm = ConvTranspose(2, 3, (2, 2, 2), F32)
        sd = params_from_jax(v)
        tm.weight.copy_(sd["mrcnn_mask_deconv.weight"])
        got = tm(T(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        ys, xs, zs = (1 - t for t in tap)  # the output parity it writes
        assert np.abs(ref[:, ys::2, xs::2, zs::2]).sum() > 0


@torch.no_grad()
def test_mask_head_matches_jax():
    x = np.random.RandomState(9).randn(1, 3, 6, 6, 6, 16).astype(np.float32)
    jm = JMaskHead(2, 8, dtype=jnp.float32)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 10)
    ref = jm.apply(v, x)
    got = port(MaskHead(16, 2, 8, F32), v)(T(x))
    assert got.shape == ref.shape == (1, 3, 12, 12, 12, 2)
    assert_close(got, ref, atol=1e-5)


def _rpn_outputs(rng, b, a, tie_levels=None):
    logits = rng.randn(b, a, 2).astype(np.float32)
    if tie_levels:   # few distinct fg scores: ties everywhere
        logits[..., 1] = np.round(logits[..., 1] * tie_levels) / tie_levels
        logits[..., 0] = 0.0
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    deltas = (rng.randn(b, a, 6) * 0.5).astype(np.float32)
    return probs, deltas


@pytest.mark.parametrize("tie_levels", [None, 2])
def test_proposals_match_jax(tie_levels):
    cfg = Config(**TINY)
    anchors = normalized_pyramid_anchors(cfg)
    probs, deltas = _rpn_outputs(np.random.RandomState(11), 2,
                                 anchors.shape[0], tie_levels)
    std = np.asarray(cfg.RPN_BBOX_STD_DEV)
    ref = j_proposals(probs, deltas, anchors, std, proposal_count=64,
                      nms_threshold=0.5, pre_nms_limit=300, image_depth=8)
    got = generate_proposals(T(probs), T(deltas), T(anchors), std, 64, 0.5,
                             300, 8)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)


def test_top_k_ties_lower_index_first():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    vals, idx = top_k_stable(scores, 4)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(idx.numpy(), [[1, 3, 0, 2]])


@pytest.mark.parametrize("xy_only", [False, True])
def test_detections_match_jax(xy_only):
    rng = np.random.RandomState(12)
    cfg = Config(**TINY)
    b, r = 2, 40
    lo = rng.uniform(0, 0.6, (b, r, 3))
    rois = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (b, r, 3))],
                          -1).astype(np.float32)
    rois[:, 30:] = 0.0                          # zero-padded proposal slots
    logits = rng.randn(b, r, 2).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    deltas = (rng.randn(b, r, 2, 6) * 0.3).astype(np.float32)
    meta = np.tile(default_meta(cfg)[None], (b, 1))
    args = (cfg.BBOX_STD_DEV, 0.3, 0.3, 8)
    ref = j_refine(rois, probs, deltas, meta, *args, nms_xy_only=xy_only)
    got = refine_detections_batch(T(rois), T(probs), T(deltas), T(meta),
                                  *args, nms_xy_only=xy_only)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.asarray(ref[1]).sum() > 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-6)
