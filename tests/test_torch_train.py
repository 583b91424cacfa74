"""m3d_torch's training math against m3d's, on the CPU in float32, inputs
from seeded numpy RandomStates: the five losses (value, metrics and input
gradient against jax.grad), crop_and_resize_3d, minimize_mask, detection
targets with JAX's uniforms injected, RPN targets and augmentations (exact
under one seed), the optimiser chain against optax, MaxNorm constraints,
the LR and stopping callbacks, telemetry, the straight-through logit clip,
the initialiser distributions, and checkpoints both ways. Each tolerance
is stated where it is used; "exact" means equal arrays.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization, traverse_util

from m3d.config import Config
from m3d.data import augment as J_aug
from m3d.data import rpn_targets as J_rpn
from m3d.models import losses as J_L
from m3d.models.detection_targets import detection_targets_batch as j_dt
from m3d.models.heads import ClassifierHead as JClassifierHead
from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
from m3d.models.mask_rcnn import init_params as j_init_params
from m3d.ops.roialign3d import crop_and_resize_3d as j_crop
from m3d.train import checkpoints as J_ckpt
from m3d.train import optim as J_opt
from m3d.train.head import _is_frozen_for_e2e as j_frozen
from m3d.train.telemetry import Telemetry as JTelemetry
from m3d.utils.minimask import minimize_mask as j_minimize
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.config import Config as TConfig
from m3d_torch.data import augment as T_aug
from m3d_torch.data import rpn_targets as T_rpn
from m3d_torch.models import losses as T_L
from m3d_torch.models.detection_targets import detection_targets_batch
from m3d_torch.models.heads import ClassifierHead
from m3d_torch.models.mask_rcnn import MaskRCNN, TRUNC_STD, init_params
from m3d_torch.ops.roialign3d import crop_and_resize_3d
from m3d_torch.train import optim as T_opt
from m3d_torch.train.head import _is_frozen_for_e2e
from m3d_torch.train.telemetry import Telemetry
from m3d_torch.utils.minimask import minimize_mask
from test_torch_models import TINY, randomize
from test_torch_native import jax_native

T = torch.from_numpy


def _leaves(tree):
    return traverse_util.flatten_dict(jax.device_get(tree), sep="/")


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's init_params at TINY, jitted (the JAX model and its
    variables)."""
    jm = JMaskRCNN.from_config(Config(**TINY), mode="training")
    init = jax.jit(functools.partial(j_init_params, jm))
    return jm, jax.device_get(init(jax.random.PRNGKey(0)))


# Losses --------------------------------------------------------------------

def _loss_inputs(rng, b=2, t=12, c=3, a=300, m=6):
    match = rng.choice([-1, 0, 1], (b, a), p=[0.4, 0.5, 0.1]).astype(np.int32)
    match[1, :] = np.where(match[1] == 1, 0, match[1])     # no positive
    tcls = rng.randint(0, c, (b, t)).astype(np.int32)
    tcls[0, 0], tcls[1, :] = 5, 0           # out of range; all background
    tmask = (rng.uniform(size=(b, t, m, m, m)) > 0.6).astype(np.float32)
    tmask[0, 1] = 0.0                                      # empty target
    return {
        "rpn_match": match,
        "rpn_logits": (rng.randn(b, a, 2) * 3).astype(np.float32),
        "rpn_target": (rng.randn(b, 64, 6) * 2).astype(np.float32),
        "rpn_bbox": (rng.randn(b, a, 6) * 4).astype(np.float32),
        "tcls": tcls,
        "cls_logits": (rng.randn(b, t, c) * 8).astype(np.float32),
        "active": np.array([[1, 1, 0], [0, 1, 1]], np.float32),
        "tbox": (rng.randn(b, t, 6) * 2).astype(np.float32),
        "pbox": (rng.randn(b, t, c, 6) * 5).astype(np.float32),
        "tmask": tmask,
        "pmask": rng.uniform(0.001, 0.999,
                             (b, t, m, m, m, c)).astype(np.float32),
    }


# (name, maker of the arguments, index of the differentiated argument)
LOSSES = [
    ("rpn_class_loss", lambda d: (d["rpn_match"], d["rpn_logits"]), 1),
    ("rpn_bbox_loss", lambda d: (d["rpn_target"], d["rpn_match"],
                                 d["rpn_bbox"]), 2),
    ("mrcnn_class_loss", lambda d: (d["tcls"], d["cls_logits"],
                                    d["active"]), 1),
    ("mrcnn_bbox_loss", lambda d: (d["tbox"], d["tcls"], d["pbox"]), 2),
    ("mrcnn_mask_loss", lambda d: (d["tmask"], d["tcls"], d["pmask"]), 2),
]


@pytest.mark.parametrize("name,build,wrt", LOSSES, ids=[n for n, *_ in LOSSES])
def test_loss_matches_jax(name, build, wrt):
    """Value and every metric within 1e-5 relative (float32, sums in
    another order), the input gradient within 1e-5 of max|grad|."""
    args = build(_loss_inputs(np.random.RandomState(3)))
    jfn, tfn = getattr(J_L, name), getattr(T_L, name)

    def jloss(x):
        a = list(args)
        a[wrt] = x
        return jfn(*a)

    (j_val, j_met), j_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(args[wrt]))
    targs = [T(a) for a in args]
    targs[wrt] = targs[wrt].clone().requires_grad_(True)
    t_val, t_met = tfn(*targs)
    t_val.backward()
    assert j_met.keys() == t_met.keys()
    for k in j_met:
        np.testing.assert_allclose(float(t_met[k].detach()), float(j_met[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-5)
    g = np.asarray(j_grad)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(targs[wrt].grad.numpy(), g,
                               atol=1e-5 * np.abs(g).max())


# crop_and_resize_3d, minimize_mask ---------------------------------------

@pytest.mark.parametrize("method", ["trilinear", "nearest"])
def test_crop_and_resize_matches_jax(method):
    """Boxes inside, across and outside the volume; within 1e-5 relative
    and 1e-6 absolute (float32 sums of eight corners in another order)."""
    rng = np.random.RandomState(5)
    feats = rng.randn(3, 10, 12, 6, 4).astype(np.float32)
    lo = rng.uniform(-0.2, 0.8, (9, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.6, (9, 3))], 1)
    boxes = boxes.astype(np.float32)
    idx = rng.randint(0, 3, 9).astype(np.int32)
    for size in ((5, 4, 3), (1, 2, 1)):
        ref = j_crop(jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(idx),
                     size, method=method)
        got = crop_and_resize_3d(T(feats), T(boxes), T(idx), size, method)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_minimize_mask_matches_jax():
    rng = np.random.RandomState(6)
    masks = rng.uniform(size=(20, 18, 10, 4)) > 0.5
    boxes = np.array([[2, 3, 1, 15, 14, 9], [0, 0, 0, 20, 18, 10],
                      [5, 5, 5, 5, 9, 8], [4, 2, 2, 9, 7, 6]], np.int32)
    for shape in ((8, 8, 8), (5, 6, 4)):
        got = minimize_mask(boxes, masks, shape)
        np.testing.assert_array_equal(got, j_minimize(boxes, masks, shape))
        assert got.dtype == bool and got[..., 2].sum() == 0    # empty box


# Detection targets ---------------------------------------------------------

def _targets_case(case, rng):
    b, p, g, t = 2, 40, 5, 16
    h, w, d = 16, 16, 8
    gt_lo = rng.uniform(0.05, 0.6, (b, g, 3))
    gt = np.concatenate([gt_lo, gt_lo + rng.uniform(0.15, 0.35, (b, g, 3))],
                        -1).clip(0, 1).astype(np.float32)
    cls = rng.randint(1, 3, (b, g)).astype(np.int32)
    gt[:, 4:], cls[:, 4:] = 0.0, 0                      # padded GT slots
    near = gt[:, rng.randint(0, 4, p)] + rng.normal(0, 0.03, (b, p, 6))
    props = np.where(rng.uniform(size=(b, p, 1)) < 0.5, near,
                     rng.uniform(0, 1, (b, p, 6)))
    props = np.concatenate([props[..., :3], props[..., :3]
                            + np.abs(props[..., 3:] - props[..., :3])],
                           -1).clip(0, 1).astype(np.float32)
    props[:, -6:] = 0.0                                 # padded proposals
    masks = (rng.uniform(size=(b, h, w, d, g)) > 0.4).astype(np.float32)
    kw = {}
    if case == "no_gt":
        gt[:], cls[:] = 0.0, 0
    elif case == "no_positive":
        props[..., :3], props[..., 3:] = 0.95, 1.0
    elif case == "p_below_t":
        props, t = props[:, :10], 24
    elif case == "mini_mask":
        kw["use_mini_mask"] = True
        masks = np.stack([
            j_minimize((gt[i] * [h, w, d, h, w, d]).astype(np.int32),
                       masks[i], (6, 6, 6)) for i in range(b)]).astype(
            np.float32)
    return props, cls, gt, masks, t, kw


@pytest.mark.parametrize("case", ["default", "no_gt", "no_positive",
                                  "p_below_t", "mini_mask"])
def test_detection_targets_match_jax(case):
    """JAX's uniforms (its split keys) injected: ids, valid, pos_count and
    masks exact; rois and deltas within 1e-5."""
    rng = np.random.RandomState(7)
    props, cls, gt, masks, t, kw = _targets_case(case, rng)
    std = np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2], np.float32)
    args = dict(train_rois_per_image=t, roi_positive_ratio=0.33,
                positive_iou_threshold=0.5, negative_iou_threshold=0.3,
                mask_shape=(7, 7, 7), **kw)
    key = jax.random.PRNGKey(4)
    ref = j_dt(key, jnp.asarray(props), jnp.asarray(cls), jnp.asarray(gt),
               jnp.asarray(masks), jnp.asarray(std), **args)
    r = [[np.asarray(jax.random.uniform(k, (props.shape[1],)))
          for k in jax.random.split(kb)]
         for kb in jax.random.split(key, props.shape[0])]
    uniforms = tuple(np.stack([ri[i] for ri in r]) for i in range(2))
    got = detection_targets_batch(T(props), T(cls), T(gt), T(masks), std,
                                  uniforms=uniforms, **args)
    for k in ("class_ids", "valid", "pos_count", "masks"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    for k in ("rois", "gt_boxes", "deltas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    n_pos = got["pos_count"].numpy()
    if case in ("no_gt", "no_positive"):
        assert (n_pos == 0).all() and got["valid"].any()
    else:
        assert (n_pos > 0).all() and got["masks"].sum() > 0


# RPN targets, augmentations -----------------------------------------------

def test_build_rpn_targets_matches_jax():
    """Exact under one seed, telemetry fed alike; both packages take the
    IoU matrix from their native libraries (the same bits)."""
    jax_native()
    kw = dict(TINY, RPN_TRAIN_ANCHORS_PER_IMAGE=64, RPN_POSITIVE_IOU=0.3,
              RPN_NEGATIVE_IOU=0.1, TELEMETRY_SAMPLE=1.0)
    from m3d.anchors import normalized_pyramid_anchors

    anchors = normalized_pyramid_anchors(Config(**kw))
    rng = np.random.RandomState(9)
    for n_gt in (3, 0):
        lo = rng.uniform(0, 40, (n_gt, 3)) * [1, 1, 0.1]
        boxes = np.concatenate([lo, lo + rng.uniform(6, 20, (n_gt, 3))
                                * [1, 1, 0.3]], 1).astype(np.float32)
        cls = np.ones(n_gt, np.int32)
        out = []
        for mod, tel, conf in ((J_rpn, JTelemetry, Config),
                               (T_rpn, Telemetry, TConfig)):
            c = conf(**kw)
            te = tel(c)
            res = mod.build_rpn_targets(anchors, cls, boxes, c,
                                        rng=np.random.RandomState(1),
                                        telemetry=te)
            out.append((res, dict(te.hist), dict(te.cnt)))
        (rj, hj, cj), (rt, ht, ct) = out
        for a, b in zip(rt, rj):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert hj == ht and cj == ct
        assert (rt[0] == 1).sum() > 0 if n_gt else (rt[0] == -1).all()


def test_augmentations_match_jax():
    """apply_minimal_augs_3d (flips, brightness, noise) and jitter_boxes_3d
    give equal arrays under one seed."""
    rng = np.random.RandomState(10)
    image = rng.uniform(size=(16, 12, 6, 1)).astype(np.float32)
    boxes = np.array([[1, 2, 0, 9, 10, 4], [4, 1, 1, 14, 6, 5]], np.float32)
    masks = rng.uniform(size=(16, 12, 6, 2)) > 0.5
    kw = dict(AUG_PROB=0.7, AUG_FLIP_Z=True, AUG_GAUSS_NOISE_STD=0.05)
    for seed in range(4):
        ref = J_aug.apply_minimal_augs_3d(image, boxes, masks, Config(**kw),
                                          rng=np.random.RandomState(seed))
        got = T_aug.apply_minimal_augs_3d(image, boxes, masks, TConfig(**kw),
                                          rng=np.random.RandomState(seed))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        jit = dict(count=4, scale_sigma=0.2, trans=(2, 2, 1),
                   img_shape=(16, 12, 6), iou_thr=0.3, max_keep=2)
        np.testing.assert_array_equal(
            T_aug.jitter_boxes_3d(boxes, rng=np.random.RandomState(seed),
                                  **jit),
            J_aug.jitter_boxes_3d(boxes, rng=np.random.RandomState(seed),
                                  **jit))


# Optimiser, constraints, callbacks ----------------------------------------

def _opt_tree(rng):
    return {
        "resnet": {"conv1": {"kernel": rng.randn(3, 3, 1, 2, 4),
                             "bias": rng.randn(4)},
                   "bn_conv1": {"scale": rng.uniform(0.5, 1.5, 4),
                                "bias": rng.randn(4)}},
        "classifier": {"mrcnn_class_logits": {"kernel": rng.randn(6, 3) * 3,
                                              "bias": rng.randn(3)},
                       "mrcnn_class_bn1": {"scale": rng.uniform(0.5, 1.5, 6),
                                           "bias": rng.randn(6)}},
        "mask_head": {"mrcnn_mask_deconv": {"kernel": rng.randn(2, 2, 2, 3, 5),
                                            "bias": rng.randn(5)}},
    }


OPTIMIZERS = {
    "sgd_clipnorm_decay_frozen": (dict(OPTIMIZER={"name": "SGD", "parameters": {
        "learning_rate": 0.1, "momentum": 0.9, "clipnorm": 0.5,
        "decay": 0.1}}, WEIGHT_DECAY=1e-2), True),
    "sgd_nesterov_global_clip": (dict(OPTIMIZER={"name": "SGD", "parameters": {
        "lr": 0.05, "momentum": 0.8, "nesterov": True}},
        GRADIENT_CLIP_NORM=1.0, WEIGHT_DECAY=1e-3), False),
    "adam_size_normalized_decay": (dict(OPTIMIZER={"name": "Adam", "parameters": {
        "learning_rate": 0.01, "beta1": 0.8}}, WEIGHT_DECAY=0.1,
        WEIGHT_DECAY_SIZE_NORMALIZED=True, GRADIENT_CLIP_NORM=2.0), True),
    "adadelta": (dict(OPTIMIZER={"name": "Adadelta", "parameters": {
        "rho": 0.9, "clipnorm": 1.0}}, WEIGHT_DECAY=1e-4), False),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Five steps of the port's chain against m3d.train.optim's optax chain
    on the same gradients, the learning rate halved after step 3 through
    set_learning_rate: parameters within 1e-6 of their scale after each
    step; frozen leaves (the e2e rule) unchanged."""
    kw, freeze = OPTIMIZERS[name]
    rng = np.random.RandomState(11)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  _opt_tree(rng))
    params = tree
    tx = J_opt.build_optimizer(Config(**kw), params,
                               freeze_predicate=j_frozen if freeze else None)
    state = tx.init(params)
    sd = {k: v.clone() for k, v in T_ckpt.params_from_jax(
        {"params": tree}).items()}
    opt = T_opt.Optimizer(TConfig(**kw), sd,
                                freeze_predicate=_is_frozen_for_e2e
                                if freeze else None)
    assert T_opt.get_learning_rate(opt) == J_opt.get_learning_rate(state)
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.randn(*a.shape) * 2).astype(np.float32), params)
        if step == 3:
            lr = J_opt.get_learning_rate(state) * 0.5
            state = J_opt.set_learning_rate(state, lr)
            T_opt.set_learning_rate(opt, lr)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, g in T_ckpt.params_from_jax({"params": grads}).items():
            sd[k].grad = g
        opt.step()
        want = T_ckpt.params_from_jax({"params": jax.device_get(params)})
        for k in want:
            scale = max(1.0, float(want[k].abs().max()))
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=1e-6 * scale, err_msg=(k, step))
    if freeze:
        before = T_ckpt.params_from_jax({"params": tree})
        assert torch.equal(sd["resnet.conv1.weight"],
                           before["resnet.conv1.weight"])
        assert not torch.equal(sd["classifier.mrcnn_class_logits.weight"],
                               before["classifier.mrcnn_class_logits.weight"])


@pytest.mark.parametrize("frozen", [False, True])
def test_apply_constraints_matches_jax(frozen):
    """MaxNorm on mrcnn_class_logits (2.0) and mrcnn_bbox_fc (1.0), frozen
    leaves untouched; within 1e-6."""
    rng = np.random.RandomState(12)
    tree = {"classifier": {
        "mrcnn_class_logits": {"kernel": (rng.randn(16, 3) * 2).astype(
            np.float32), "bias": rng.randn(3).astype(np.float32)},
        "mrcnn_bbox_fc": {"kernel": (rng.randn(16, 18) * 0.1).astype(
            np.float32)}},
        "rpn": {"rpn_class_raw": {"kernel": rng.randn(1, 1, 1, 4, 2).astype(
            np.float32) * 9}}}
    pred = (lambda p: "bbox" in p) if frozen else None
    ref = J_opt.apply_constraints(tree, frozen_predicate=pred)
    sd = T_ckpt.params_from_jax({"params": tree})
    T_opt.apply_constraints(sd, frozen_predicate=pred)
    want = T_ckpt.params_from_jax({"params": jax.device_get(ref)})
    for k in want:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-6)
    norms = sd["classifier.mrcnn_class_logits.weight"].norm(dim=1)
    assert norms.max() <= 2.0 + 1e-5
    assert not torch.equal(sd["classifier.mrcnn_class_logits.weight"],
                           T(tree["classifier"]["mrcnn_class_logits"]
                             ["kernel"].T.copy()))


def test_lr_plateau_and_early_stopping_match_jax():
    rng = np.random.RandomState(13)
    for mode in ("min", "max"):
        seq = list(np.round(rng.uniform(0, 1, 30), 1))
        jr, tr = (m.ReduceLROnPlateau(mode=mode, patience=2)
                  for m in (J_opt, T_opt))
        je, te = (m.EarlyStopping(patience=4, mode=mode, min_delta=0.05)
                  for m in (J_opt, T_opt))
        lr_j = lr_t = 0.01
        for v in seq:
            lr_j, lr_t = jr.update(v, lr_j), tr.update(v, lr_t)
            assert lr_t == lr_j
            assert te.update(v) == je.update(v)
        assert lr_t < 0.01 and te.stopped


# Telemetry ------------------------------------------------------------------

def test_telemetry_snapshots_match_jax(tmp_path):
    """The same feeds give the same snapshots and JSONL lines."""
    lines = []
    for mod, conf, side in ((JTelemetry, Config, "jax"),
                            (Telemetry, TConfig, "port")):
        rng = np.random.RandomState(14)
        tel = mod(conf(TELEMETRY_SAMPLE=0.7))
        for _ in range(6):
            gt = rng.uniform(0, 60, (5, 6)).astype(np.float32)
            gt[:, 3:] = gt[:, :3] + rng.uniform(4, 30, (5, 3))
            tel.update_gt_stats(gt)
            match = rng.choice([-1, 0, 1], 500)
            anchors = np.abs(rng.randn(500, 6)) * 40
            anchors[:, 3:] += anchors[:, :3]
            tel.update_rpn_targets(anchors, rng.uniform(size=500), match)
            tel.update_rpn_proposals(gt + rng.normal(0, 2, gt.shape), gt)
        snap = tel.snapshot_and_reset(3, str(tmp_path / side),
                                      extra={"lr": np.float32(0.5), "n": 2})
        assert not tel.hist and not tel.cnt
        with open(tmp_path / side / "telemetry.jsonl") as f:
            lines.append((snap, f.read()))
    (sj, fj), (st, ft) = lines
    assert st == sj and ft == fj
    assert sj["suggest"]["scales"] and sj["cnt"]["prop_total"] == 30


# The straight-through clip, initialisation ----------------------------------

def test_classifier_logit_clip_is_straight_through():
    """Port of tests/test_optim.py's saturated-clip test: both logits far
    below -10 through the bias. The forward value is clipped, the gradient
    is not zero, and every leaf's gradient equals JAX's within 1e-5 of its
    largest entry (a hard clamp gives zero)."""
    head = JClassifierHead(pool_size=3, num_classes=2, fc_layers_size=16,
                           dtype=jnp.float32)
    x0 = np.random.RandomState(15).randn(1, 4, 3, 3, 3, 8).astype(np.float32)
    variables = jax.device_get(head.init(jax.random.PRNGKey(0), x0))
    params = variables["params"]
    params["mrcnn_class_logits"]["bias"] = np.array([-100.0, -120.0],
                                                    np.float32)

    def loss(p):
        lg, _, _ = head.apply({**variables, "params": p}, x0)
        return -jnp.mean(jax.nn.log_softmax(lg)[..., 1])

    j_grads = T_ckpt.params_from_jax({"params": jax.grad(loss)(params)})
    port = ClassifierHead(8, 3, 2, 16, dtype=torch.float32)
    stats = T_ckpt.restore_by_name(port, T_ckpt.params_from_jax(
        {**variables, "params": params}))
    assert stats["missing"] == 0
    logits, _, _ = port(T(x0))
    assert float(logits.max()) <= 10.0 and float(logits.min()) >= -10.0
    (-torch.log_softmax(logits, -1)[..., 1].mean()).backward()
    total = 0.0
    for name, p in port.named_parameters():
        g = j_grads[name].numpy()
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), g,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-12),
                                   err_msg=name)
        total += float(got.abs().sum())
    assert total > 0.0


def test_init_distributions_match_jax(jax_tiny):
    """init_params against JAX's at TINY, leaf by leaf: the class-logit
    bias exact; other biases, BatchNorm leaves and statistics equal to
    JAX's constants; each kernel's mean within 6 standard errors of 0,
    its standard deviation within 6 standard errors of JAX's sample
    standard deviation, and lecun_normal kernels inside their truncation
    (2 / 0.8796 standard deviations)."""
    _, variables = jax_tiny
    want = T_ckpt.params_from_jax(jax.device_get(variables))
    model = init_params(MaskRCNN.from_config(TConfig(**TINY), device="cpu"),
                        seed=0)
    got = model.state_dict()
    assert want.keys() == got.keys()
    normal = {"classifier.mrcnn_class_logits.weight",
              "classifier.mrcnn_bbox_fc.weight", "rpn.rpn_bbox_pred.weight"}
    for k, w in want.items():
        g = got[k]
        if w.ndim < 2:
            assert torch.equal(g, w), k
            continue
        n = w.numel()
        sd_j, sd_t = float(w.std()), float(g.std())
        assert abs(float(g.mean())) <= 6 * sd_j / n ** 0.5, k
        assert abs(sd_t - sd_j) <= 6 * sd_j / (2 * n) ** 0.5, (k, sd_t, sd_j)
        if k not in normal:
            fan_out = 1 if "deconv" in k else 0
            fan_in = n // g.shape[fan_out]
            bound = 2.0 * fan_in ** -0.5 / TRUNC_STD
            assert float(g.abs().max()) <= bound * (1 + 1e-6), k
    bias = got["classifier.mrcnn_class_logits.bias"]
    assert (bias < 0).all()
    again = init_params(MaskRCNN.from_config(TConfig(**TINY), device="cpu"), 0)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in got.items())


# Checkpoints ------------------------------------------------------------------

def test_checkpoints_both_ways(jax_tiny, tmp_path):
    """The port's save_params writes flax's bytes; JAX's load_params and
    restore_by_name read the port's file with every leaf loaded and none
    skipped or missing, bit-exact; params_to_jax inverts params_from_jax;
    extract_subtree and BestAndLatest write what JAX's write."""
    jm, variables = jax_tiny
    v = randomize(variables, 17)
    model = MaskRCNN.from_config(TConfig(**TINY), device="cpu")
    stats = T_ckpt.restore_by_name(model, T_ckpt.params_from_jax(v))
    assert stats["missing"] == stats["skipped"] == 0
    tree = T_ckpt.params_to_jax(model.state_dict())
    flat_v, flat_t = _leaves(v), _leaves(tree)
    assert flat_v.keys() == flat_t.keys()
    for k in flat_v:
        np.testing.assert_array_equal(flat_t[k], np.asarray(flat_v[k]), k)
        assert flat_t[k].dtype == np.float32
    back = T_ckpt.params_from_jax(tree)
    assert all(torch.equal(back[k], t) for k, t in model.state_dict().items())

    path = str(tmp_path / "port.msgpack")
    T_ckpt.save_params(path, tree, {"epoch": 3})
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(tree)
    loaded, meta = J_ckpt.load_params(path)
    assert meta == {"epoch": 3}
    merged, jstats = J_ckpt.restore_by_name(variables, loaded)
    assert jstats["loaded"] == len(flat_v)
    assert jstats["missing"] == jstats["skipped"] == jstats["sliced"] == 0
    for k, val in _leaves(merged).items():
        np.testing.assert_array_equal(np.asarray(val), flat_v[k], k)

    head = T_ckpt.extract_subtree(tree)
    assert _leaves(head).keys() == _leaves(J_ckpt.extract_subtree(tree)).keys()
    assert all("mrcnn_" in k for k in _leaves(head))
    for side, ckpt in (("jax", J_ckpt), ("port", T_ckpt)):
        bl = ckpt.BestAndLatest(str(tmp_path / side), mode="max")
        assert bl.update(0, tree, 1.0, {"kind": "rpn"})
        assert not bl.update(1, tree, 0.5)
    for name in ("latest", "latest_head", "best", "best_head"):
        for ext in (".msgpack", ".msgpack.json"):
            with open(tmp_path / "jax" / (name + ext), "rb") as f, \
                    open(tmp_path / "port" / (name + ext), "rb") as g:
                assert f.read() == g.read(), name + ext
    with open(tmp_path / "port" / "best.msgpack.json") as f:
        assert json.load(f) == {"kind": "rpn", "epoch": 0, "metric": 1.0}
    assert os.path.exists(tmp_path / "port" / "latest.msgpack")


def test_epoch_profiler_traces_the_second_epoch(tmp_path):
    """PROFILE_DIR set: the epoch after FROM_EPOCH is traced with
    torch.profiler into a Chrome trace, the program's spans named in it;
    other epochs are not, and tracing is off again after it."""
    from m3d_torch import trace
    from m3d_torch.train.profiling import EpochProfiler

    prof = EpochProfiler(TConfig(PROFILE_DIR=str(tmp_path), FROM_EPOCH=2))
    for epoch in (2, 3, 4):
        prof.maybe_start(epoch)
        with trace.span("trunk"):
            torch.ones(8).sum()
        prof.maybe_stop(epoch)
    assert os.listdir(tmp_path) == ["epoch_3.trace.json"]
    with open(tmp_path / "epoch_3.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "m3d.trunk" in names
    assert not trace._on and trace.take()["calls"] == []
