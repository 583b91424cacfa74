"""MRCNN_TRAINING of the port against m3d's, at the TINY config of
tests/test_torch_models.py on the CPU (float32): the first batch of both
packages' MrcnnGenerator in training mode (equal arrays), one train step
for each LEARNING_LAYERS value against JAX's own jitted step (metrics,
gradients, every leaf after the optimiser), the head loss's own gradient
into the FPN (which only the gather's backward carries), TRAIN_BN against
JAX's batch statistics after the step, and ``python -m m3d_torch --task
MRCNN_TRAINING`` for one epoch with JAX reading its checkpoint.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m3d.config import Config
from m3d.train import checkpoints as J_ckpt
from m3d.train import optim as J_opt
from m3d.train.mrcnn import _freeze_predicate as j_freeze
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.config import Config as TConfig
from m3d_torch.data.generators import to_device
from m3d_torch.train import mrcnn as T_mrcnn
from test_torch_models import TINY, randomize
from test_torch_native import jax_native
from test_torch_train import _leaves
from test_torch_train_cli import (GRAB, STEP, _assert_grads, _assert_params,
                                  _run, _write_config,
                                  train_data)  # noqa: F401 (fixture)

# The mask branch at half the bench's extents (pool 7, targets 14^3) keeps
# JAX's CPU step short; the mask head's weights do not depend on them.
MRCNN = dict(STEP, MODE="training", MASK_POOL_SIZE=7, MASK_SHAPE=[14, 14, 14])


@pytest.fixture(scope="module")
def tiny_variables():
    """A zero tree with the shapes and dtypes of JAX's variables at TINY
    (``jax.eval_shape`` of init_params: traced, not compiled); the tests
    fill it with ``randomize``."""
    from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
    from m3d.models.mask_rcnn import init_params

    model = JMaskRCNN.from_config(Config(**TINY), mode="training")
    shapes = jax.eval_shape(functools.partial(init_params, model),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes)


def jax_uniforms(key, bsz, n_prop):
    """The uniforms JAX's detection_targets_batch draws from ``key`` for a
    batch of ``bsz``: (r_pos, r_neg), each [bsz, n_prop]."""
    r = [[np.asarray(jax.random.uniform(k, (n_prop,)))
          for k in jax.random.split(kb)] for kb in jax.random.split(key, bsz)]
    return tuple(np.stack([ri[i] for ri in r]) for i in range(2))


def inject(monkeypatch, module, uniforms):
    """Make ``module``'s detection_targets_batch take ``uniforms`` (a list,
    one entry per call, in order)."""
    real = module.detection_targets_batch
    queue = list(uniforms)
    monkeypatch.setattr(module, "detection_targets_batch",
                        lambda *a, **k: real(*a, **dict(k, uniforms=queue.pop(
                            0))))


def mrcnn_batch(data_dir, kw, monkeypatch, ids=(0, 1)):
    """The port's MrcnnGenerator training batch of ``ids`` (SEED 0), held
    to JAX's generator functions composed once per image in JAX's order on
    one RandomState: ``_sample_gt`` with AUGMENT for each image, then
    ``build_rpn_targets`` from the un-jittered GT. (JAX's own ``get_batch``
    samples every image again for each of its five GT keys, so with
    AUGMENT its image, boxes and masks can come from different flips; the
    port samples once. Without augmentation the two agree: see
    ``test_mrcnn_generator_training_batch``.) Returns the batch."""
    from m3d.data.datasets import ToyDataset as JToy
    from m3d.data.generators import MrcnnGenerator as JGen
    from m3d.data.rpn_targets import build_rpn_targets
    from m3d_torch.data.datasets import ToyDataset as TToy
    from m3d_torch.data.generators import MrcnnGenerator as TGen

    jax_native()
    gens = []
    for toy, gen, conf in ((JToy, JGen, Config), (TToy, TGen, TConfig)):
        ds = toy()
        ds.load_dataset(data_dir, is_train=True, class_names=("object",))
        ds.prepare()
        gens.append(gen(ds.filter_positive(), conf(**kw), mode="training",
                        seed=0))
    jgen, tgen = gens
    got = tgen.get_batch(list(ids))
    samples = [jgen._sample_gt(i, augment=jgen.config.AUGMENT) for i in ids]
    want = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    rpn = [build_rpn_targets(
        jgen.anchors, want["gt_class_ids"][b],
        want["gt_boxes"][b] * np.array(want["image"][b].shape[:3] * 2,
                                       np.float32), jgen.config,
        rng=jgen.rng) for b in range(len(ids))]
    want["rpn_match"] = np.stack([m for m, _ in rpn])
    want["rpn_bbox"] = np.stack([bb for _, bb in rpn])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)
    return got


def test_mrcnn_generator_training_batch(train_data, monkeypatch):
    """Without augmentation JAX's own MrcnnGenerator and the port's give
    equal first batches (shuffled order, GT, RPN targets)."""
    from m3d.data.datasets import ToyDataset as JToy
    from m3d.data.generators import MrcnnGenerator as JGen
    from m3d_torch.data.datasets import ToyDataset as TToy
    from m3d_torch.data.generators import MrcnnGenerator as TGen

    jax_native()
    kw = dict(MRCNN, DATA_DIR=train_data, AUGMENT=False)
    out = []
    for toy, gen, conf in ((JToy, JGen, Config), (TToy, TGen, TConfig)):
        ds = toy()
        ds.load_dataset(train_data, is_train=True, class_names=("object",))
        ds.prepare()
        out.append(next(iter(gen(ds.filter_positive(), conf(**kw),
                                 mode="training", seed=3))))
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        assert out[1][k].dtype == out[0][k].dtype, k
        np.testing.assert_array_equal(out[1][k], out[0][k], k)
    assert (out[1]["rpn_match"] == 1).sum() > 0


def jax_step(kw, v, batch, key):
    """JAX's jitted MRCNN train step with GRAB: (metrics, gradients,
    batch_stats after the step)."""
    from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
    from m3d.train.mrcnn import MrcnnTrainer as JMrcnnTrainer

    jcfg = Config(**kw)
    jt = JMrcnnTrainer(jcfg)
    step = jt.make_train_step(JMaskRCNN.from_config(jcfg, mode="training"),
                              GRAB)
    copy = jax.tree_util.tree_map(jnp.array, v)
    _, grads, stats, met = step(copy["params"], GRAB.init(v["params"]),
                                copy["batch_stats"], batch, key)
    return met, grads, jax.device_get(stats)


def port_step(kw, v, batch, uniforms, tmp_path, monkeypatch):
    """The port's MRCNN train step from ``v`` (restored from a JAX-saved
    checkpoint) with JAX's uniforms injected. Returns (trainer, model,
    metrics, parameters before the step)."""
    ckpt = str(tmp_path / "src.msgpack")
    J_ckpt.save_params(ckpt, v)
    tcfg = TConfig(**dict(kw, RPN_WEIGHTS=ckpt))
    inject(monkeypatch, T_mrcnn, [uniforms])
    trainer = T_mrcnn.MrcnnTrainer(tcfg, device="cpu")
    model = T_mrcnn.MaskRCNN.from_config(tcfg, mode="training",
                                         device="cpu").eval()
    opt = trainer.prepare_train(model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    met = trainer.make_train_step(model, opt, None)(to_device(batch, "cpu"))
    return trainer, model, met, before


def jax_new_params(kw, params, grads, frozen=None):
    """JAX's optimiser (fresh state) and MaxNorm constraints
    (m3d.train.optim) applied once to ``grads``, under one jit: run
    eagerly, their ~400 leaves compile op by op."""
    tx = J_opt.build_optimizer(Config(**kw), params, freeze_predicate=frozen)

    @jax.jit
    def step(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return J_opt.apply_constraints(optax.apply_updates(params, updates),
                                       frozen_predicate=frozen)
    return step(params, grads)


def _tol(name):
    """Gradient tolerance, |g_port - g_jax| / |g_jax|: 2e-2 for ResNet
    leaves (the backbone gradient's ill-conditioning on the synthetic
    batch measured in tests/test_torch_train_cli.py); 5e-4 for the mask
    head's convolutions and BatchNorms before its deconvolution, whose
    gradients move by up to 1.7e-4 under 2e-6 relative noise on the
    mask-stage features (measured; the packages' feature maps differ by
    2e-6 relative here, and the port's two CPU convolution backends agree
    on these gradients to 1.3e-6); 1e-4 for every other FPN, RPN and head
    leaf."""
    if name.startswith("resnet."):
        return 2e-2
    if name.startswith("mask_head.mrcnn_mask_") and \
            not name.startswith("mask_head.mrcnn_mask_deconv."):
        return 5e-4
    return 1e-4


@pytest.fixture(scope="module")
def grads_all(tiny_variables, train_data):
    """JAX's step at LEARNING_LAYERS "all" on the first batch: its
    gradients are every LEARNING_LAYERS value's (the freeze acts in the
    optimiser and the constraints only)."""
    mp = pytest.MonkeyPatch()
    try:
        kw = dict(MRCNN, DATA_DIR=train_data)
        batch = mrcnn_batch(train_data, kw, mp)
        v = randomize(tiny_variables, 13)
        key = jax.random.PRNGKey(7)
        met, grads, _ = jax_step(kw, v, batch, key)
        assert float(met["class_pos_count"]) > 0
        return v, batch, key, met, grads
    finally:
        mp.undo()


@pytest.mark.parametrize("layers", ["all", "head", "rpn"])
def test_mrcnn_train_step_matches_jax(grads_all, train_data, layers,
                                      tmp_path, monkeypatch):
    """One MRCNN_TRAINING step: metrics within 1e-4 relative, the
    trainable leaves' gradients against JAX's (``_tol``), every leaf after
    the optimiser and MaxNorm (frozen leaves unchanged, without a
    gradient), and the ROIAligns on the path LEARNING_LAYERS implies: the
    gather where a feature map needs a gradient ("all", "rpn"), the padded
    kernel entry's plain version otherwise ("head")."""
    from m3d_torch.ops import roialign3d

    v, batch, key, jmet, grads = grads_all
    kw = dict(MRCNN, DATA_DIR=train_data, LEARNING_LAYERS=layers)
    routes = []
    for name in ("pyramid_roi_align", "pyramid_roi_align_pallas"):
        real = getattr(roialign3d, name)
        monkeypatch.setattr(roialign3d, name,
                            lambda *a, _n=name, _f=real, **k: (
                                routes.append(_n), _f(*a, **k))[1])
    _, model, tmet, before = port_step(
        kw, v, batch, jax_uniforms(key, 2, STEP["POST_NMS_ROIS_TRAINING"]),
        tmp_path, monkeypatch)
    want = ["pyramid_roi_align_pallas" if layers == "head"
            else "pyramid_roi_align"] * 2
    assert routes == want
    assert tmet.keys() == jmet.keys()
    for k in jmet:
        np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    frozen = T_mrcnn._freeze_predicate(layers)
    names = list(before)
    train = [k for k in names if frozen is None or not frozen(k)]
    assert 10 < len(train) <= len(names)
    _assert_grads(model, grads, train, _tol)
    _assert_params(model, jax_new_params(kw, v["params"], grads,
                                         j_freeze(layers)), names)
    for k, p in model.named_parameters():
        if k not in train:
            assert torch.equal(p, before[k]) and p.grad is None, k


HEAD_LOSSES = ("mrcnn_class_loss", "mrcnn_bbox_loss", "mrcnn_mask_loss",
               "mrcnn_obj_loss", "mrcnn_margin_loss")


def test_mrcnn_head_loss_reaches_fpn_through_the_gather(grads_all,
                                                        train_data,
                                                        tmp_path):
    """The head loss's own gradient into the FPN and backbone, which only
    the ROIAligns' backward carries. A gradient is linear in the loss
    weights, so the port's step with the RPN losses weighted 0 (the head
    loss alone) plus its step with the head losses weighted 0 (the RPN
    loss alone) must give JAX's step's gradient on every FPN and ResNet
    leaf (``_tol``). The head loss's part must be decisive: over the FPN
    leaves its norm is above 1e-2 of the whole gradient's (100x the FPN
    tolerance), and the FPN leaves of the levels the ROIs are routed to
    (most of them at TINY) have a non-zero one."""
    v, batch, key, _, grads = grads_all
    weights = dict(Config().LOSS_WEIGHTS)
    runs = {"head": dict(weights, rpn_class_loss=0.0, rpn_bbox_loss=0.0),
            "rpn": dict(weights, **{k: 0.0 for k in HEAD_LOSSES})}
    got = {}
    for part, lw in runs.items():
        with pytest.MonkeyPatch.context() as mp:
            _, model, tmet, _ = port_step(
                dict(MRCNN, DATA_DIR=train_data, LOSS_WEIGHTS=lw), v, batch,
                jax_uniforms(key, 2, STEP["POST_NMS_ROIS_TRAINING"]),
                tmp_path, mp)
        assert np.isfinite(tmet["loss"])
        got[part] = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                     for k, p in model.named_parameters()
                     if k.startswith(("fpn.", "resnet."))}
    want = T_ckpt.params_from_jax({"params": jax.device_get(grads)})
    for k, g in got["head"].items():
        err = float(torch.linalg.norm(g + got["rpn"][k] - want[k]))
        assert err <= _tol(k) * float(torch.linalg.norm(want[k])) + 1e-12, \
            (k, err)
    fpn = [k for k in got["head"] if k.startswith("fpn.")]

    def norm(part):
        return float(torch.sqrt(sum(part[k].square().sum() for k in fpn)))
    assert norm(got["head"]) > 1e-2 * norm(want)
    live = [k for k in fpn if float(got["head"][k].abs().max()) > 0]
    assert len(live) > len(fpn) // 2, live


def test_mrcnn_train_bn_step_matches_jax(tiny_variables, train_data, tmp_path,
                                         monkeypatch):
    """TRAIN_BN: the RPN losses within 1e-4 relative, the trunk's running
    statistics after the step within 1e-3 of each leaf's largest value of
    JAX's batch_stats, and every running statistic (trunk and heads)
    moved and finite.

    On batch statistics this random-weight TINY trunk is ill-conditioned
    (flax's E[x^2] - E[x]^2 over stage 5's eight samples a channel): JAX's
    float32 feature maps differ from ones with float64 statistics by 4e-4
    relative, the port's by 4e-5 (measured). Its proposals then differ in
    order, so the sampled ROIs, and with them the heads' statistics and
    losses, are not comparable here; tests/test_torch_head_only.py holds
    the heads' statistics to JAX's on equal inputs, and
    tests/test_torch_train_bn.py each BatchNorm to flax's."""
    kw = dict(MRCNN, DATA_DIR=train_data, TRAIN_BN=True)
    batch = mrcnn_batch(train_data, kw, monkeypatch)
    v = randomize(tiny_variables, 13)
    key = jax.random.PRNGKey(7)
    jmet, _, jstats = jax_step(kw, v, batch, key)
    _, model, tmet, _ = port_step(
        kw, v, batch, jax_uniforms(key, 2, STEP["POST_NMS_ROIS_TRAINING"]),
        tmp_path, monkeypatch)
    assert tmet.keys() == jmet.keys() and np.isfinite(tmet["loss"])
    for k in ("rpn_class_loss", "rpn_bbox_loss"):
        np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    got = _leaves(T_ckpt.params_to_jax(model.state_dict())["batch_stats"])
    want, src = _leaves(jstats), _leaves(v["batch_stats"])
    assert got.keys() == want.keys() and len(got) > 20
    for k in want:
        assert np.isfinite(got[k]).all() and not np.array_equal(got[k],
                                                                src[k]), k
        if k.startswith("resnet/"):
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-3 * float(np.abs(want[k]).max()), err_msg=k)


def test_cli_mrcnn_training_jax_reads_checkpoint(tiny_variables, train_data,
                                                 tmp_path):
    """``python -m m3d_torch --task MRCNN_TRAINING``, one epoch from a
    JAX-saved checkpoint (four training volumes: a split of three and one,
    one step, gated on the train loss): every file written, JAX restores
    latest.msgpack whole, and it holds the trained model."""
    from test_torch_train_cli import CKPT_FILES

    src = randomize(tiny_variables, 13)
    ckpt = str(tmp_path / "src.msgpack")
    J_ckpt.save_params(ckpt, src)
    path, wdir = _write_config(tmp_path, train_data, "mrcnn",
                               MODE="training", RPN_WEIGHTS=ckpt,
                               HEAD_WEIGHTS=ckpt)
    trainer, text = _run("MRCNN_TRAINING", path)
    assert "split train=3 val=1" in text and "[MRCNN][epoch 0]" in text
    assert sorted(os.listdir(wdir)) == CKPT_FILES
    (epoch,) = trainer.history
    assert len(trainer.clock.records) == 1 and np.isfinite(epoch["loss"])
    loaded, _ = J_ckpt.load_params(os.path.join(wdir, "latest.msgpack"))
    _, stats = J_ckpt.restore_by_name(tiny_variables, loaded)
    assert stats["loaded"] == len(_leaves(tiny_variables))
    assert stats["missing"] == stats["skipped"] == 0
    state = T_ckpt.params_from_jax(loaded)
    assert all(torch.equal(state[k], v)
               for k, v in trainer.model.state_dict().items())
    moved = [k for k, w in _leaves(src).items()
             if not np.array_equal(_leaves(loaded)[k], w)]
    assert any("mrcnn_" in k for k in moved)
    assert any(k.startswith("params/resnet") for k in moved)
