"""TARGET_GENERATION and head-only HEAD_TRAINING of the port against
m3d's, at the TINY config of tests/test_torch_models.py on the CPU
(float32): target generation with JAX's uniforms injected (targets, ids,
aligned features, the files and manifests), each package's
ToyHeadDataset reading the other's artifacts, HeadGenerator batches under
one seed, the preflight's refusals, one head-only step against JAX's own
jitted step (with and without TRAIN_BN), the feature-gradient guard of the
kernel entries, and ``python -m m3d_torch`` for both tasks.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3d.config import Config
from m3d.train import checkpoints as J_ckpt
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.config import Config as TConfig
from m3d_torch.data import synthetic as T_syn
from m3d_torch.data.generators import to_device
from m3d_torch.train import head as T_head
from m3d_torch.train import rpn as T_rpn
from test_torch_models import randomize
from test_torch_mrcnn_train import (inject, jax_new_params, jax_uniforms,
                                     tiny_variables)  # noqa: F401 (fixture)
from test_torch_train import _leaves
from test_torch_train_cli import (CKPT_FILES, GRAB, STEP, _assert_grads,
                                  _assert_params, _run, _write_config)

# The mask branch at half the bench's extents (pool 7, targets 14^3) keeps
# JAX's CPU steps short; the mask head's weights do not depend on them.
TARGET = dict(STEP, MODE="training", TARGET_RATIO=1.0, MIN_POSITIVE_TARGETS=1,
              TRAIN_ROIS_PER_IMAGE=16, SEED=3, MASK_POOL_SIZE=7,
              MASK_SHAPE=[14, 14, 14])
KEYS = ("rois", "rois_aligned", "mask_aligned", "target_class_ids",
        "target_bbox", "target_mask")


@pytest.fixture(scope="module")
def targets(tiny_variables, tmp_path_factory):
    """Six 64 x 64 x 8 volumes (four train, two test), a JAX-saved
    checkpoint of seeded random weights, and both packages'
    head_target_generation on them (MODE "training": OUTPUT_DIR/
    head_targets), the port with JAX's uniforms injected. Returns (data
    dir, checkpoint, JAX's (root, manifests), the port's (root,
    manifests), the port's trainer)."""
    from m3d.train.rpn import RPNTrainer as JRPNTrainer

    root = tmp_path_factory.mktemp("targets")
    data = str(root / "data")
    T_syn.generate_experiment(6, 64, data, seed=21, image_depth=8)
    T_syn.split_dataset(data, test_ratio=0.34)
    ckpt = str(root / "src.msgpack")
    v = randomize(tiny_variables, 13)
    J_ckpt.save_params(ckpt, v)
    kw = dict(TARGET, DATA_DIR=data, RPN_WEIGHTS=ckpt)
    # JAX's trainer is handed the checkpoint's variables, as its smoke
    # tests do: its own init_variables would run init_params eagerly
    # before restoring the same leaves.
    jout = JRPNTrainer(Config(**dict(kw, OUTPUT_DIR=str(root / "jax"))),
                       mode="targeting").head_target_generation(
        jax.tree_util.tree_map(jnp.asarray, v), inject_gt=True)
    key, uniforms = jax.random.PRNGKey(TARGET["SEED"]), []
    for _ in range(6):     # one key per image of both splits, as JAX's loop
        key, sub = jax.random.split(key)
        uniforms.append(jax_uniforms(sub, 1, STEP["POST_NMS_ROIS_TRAINING"]))
    mp = pytest.MonkeyPatch()
    try:
        inject(mp, T_rpn, uniforms)
        trainer = T_rpn.RPNTrainer(
            TConfig(**dict(kw, OUTPUT_DIR=str(root / "port"))), device="cpu")
        tout = trainer.head_target_generation(inject_gt=True)
    finally:
        mp.undo()
    return data, ckpt, jout, tout, trainer


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_target_generation_matches_jax(targets):
    """Both packages keep the same images and write the same files and
    manifests (paths under their own roots); per image the target ids are
    equal, the ROIs and deltas within 1e-5, the target masks equal, and
    the float16 aligned features within two float16 roundings of JAX's
    (2^-10 of each array's largest value)."""
    from m3d.data.datasets import ToyHeadDataset as JHead

    _, _, (jroot, jman), (troot, tman), trainer = targets
    assert jman.keys() == tman.keys() == {"train", "test"}
    n_kept = 0
    for split in ("train", "test"):
        jrows, trows = _rows(jman[split]), _rows(tman[split])
        assert jrows[0] == trows[0] == list(KEYS)
        assert [[p.replace(jroot, "") for p in r] for r in jrows[1:]] == \
            [[p.replace(troot, "") for p in r] for r in trows[1:]]
        n_kept += len(trows) - 1
        assert sorted(os.listdir(os.path.join(jroot, split))) == \
            sorted(os.listdir(os.path.join(troot, split)))
        jds = JHead()
        jds.load_dataset(jroot, is_train=split == "train")
        tds = JHead()
        tds.load_dataset(troot, is_train=split == "train")
        for i in range(len(jds.image_info)):
            a, b = jds.load_data(i), tds.load_data(i)
            np.testing.assert_array_equal(b["target_class_ids"],
                                          a["target_class_ids"])
            assert (a["target_class_ids"] > 0).sum() >= 1
            for k in ("rois", "target_bbox"):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                           err_msg=k)
            np.testing.assert_array_equal(b["target_mask"], a["target_mask"])
            for k in ("rois_aligned", "mask_aligned"):
                np.testing.assert_allclose(
                    b[k], a[k], rtol=0,
                    atol=2 ** -10 * float(np.abs(a[k]).max()), err_msg=k)
    assert n_kept == 6 and len(trainer.target_times) == 6
    t = trainer.target_times[0]
    assert {"forward", "targets", "roialign", "write", "bytes"} <= set(t)
    assert t["bytes"] == sum(os.path.getsize(p) for p in _rows(
        tman["train"])[1])


def test_target_artifacts_read_both_ways(targets):
    """Each package's ToyHeadDataset reads the other's artifacts to equal
    arrays (uncompressed float arrays, packed masks with their shape), and
    filter_by_positive_count keeps the same images."""
    from m3d.data.datasets import ToyHeadDataset as JHead
    from m3d_torch.data.datasets import ToyHeadDataset as THead

    _, _, (jroot, _), (troot, _), _ = targets
    for root in (jroot, troot):
        jds, tds = JHead(), THead()
        for ds in (jds, tds):
            ds.load_dataset(root, is_train=True)
            ds.prepare()
        assert len(jds.image_info) == len(tds.image_info) == 4
        for i in range(4):
            a, b = jds.load_data(i), tds.load_data(i)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], k)
        n = [int((jds.load_data(i)["target_class_ids"] > 0).sum())
             for i in range(4)]
        for m in (1, int(np.median(n)), max(n) + 1):
            assert [x["id"] for x in
                    jds.filter_by_positive_count(m).image_info] == \
                [x["id"] for x in tds.filter_by_positive_count(m).image_info]
    with np.load(os.path.join(troot, "train", "000000_target_mask.npz")) as z:
        assert sorted(z.keys()) == ["mask", "shape"]
        assert z["mask"].dtype == np.uint8
    with np.load(os.path.join(troot, "train", "000000_mask_aligned.npz")) as z:
        assert list(z.keys()) == ["arr"] and z["arr"].dtype == np.float16


HEAD_CASES = {
    "plain": {},
    "weak_shuffle_balance": dict(HEAD_MIN_POSITIVE_COVERAGE=0.3,
                                 HEAD_SHUFFLE_ROIS=True, HEAD_BALANCE_POS=True,
                                 HEAD_POS_FRAC=0.2, TRAIN_ROIS_PER_IMAGE=12),
    "pool_resize": dict(POOL_SIZE=5, MASK_POOL_SIZE=9,
                        HEAD_SHUFFLE_ROIS=True),
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_head_generator_matches_jax(targets, case):
    """Four batches of JAX's and the port's HeadGenerator under one seed
    (shuffled order, weak-positive demotion, ROI shuffling, positive
    balancing, a nearest resize to other pool sizes): equal arrays."""
    from m3d.data.datasets import ToyHeadDataset as JHead
    from m3d.data.generators import HeadGenerator as JGen
    from m3d_torch.data.datasets import ToyHeadDataset as THead
    from m3d_torch.data.generators import HeadGenerator as TGen

    _, _, _, (troot, _), _ = targets
    kw = dict(TARGET, **HEAD_CASES[case])
    its = []
    for head, gen, conf in ((JHead, JGen, Config), (THead, TGen, TConfig)):
        ds = head()
        ds.load_dataset(troot, is_train=True)
        ds.prepare()
        its.append(iter(gen(ds, conf(**kw), seed=5)))
    demoted = 0
    for _ in range(4):
        a, b = next(its[0]), next(its[1])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], k)
        cfg = TConfig(**kw)
        assert b["rois_aligned"].shape[2:5] == (cfg.POOL_SIZE,) * 3
        assert b["mask_aligned"].shape[2:5] == (cfg.MASK_POOL_SIZE,) * 3
        demoted += int((b["target_class_ids"] == 0).sum())
    assert demoted > 0


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("what", ["no_positives", "empty_masks", "fine"])
def test_preflight_targets_matches_jax(what):
    """Both packages' preflight raises the same error on batches without a
    positive ROI and on positives with empty target masks, and passes
    otherwise."""
    from m3d.train.head import HeadTrainer as JHeadTrainer

    rng = np.random.RandomState(0)
    tci = rng.randint(0, 2, (2, 8)).astype(np.int32)
    tm = (rng.uniform(size=(2, 8, 4, 4, 4)) > 0.5).astype(np.float32)
    if what == "no_positives":
        tci[:] = 0
    if what == "empty_masks":
        tm[:] = 0.0
    gen = _Batches([{"target_class_ids": tci, "target_mask": tm}] * 3)
    results = []
    for cls in (JHeadTrainer, T_head.HeadTrainer):
        try:
            cls.preflight_targets(None, gen, num_batches=3)
            results.append(None)
        except RuntimeError as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[0] is None) == (what == "fine")


def _head_batch(troot, kw):
    from m3d_torch.data.datasets import ToyHeadDataset as THead
    from m3d_torch.data.generators import HeadGenerator as TGen

    ds = THead()
    ds.load_dataset(troot, is_train=True)
    ds.prepare()
    return next(iter(TGen(ds, TConfig(**kw), seed=0)))


@pytest.mark.parametrize("train_bn", [False, True])
def test_head_only_step_matches_jax(tiny_variables, targets, train_bn,
                                    tmp_path):
    """One head-only step on a HeadGenerator batch: metrics within 1e-4
    relative, the heads' gradients within 1e-4 of JAX's step's, and every
    leaf after the optimiser, which (as JAX's) has no freeze predicate:
    the trunk's decayed kernels move by weight decay alone, its BatchNorm
    leaves stay bit-equal. With TRAIN_BN the heads' running statistics
    after the step within 1e-5 of JAX's batch_stats, and they moved; the
    biases of the convolutions that feed a BatchNorm then have a gradient
    that is 0 up to rounding (the batch mean takes them out) in both
    packages: below 1e-6 in norm, instead of the relative check; and the
    mask head's gradients above its last 1^3 convolution are held within
    1e-2: on batch statistics (flax's E[x^2] - E[x]^2 in float32 over
    zero-padded ROI rows) they are ill-conditioned, JAX's lying 2-4 % and
    the port's 0.1 % from gradients with float64 statistics (measured on a
    random-weight mask head)."""
    from m3d.train.head import HeadTrainer as JHeadTrainer

    _, ckpt, _, (troot, _), _ = targets
    kw = dict(TARGET, DATA_DIR=troot, TRAIN_BN=train_bn)
    batch = _head_batch(troot, kw)
    assert (batch["target_class_ids"] > 0).any()
    v = randomize(tiny_variables, 13)
    jcfg = Config(**kw)
    copy = jax.tree_util.tree_map(jnp.array, v)
    _, grads, jstats, jmet = JHeadTrainer(jcfg).make_head_only_step(GRAB)(
        copy["params"], GRAB.init(v["params"]), copy["batch_stats"], batch)
    jnew = jax_new_params(kw, v["params"], grads)

    trainer = T_head.HeadTrainer(TConfig(**dict(kw, HEAD_WEIGHTS=ckpt)),
                                 device="cpu")
    model = trainer.init_variables()
    opt = T_head.Optimizer(trainer.config, dict(model.named_parameters()))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tmet = trainer.make_head_only_step(opt)(to_device(batch, "cpu"))
    assert tmet.keys() == jmet.keys()
    for k in jmet:
        np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    names = list(before)
    heads = [k for k in names if k.split(".")[0] in ("classifier",
                                                     "mask_head")]
    params = dict(model.named_parameters())
    cancelled = [k for k in heads if train_bn and k.endswith(".bias")
                 and "_conv" in k]
    want_g = T_ckpt.params_from_jax({"params": jax.device_get(grads)})
    for k in cancelled:
        assert float(torch.linalg.norm(params[k].grad)) < 1e-6, k
        assert float(torch.linalg.norm(want_g[k])) < 1e-6, k
    _assert_grads(model, grads, [k for k in heads if k not in cancelled],
                  lambda k: 1e-2 if train_bn and k.startswith(
                      "mask_head.mrcnn_mask_") else 1e-4)
    _assert_params(model, jnew, names)
    for k in names:
        if k in heads:
            continue
        assert params[k].grad is None, k
        same = torch.equal(params[k], before[k])
        assert same == any("bn" in s for s in k.split(".")), k
    got = _leaves(T_ckpt.params_to_jax(model.state_dict())["batch_stats"])
    want, src = _leaves(jax.device_get(jstats)), _leaves(v["batch_stats"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        moved = not np.array_equal(want[k], src[k])
        assert moved == (train_bn and k.startswith(("classifier/",
                                                    "mask_head/"))), k


def test_kernel_entries_refuse_a_feature_gradient():
    """No kernel has a backward: with a feature map that requires a
    gradient, pyramid_roi_align_pallas (both branches, through the
    wrappers' input checks) and the kernel wrappers raise on CPU tensors
    too, while pyramid_roi_align_auto takes the gather and
    its gradient equals the gather's; under no_grad (or with detached
    features) the auto entry takes the padded kernel entry."""
    from m3d_torch.image_meta import compose_image_meta
    from m3d_torch.ops import roialign3d as R
    from m3d_torch.ops.roialign_compact import roialign_padded

    rng = np.random.RandomState(4)
    fms = [torch.tensor(rng.randn(2, s, s, 4, 8).astype(np.float32),
                        requires_grad=True) for s in (16, 8, 4, 2)]
    lo = rng.uniform(0.0, 0.6, (2, 5, 3))
    boxes = torch.tensor(np.concatenate([lo, lo + 0.3], -1), dtype=torch.float32)
    meta = torch.tensor(np.stack([compose_image_meta(
        i, (64, 64, 8, 1), (64, 64, 8, 1), (0, 0, 0, 64, 64, 8), 1.0,
        [1, 1]) for i in range(2)]), dtype=torch.float32)
    for slab in (None, (16, 16, 16)):   # padded kernel; tiered slab kernel
        with pytest.raises(RuntimeError, match="requires a gradient"):
            R.pyramid_roi_align_pallas(boxes, meta, fms, 3, slab=slab)
    levels = torch.zeros(10, dtype=torch.int32)
    pos = torch.zeros((10, 3, 3))
    with pytest.raises(RuntimeError, match="requires a gradient"):
        roialign_padded(levels, pos, fms, 5)
    calls = []
    real = R.pyramid_roi_align_pallas
    R.pyramid_roi_align_pallas = lambda *a: calls.append(1) or real(*a)
    try:
        out = R.pyramid_roi_align_auto(boxes, meta, fms, 3)
        assert not calls and out.requires_grad
        g_auto = torch.autograd.grad(out.square().sum(), fms[0])[0]
        g_gather = torch.autograd.grad(
            R.pyramid_roi_align(boxes, meta, fms, 3).square().sum(),
            fms[0])[0]
        assert torch.equal(g_auto, g_gather) and g_auto.abs().max() > 0
        with torch.no_grad():
            a = R.pyramid_roi_align_auto(boxes, meta, fms, 3)
        b = R.pyramid_roi_align_auto(boxes, meta, [f.detach() for f in fms],
                                     3)
        assert len(calls) == 2 and torch.equal(a, b)
        assert torch.equal(a, out.detach())
    finally:
        R.pyramid_roi_align_pallas = real


def test_cli_target_generation_then_head_training(tiny_variables, targets,
                                                  tmp_path):
    """``python -m m3d_torch --task TARGET_GENERATION`` with MODE
    "targeting" (artifacts under DATA_DIR/head_targets) returns the root
    and manifests, whose rows JAX's ToyHeadDataset reads; HEAD_TRAINING
    with MODE "training" on the target fixture's artifacts (four train
    images, two test), one epoch of two steps and one validation batch:
    every file written, the validation loss gates best.msgpack, and JAX
    restores latest.msgpack whole. A config asking for TRAIN_BN on e2e
    HEAD_TRAINING is refused as JAX refuses it."""
    from m3d.data.datasets import ToyHeadDataset as JHead
    import shutil

    data, ckpt, _, (troot, _), _ = targets
    own = str(tmp_path / "data")
    shutil.copytree(data, own, ignore=shutil.ignore_patterns("head_targets"))
    T_syn.split_dataset(own, test_ratio=0.34)     # manifests point here
    path, _ = _write_config(tmp_path, own, "tg", **dict(
        TARGET, MODE="targeting", RPN_WEIGHTS=ckpt))
    (root, man), text = _run("TARGET_GENERATION", path)
    assert root == os.path.join(own, "head_targets")
    assert man == {s: os.path.join(root, "datasets", f"{s}.csv")
                   for s in ("train", "test")}
    for split in ("train", "test"):
        n = len(_rows(man[split])) - 1
        assert f"[targeting] {split}: {n} images" in text
        jds = JHead()
        jds.load_dataset(root, is_train=split == "train")
        for i in range(n):
            assert jds.load_data(i)["rois_aligned"].dtype == np.float32
    path, wdir = _write_config(tmp_path, troot, "head", **dict(
        TARGET, MODE="training", HEAD_WEIGHTS=ckpt))
    trainer, text = _run("HEAD_TRAINING", path)
    assert "[preflight]" in text and "[HEAD][epoch 0]" in text
    assert sorted(os.listdir(wdir)) == CKPT_FILES
    (epoch,) = trainer.history
    assert len(trainer.clock.records) == 2
    assert np.isfinite(epoch["loss"]) and np.isfinite(epoch["val_loss"])
    with open(os.path.join(wdir, "best.msgpack.json")) as f:
        assert json.load(f) == {"kind": "head", "epoch": 0,
                                "metric": epoch["val_loss"]}
    loaded, _ = J_ckpt.load_params(os.path.join(wdir, "latest.msgpack"))
    _, stats = J_ckpt.restore_by_name(tiny_variables, loaded)
    assert stats["missing"] == stats["skipped"] == 0
    path, _ = _write_config(tmp_path, own, "e2e_bn", **dict(
        TARGET, MODE="training_head_e2e", RPN_WEIGHTS=ckpt, TRAIN_BN=True))
    with pytest.raises(ValueError, match="TRAIN_BN=true is not supported"):
        _run("HEAD_TRAINING", path)
