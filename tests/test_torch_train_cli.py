"""The two training tasks of the port against m3d's, at the TINY config of
tests/test_torch_models.py on the CPU (float32): one step of each task
against JAX's own train step on the same weights and the same generator
batch (gradients, metrics, parameters after the optimiser), then
``python -m m3d_torch`` for RPN_TRAINING and e2e HEAD_TRAINING, one epoch of
two steps each, with their checkpoints read back by JAX, AUTO_TUNE_RPN and
Keras ``.h5`` weights run, and the one training option not ported yet
(GPU_COUNT > 1) refused before anything is written.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m3d.config import Config
from m3d.train import checkpoints as J_ckpt
from m3d.train import optim as J_opt
from m3d.train.head import _is_frozen_for_e2e as j_frozen
from m3d_torch import __main__ as cli
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.config import Config as TConfig
from m3d_torch.data import synthetic as T_syn
from m3d_torch.train import optim as T_opt
from m3d_torch.train.head import _is_frozen_for_e2e
from test_torch_models import TINY, randomize
from test_torch_native import jax_native
from test_torch_train import _leaves, jax_tiny  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEP = dict(TINY, POST_NMS_ROIS_TRAINING=64, TRAIN_ROIS_PER_IMAGE=16,
            MAX_GT_INSTANCES=6, RPN_TRAIN_ANCHORS_PER_IMAGE=64,
            IMAGES_PER_GPU=2, RPN_POSITIVE_IOU=0.1, RPN_NEGATIVE_IOU=0.05,
            CLASS_NAMES=["object"], WEIGHT_DECAY=1e-4,
            OPTIMIZER={"name": "SGD", "parameters": {
                "learning_rate": 0.01, "momentum": 0.9, "clipnorm": 5.0}})
# A transform that returns zero updates and keeps the gradients as its
# state: JAX's own train step then hands back its gradients.
GRAB = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    """Six 64 x 64 x 8 volumes from the port's generator: four for
    training (two steps of two), two for testing (one batch)."""
    d = str(tmp_path_factory.mktemp("train_data"))
    T_syn.generate_experiment(6, 64, d, seed=21, image_depth=8)
    T_syn.split_dataset(d, test_ratio=0.34)
    return d


def _first_batches(data_dir, mode, monkeypatch):
    """The first batch of JAX's and of the port's RPNGenerator (train
    split, SEED 0) for config MODE ``mode``; they must be equal arrays."""
    from m3d.data.datasets import ToyDataset as JToy
    from m3d.data.generators import RPNGenerator as JGen
    from m3d_torch.data.datasets import ToyDataset as TToy
    from m3d_torch.data.generators import RPNGenerator as TGen

    jax_native()
    kw = dict(STEP, DATA_DIR=data_dir, MODE=mode)
    out = []
    for toy, gen, conf in ((JToy, JGen, Config), (TToy, TGen, TConfig)):
        ds = toy()
        ds.load_dataset(data_dir, is_train=True, class_names=("object",))
        ds.prepare()
        gen_mode = "training" if mode == "training" else "e2e"
        out.append(next(iter(gen(ds.filter_positive(), conf(**kw),
                                 mode=gen_mode, seed=0))))
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        assert out[1][k].dtype == out[0][k].dtype, k
        np.testing.assert_array_equal(out[1][k], out[0][k], k)
    return Config(**kw), TConfig(**kw), out[0]


def _assert_grads(model, jgrads, names, tol):
    """Each leaf's gradient within ``tol(name)`` of JAX's, as
    |g_port - g_jax| / |g_jax| (Frobenius norms)."""
    want = T_ckpt.params_from_jax({"params": jax.device_get(jgrads)})
    params = dict(model.named_parameters())
    for k in names:
        g = want[k]
        got = params[k].grad
        got = torch.zeros_like(g) if got is None else got
        err = float(torch.linalg.norm(got - g))
        assert err <= tol(k) * float(torch.linalg.norm(g)) + 1e-12, (k, err)


def _assert_params(model, jparams, names):
    """Parameters after the step within 1e-5 of each leaf's scale."""
    want = T_ckpt.params_from_jax({"params": jax.device_get(jparams)})
    params = dict(model.named_parameters())
    for k in names:
        w = want[k]
        np.testing.assert_allclose(params[k].detach().numpy(), w.numpy(),
                                   atol=1e-5 * max(1.0, float(w.abs().max())),
                                   err_msg=k)


def test_rpn_train_step_matches_jax(jax_tiny, train_data, monkeypatch):
    """One RPN_TRAINING step on the generators' first batch (equal arrays):
    losses and metrics within 1e-4 relative, every gradient against JAX's
    train step's, and the parameters after the optimiser step. Gradients:
    FPN and RPN leaves within 1e-4 in norm; ResNet leaves within 2e-2. On
    this batch the backbone's gradient is ill-conditioned: the two packages
    differ by up to 7e-3 in norm at res4c (measured), while the port's two
    CPU convolution backends agree to 2e-6 and adding uniform noise of
    1e-2 to the image brings the packages to 3e-4."""
    from m3d.train.rpn import RPNTrainer as JRPNTrainer
    from m3d_torch.data.generators import to_device
    from m3d_torch.train.rpn import RPNTrainer

    _, variables = jax_tiny
    v = randomize(variables, 13)
    jcfg, tcfg, batch = _first_batches(train_data, "training", monkeypatch)
    assert (batch["rpn_match"] == 1).sum() > 0
    params = v["params"]
    jstep = JRPNTrainer(jcfg, mode="training").make_train_step(GRAB)
    _, grads, _, jmet = jstep(jax.tree_util.tree_map(jnp.array, params),
                              GRAB.init(params), v["batch_stats"], batch)
    tx = J_opt.build_optimizer(jcfg, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    trainer = RPNTrainer(tcfg, device="cpu")
    model = trainer.model
    T_ckpt.restore_by_name(model, T_ckpt.params_from_jax(v))
    opt = T_opt.Optimizer(tcfg, dict(model.named_parameters()))
    tmet = trainer.make_train_step(opt)(to_device(batch, "cpu"))
    assert tmet.keys() == jmet.keys()
    for k in jmet:
        np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    names = [k for k, _ in model.named_parameters()]
    _assert_grads(model, grads, names,
                  lambda k: 2e-2 if k.startswith("resnet.") else 1e-4)
    _assert_params(model, jnew, names)


def test_e2e_head_step_matches_jax(jax_tiny, train_data, monkeypatch,
                                   tmp_path):
    """One e2e HEAD_TRAINING step on the generators' first batch, JAX's
    target uniforms injected: metrics within 1e-4 relative (positives
    present), the heads' gradients against JAX's step's, the heads after
    the optimiser step and MaxNorm, and the frozen trunk unchanged."""
    from m3d.train.head import HeadTrainer as JHeadTrainer
    from m3d_torch.data.generators import to_device
    from m3d_torch.train import head as T_head

    _, variables = jax_tiny
    v = randomize(variables, 13)
    ckpt = str(tmp_path / "rpn.msgpack")
    J_ckpt.save_params(ckpt, v)
    jcfg, tcfg, batch = _first_batches(train_data, "training_head_e2e",
                                       monkeypatch)
    tcfg.RPN_WEIGHTS = ckpt
    params = v["params"]
    key = jax.random.PRNGKey(5)
    jstep = JHeadTrainer(jcfg).make_e2e_step(GRAB)
    _, grads, _, jmet = jstep(jax.tree_util.tree_map(jnp.array, params),
                              GRAB.init(params), v["batch_stats"], batch, key)
    assert float(jmet["pos_count"]) > 0
    tx = J_opt.build_optimizer(jcfg, params, freeze_predicate=j_frozen)
    updates, _ = tx.update(grads, tx.init(params), params)
    jnew = J_opt.apply_constraints(optax.apply_updates(params, updates),
                                   frozen_predicate=j_frozen)

    n_prop = int(STEP["POST_NMS_ROIS_TRAINING"])
    r = [[np.asarray(jax.random.uniform(k, (n_prop,)))
          for k in jax.random.split(kb)] for kb in jax.random.split(key, 2)]
    uniforms = tuple(np.stack([ri[i] for ri in r]) for i in range(2))
    real = T_head.detection_targets_batch
    monkeypatch.setattr(T_head, "detection_targets_batch",
                        lambda *a, **k: real(*a, **dict(k, uniforms=uniforms)))
    trainer = T_head.HeadTrainer(tcfg, device="cpu")
    opt = trainer.prepare_e2e()
    model = trainer.model
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tmet = trainer.make_e2e_step(opt, None)(to_device(batch, "cpu"))
    assert tmet.keys() == jmet.keys()
    for k in jmet:
        np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    heads = [k for k in before if not _is_frozen_for_e2e(k)]
    assert len(heads) > 10 and all(k.split(".")[0] in ("classifier",
                                                       "mask_head")
                                   for k in heads)
    _assert_grads(model, grads, heads, lambda k: 1e-4)
    _assert_params(model, jnew, heads)
    for k, p in model.named_parameters():
        if _is_frozen_for_e2e(k):
            assert torch.equal(p, before[k]) and p.grad is None, k


# python -m m3d_torch ------------------------------------------------------------

def _write_config(tmp_path, data_dir, name, **keys):
    out = str(tmp_path / name)
    kw = dict(STEP, DATA_DIR=data_dir, OUTPUT_DIR=out,
              WEIGHT_DIR=os.path.join(out, "weights"), EPOCHS=1,
              EVALUATION_STEPS=1)
    kw.update(keys)
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(kw, f)
    return path, os.path.join(out, "weights")


def _run(task, path):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = cli.main(["--task", task, "--config_path", path,
                            "--device", "cpu"])
    return trainer, printed.getvalue()


CKPT_FILES = ["best.msgpack", "best.msgpack.json", "best_head.msgpack",
              "best_head.msgpack.json", "latest.msgpack",
              "latest.msgpack.json", "latest_head.msgpack",
              "latest_head.msgpack.json", "telemetry.jsonl"]


def test_cli_rpn_training_writes_checkpoints_jax_reads(train_data, jax_tiny,
                                                      tmp_path):
    """RPN_TRAINING, one epoch of two steps: every checkpoint, sidecar and
    the telemetry snapshot written; JAX's load_params + restore_by_name
    take latest.msgpack whole and it holds the trained model exactly."""
    path, wdir = _write_config(tmp_path, train_data, "rpn", MODE="training")
    trainer, text = _run("RPN_TRAINING", path)
    assert "[RPN][epoch 0]" in text
    assert sorted(os.listdir(wdir)) == CKPT_FILES
    assert len(trainer.clock.records) == 2
    assert all(np.isfinite(r["step_ms"]) for r in trainer.clock.records)
    (epoch,) = trainer.history
    assert np.isfinite(epoch["loss"]) and "det@0.5_top500" in epoch
    with open(os.path.join(wdir, "telemetry.jsonl")) as f:
        snap = json.loads(f.read())
    assert snap["epoch"] == 0 and snap["extra"]["loss"] == epoch["loss"]
    with open(os.path.join(wdir, "best.msgpack.json")) as f:
        assert json.load(f) == {"kind": "rpn", "epoch": 0,
                                "metric": epoch["detection_score"]}
    loaded, _ = J_ckpt.load_params(os.path.join(wdir, "latest.msgpack"))
    _, variables = jax_tiny
    _, stats = J_ckpt.restore_by_name(variables, loaded)
    assert stats["loaded"] == len(_leaves(variables))
    assert stats["missing"] == stats["skipped"] == 0
    state = T_ckpt.params_from_jax(loaded)
    own = trainer.model.state_dict()
    assert state.keys() == own.keys()
    assert all(torch.equal(state[k], own[k]) for k in own)
    head, _ = J_ckpt.load_params(os.path.join(wdir, "latest_head.msgpack"))
    assert _leaves(head) and all("mrcnn_" in k for k in _leaves(head))


def test_cli_e2e_head_training_trains_heads_only(train_data, jax_tiny,
                                                 tmp_path):
    """e2e HEAD_TRAINING from a JAX-saved checkpoint, one epoch of two
    steps and one validation batch: every file written; in latest.msgpack
    each non-mrcnn_ leaf (params and batch_stats) is bit-equal to the
    checkpoint's and some mrcnn_ leaf differs; best is gated on val_loss.
    A second run with FROM_EPOCH 1 resumes from best.msgpack."""
    _, variables = jax_tiny
    src = randomize(variables, 13)
    ckpt = str(tmp_path / "rpn.msgpack")
    J_ckpt.save_params(ckpt, src)
    path, wdir = _write_config(tmp_path, train_data, "e2e",
                               MODE="training_head_e2e", RPN_WEIGHTS=ckpt)
    trainer, text = _run("HEAD_TRAINING", path)
    assert "[HEAD][epoch 0]" in text
    assert sorted(os.listdir(wdir)) == CKPT_FILES
    (epoch,) = trainer.history
    assert len(trainer.clock.records) == 2
    assert np.isfinite(epoch["loss"]) and np.isfinite(epoch["val_loss"])
    with open(os.path.join(wdir, "best.msgpack.json")) as f:
        assert json.load(f)["metric"] == epoch["val_loss"]
    saved, _ = J_ckpt.load_params(os.path.join(wdir, "latest.msgpack"))
    want, got = _leaves(src), _leaves(saved)
    assert want.keys() == got.keys()
    changed = 0
    for k in want:
        if "mrcnn_" in k:
            changed += not np.array_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], want[k], k)
    assert changed > 0
    # Resume: FROM_EPOCH 1 restores WEIGHT_DIR's best.msgpack (no epoch
    # left to run).
    path2, _ = _write_config(tmp_path, train_data, "e2e",
                             MODE="training_head_e2e", RPN_WEIGHTS=ckpt,
                             FROM_EPOCH=1, EPOCHS=1)
    resumed, text = _run("HEAD_TRAINING", path2)
    assert "best.msgpack" in text and resumed.history == []
    best = T_ckpt.params_from_jax(T_ckpt.load_params(
        os.path.join(wdir, "best.msgpack"))[0])
    assert all(torch.equal(best[k], v)
               for k, v in resumed.model.state_dict().items())


UNPORTED = {
    "gpu_count_2": ("HEAD_TRAINING", dict(MODE="training_head_e2e",
                                          GPU_COUNT=2)),
    "gpu_count_2_rpn": ("RPN_TRAINING", dict(MODE="training", GPU_COUNT=2,
                                             AUTO_TUNE_RPN=True)),
    "gpu_count_4_mrcnn": ("MRCNN_TRAINING", dict(MODE="training",
                                                 GPU_COUNT=4)),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_cli_training_options_not_ported(case, tmp_path):
    """Exit naming the ROADMAP item, before any file but the config is
    read and before anything is written."""
    task, keys = UNPORTED[case]
    path, wdir = _write_config(tmp_path, str(tmp_path / "no_data"), "out",
                               **keys)
    with pytest.raises(SystemExit, match=r"not ported yet \(ROADMAP.md §1"):
        cli.main(["--task", task, "--config_path", path, "--device", "cpu"])
    assert not os.path.exists(os.path.dirname(wdir))


H5_WEIGHTS = os.path.join(REPO, "tests", "fixtures", "keras231_tiny.h5")
OPTIONS = {
    "auto_tune_rpn": ("RPN_TRAINING", dict(MODE="training",
                                           AUTO_TUNE_RPN=True)),
    "h5_weights": ("HEAD_TRAINING", dict(MODE="training_head_e2e",
                                         RPN_WEIGHTS=H5_WEIGHTS)),
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_cli_training_options_run(case, train_data, tmp_path):
    """The options refused before this slice now run one epoch through the
    CLI: AUTO_TUNE_RPN on RPN_TRAINING (the patch written as JAX writes
    it, nothing applied without AUTO_TUNE_APPLY),
    and e2e HEAD_TRAINING from the reference's Keras keras231_tiny.h5
    (every one of its 92 weights restored, its trunk kept frozen)."""
    task, keys = OPTIONS[case]
    path, wdir = _write_config(tmp_path, train_data, case, **keys)
    trainer, text = _run(task, path)
    (epoch,) = trainer.history
    assert np.isfinite(epoch["loss"])
    assert sorted(os.listdir(wdir)) == sorted(
        CKPT_FILES + (["autotune_patch.json"] if case == "auto_tune_rpn"
                      else []))
    if case == "auto_tune_rpn":
        from test_torch_autotune import check_autotune_run

        with open(path) as f:
            written = json.load(f)
        check_autotune_run(trainer, text, written, os.path.dirname(wdir),
                           train_data, tmp_path)
        return
    (line,) = [ln for ln in text.splitlines() if "] restored " in ln]
    stats = json.loads(line.split(": ", 1)[1].replace("'", '"'))
    assert stats["loaded"] == 92 and stats["skipped"] == 0, line
    want = T_ckpt.params_from_jax(T_ckpt.load_params(H5_WEIGHTS)[0])
    saved = T_ckpt.params_from_jax(T_ckpt.load_params(
        os.path.join(wdir, "latest.msgpack"))[0])
    assert torch.equal(saved["resnet.conv1.weight"],
                       want["conv1.weight"])


def test_cli_training_head_only_exits_one(tmp_path):
    """``python -m m3d_torch`` itself: a training option not ported yet
    (GPU_COUNT > 1 on RPN_TRAINING) exits 1 and writes nothing; with no
    card and no --device cpu RPN_TRAINING exits non-zero and writes
    nothing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    path, wdir = _write_config(tmp_path, str(tmp_path / "no_data"), "out",
                               MODE="training", GPU_COUNT=2)
    res = subprocess.run(
        [sys.executable, "-m", "m3d_torch", "--task", "RPN_TRAINING",
         "--config_path", path, "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 1 and "not ported yet" in res.stderr
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "m3d_torch", "--task", "RPN_TRAINING",
             "--config_path", path], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=300)
        assert res.returncode != 0 and "--device cpu" in res.stderr
    assert not os.path.exists(os.path.dirname(wdir))
