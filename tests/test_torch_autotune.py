"""The port's AutoTune (m3d_torch/train/autotune.py) against m3d's: the
snapping and robust-std helpers, ``autotune_rpn``'s patch and its
autotune_patch.json byte for byte on a seeded synthetic dataset read by
each package's own ToyDataset, ``head_evaluation``, and RPN_TRAINING with
AUTO_TUNE_RPN and AUTO_TUNE_APPLY through ``python -m m3d_torch`` (the
patch file equal to JAX's, the trainer's anchors and RPN head those of the
patched config; ``check_autotune_run``, which
tests/test_torch_train_cli.py also runs without AUTO_TUNE_APPLY).
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3d.anchors import normalized_pyramid_anchors as j_anchors
from m3d.config import Config
from m3d.data.datasets import ToyDataset as JToy
from m3d.train import autotune as J_at
from m3d_torch import __main__ as cli
from m3d_torch.config import Config as TConfig
from m3d_torch.data import synthetic as T_syn
from m3d_torch.data.datasets import ToyDataset as TToy
from m3d_torch.train import autotune as T_at
from test_torch_train_cli import STEP


@pytest.fixture(scope="module")
def tune_data(tmp_path_factory):
    """Three 64 x 64 x 8 volumes from the port's generator (two train, one
    test: one training step of two)."""
    d = str(tmp_path_factory.mktemp("tune_data"))
    T_syn.generate_experiment(3, 64, d, seed=31, image_depth=8)
    T_syn.split_dataset(d, test_ratio=0.34)
    return d


def _train_split(toy, data_dir):
    ds = toy()
    ds.load_dataset(data_dir, is_train=True, class_names=("object",))
    ds.prepare()
    return ds.filter_positive()


@pytest.mark.parametrize("values", [[3.0, 7.9, 8.1, 40.0, 1e9],
                                    [0.0, -2.0, np.nan, 0.011, 0.03]])
def test_snap_and_robust_std_match_jax(values):
    for args in ((8.0, 8.0, 64, 8), (0.02, 0.04, 0.30, 3)):
        assert T_at._snap(values, *args) == J_at._snap(values, *args)
    x = np.nan_to_num(np.asarray(values))
    assert T_at._robust_std(x) == J_at._robust_std(x)
    assert T_at._robust_std([]) == J_at._robust_std([]) == 0.2


CASES = {"config_ratio_range": {},
         "wide_ratio_range": dict(AUTO_TUNE_RATIO_RANGE=[0.02, 2.0],
                                  AUTO_TUNE_SCALES_LIMIT=3),
         "no_patch_file": dict(AUTO_TUNE_SAVE_PATCH=False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_autotune_rpn_matches_jax(case, tune_data, tmp_path):
    """The same patch dict and printout, and autotune_patch.json equal to
    JAX's byte for byte (or written by neither)."""
    out = {}
    for name, toy, conf in (("jax", JToy, Config), ("port", TToy, TConfig)):
        wdir = str(tmp_path / name)
        cfg = conf(**dict(STEP, WEIGHT_DIR=wdir, **CASES[case]))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            at = J_at if name == "jax" else T_at
            patch = at.autotune_rpn(_train_split(toy, tune_data), cfg)
        path = os.path.join(wdir, "autotune_patch.json")
        blob = open(path, "rb").read() if os.path.exists(path) else None
        out[name] = (patch, printed.getvalue(), blob)
    assert out["port"] == out["jax"]
    patch, _, blob = out["port"]
    assert set(patch) == {"RPN_ANCHOR_SCALES", "RPN_ANCHOR_RATIOS",
                          "RPN_POSITIVE_IOU", "RPN_BBOX_STD_DEV"}
    assert (blob is None) == (case == "no_patch_file")
    assert T_at.autotune_rpn(_train_split(TToy, tune_data), TConfig(**STEP),
                             max_images=0, verbose=False) == {}


def test_head_evaluation_matches_jax():
    losses = [{"mrcnn_class_loss": 0.5 + i, "mrcnn_mask_loss": 0.25 * i}
              for i in range(4)]
    want = J_at.head_evaluation(
        lambda b: {k: jnp.asarray(v) for k, v in losses[b].items()},
        iter(range(4)), 3)
    got = T_at.head_evaluation(
        lambda b: {k: torch.tensor(v) for k, v in losses[b].items()},
        iter(range(4)), 3)
    assert got == want and len(got) == 4


def check_autotune_run(trainer, text, keys, out, data_dir, tmp_path):
    """A CLI RPN_TRAINING run with AUTO_TUNE_RPN: its autotune_patch.json
    equals JAX's autotune_rpn's on the same data; with AUTO_TUNE_APPLY the
    trainer's anchors, its RPN head's width and its config are the patched
    config's, without it they are not touched."""
    apply = bool(keys.get("AUTO_TUNE_APPLY", False))
    jdir = str(tmp_path / "jax")
    jcfg = Config(**dict(keys, WEIGHT_DIR=jdir))
    with contextlib.redirect_stdout(io.StringIO()):
        patch = J_at.autotune_rpn(_train_split(JToy, data_dir), jcfg)
    assert "[AutoTuneRPN] recommended config patch:" in text
    name = "autotune_patch.json"
    with open(os.path.join(out, "weights", name), "rb") as a, \
            open(os.path.join(jdir, name), "rb") as b:
        assert a.read() == b.read()
    (epoch,) = trainer.history
    assert np.isfinite(epoch["loss"])
    want_cfg = Config(**dict(keys, **patch)) if apply else Config(**keys)
    want = j_anchors(want_cfg)
    assert trainer.anchors.shape == want.shape
    np.testing.assert_array_equal(trainer.anchors, want)
    ratios = len(want_cfg.RPN_ANCHOR_RATIOS)
    raw = dict(trainer.model.named_parameters())["rpn.rpn_class_raw.weight"]
    assert raw.shape[0] == 2 * ratios
    assert ("[AutoTuneRPN] applied patch" in text) == apply
    for k, v in patch.items():
        have = np.asarray(getattr(trainer.config, k)).tolist()
        base = np.asarray(getattr(TConfig(**keys), k)).tolist()
        assert have == (v if apply else base), k
    return patch


def test_cli_rpn_training_with_autotune_apply(tune_data, tmp_path):
    """RPN_TRAINING with AUTO_TUNE_RPN and AUTO_TUNE_APPLY through the CLI,
    one epoch (``check_autotune_run``; without AUTO_TUNE_APPLY:
    tests/test_torch_train_cli.py::test_cli_training_options_run)."""
    keys = dict(STEP, DATA_DIR=tune_data, AUTO_TUNE_RPN=True,
                AUTO_TUNE_APPLY=True, EPOCHS=1, EVALUATION_STEPS=1,
                MODE="training")
    out = str(tmp_path / "out")
    path = str(tmp_path / "tune.json")
    with open(path, "w") as f:
        json.dump(dict(keys, OUTPUT_DIR=out,
                       WEIGHT_DIR=os.path.join(out, "weights")), f)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = cli.main(["--task", "RPN_TRAINING", "--config_path", path,
                            "--device", "cpu"])
    patch = check_autotune_run(trainer, printed.getvalue(), keys, out,
                               tune_data, tmp_path)
    assert len(patch["RPN_ANCHOR_RATIOS"]) != len(STEP["RPN_ANCHOR_RATIOS"])
