"""GPU_COUNT > 1 through ``python -m m3d_torch --device cpu``: the CLI
starts GPU_COUNT gloo ranks (m3d_torch/parallel/mesh.py ``spawn``) and
trains as one process would on the whole batch, at the TINY config of
tests/test_torch_train_cli.py; only rank 0 writes, and JAX reads the
checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from m3d.train import checkpoints as J_ckpt
from m3d_torch import __main__ as cli
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.config import Config as TConfig
from m3d_torch.data import synthetic as T_syn
from test_torch_train_cli import STEP, _write_config

MULTI_GPU = {
    "gpu_count_2": ("HEAD_TRAINING", dict(MODE="training_head_e2e",
                                          GPU_COUNT=2)),
    "gpu_count_2_rpn": ("RPN_TRAINING", dict(MODE="training", GPU_COUNT=2,
                                             AUTO_TUNE_RPN=True)),
    "gpu_count_4_mrcnn": ("MRCNN_TRAINING", dict(
        MODE="training", GPU_COUNT=4, MASK_POOL_SIZE=7,
        MASK_SHAPE=[14, 14, 14])),
}
# JAX's DP tolerance (tests/test_dp_equivalence.py), and the MRCNN step's
# ResNet leaves' (tests/test_torch_parallel.py: MRCNN_RESNET_ATOL).
DP_RTOL, DP_ATOL, DP_LOSS, MRCNN_RESNET_ATOL = 2e-5, 2e-6, 1e-5, 1e-5


@pytest.fixture(scope="module")
def gpu_data(tmp_path_factory):
    """Datasets of one training step an epoch at the GPU_COUNT cases'
    batches: two training and two test 64 x 64 x 8 volumes (a batch of two
    each), and five training volumes and one test (MRCNN_TRAINING's 80/20
    split keeps four). One step: a second step amplifies float32 noise past
    the DP tolerance (one process alone moves mrcnn_class_logits by 1.0e-5
    between 1 and 8 CPU threads after two e2e steps, measured)."""
    out = {}
    for name, n, ratio in (("pairs", 4, 0.5), ("mrcnn", 6, 0.1)):
        d = str(tmp_path_factory.mktemp(f"gpu_{name}"))
        T_syn.generate_experiment(n, 64, d, seed=23, image_depth=8)
        T_syn.split_dataset(d, test_ratio=ratio)
        out[name] = d
    return out


@pytest.mark.parametrize("case", sorted(MULTI_GPU))
def test_cli_gpu_count_training(case, gpu_data, tmp_path):
    """GPU_COUNT > 1 with IMAGES_PER_GPU 1 through ``python -m m3d_torch
    --device cpu``: the CLI starts GPU_COUNT gloo ranks, each on its rows of
    every batch, and trains one epoch of one step (``gpu_data``) and its
    validation; its latest.msgpack holds the
    parameters of the one-process run at IMAGES_PER_GPU = GPU_COUNT within
    JAX's DP tolerance (the MRCNN run's ResNet leaves within
    MRCNN_RESNET_ATOL), with the first step's loss; rank 0 alone wrote the
    files (the same set as one process, one telemetry line), and JAX's
    ``load_params`` reads the checkpoint whole."""
    task, keys = MULTI_GPU[case]
    n = keys["GPU_COUNT"]
    data = gpu_data["mrcnn" if task == "MRCNN_TRAINING" else "pairs"]
    if keys["MODE"] == "training_head_e2e" or task == "MRCNN_TRAINING":
        from m3d_torch.models.mask_rcnn import MaskRCNN, init_params

        model = MaskRCNN.from_config(TConfig(**STEP), mode="training",
                                     device="cpu")
        init_params(model, 13)
        keys = dict(keys, RPN_WEIGHTS=str(tmp_path / "src.msgpack"))
        T_ckpt.save_params(keys["RPN_WEIGHTS"],
                           T_ckpt.params_to_jax(model.state_dict()))
    runs, threads = {}, torch.get_num_threads()
    for name, kw in (("ranks", dict(keys, IMAGES_PER_GPU=1)),
                     ("one", dict(keys, IMAGES_PER_GPU=n, GPU_COUNT=1))):
        path, wdir = _write_config(tmp_path, data, name, **kw)
        # The reference on one thread: oneDNN's threaded reductions alone
        # move the e2e step's heads by 2.6e-6 (measured, 1 vs 8 threads),
        # above JAX's DP atol.
        torch.set_num_threads(1 if name == "one" else threads)
        try:
            runs[name] = (cli.main(["--task", task, "--config_path", path,
                                    "--device", "cpu"]), wdir)
        finally:
            torch.set_num_threads(threads)
    (ranks, wdir), (one, wdir_one) = runs["ranks"], runs["one"]
    assert ranks.world_size == n and len(ranks.records) == \
        len(one.clock.records) == 1
    assert sorted(os.listdir(wdir)) == sorted(os.listdir(wdir_one))
    with open(os.path.join(wdir, "telemetry.jsonl")) as f:
        assert len(f.read().splitlines()) == 1
    assert len(ranks.history) == len(one.history) == 1
    np.testing.assert_allclose(ranks.records[0]["loss"],
                               one.clock.records[0]["loss"], rtol=DP_LOSS)
    saved = J_ckpt.load_params(os.path.join(wdir, "latest.msgpack"))[0]
    state = T_ckpt.params_from_jax(saved)
    ref = one.model.state_dict()
    assert state.keys() == ref.keys()
    for k, v in ref.items():
        atol = (MRCNN_RESNET_ATOL if task == "MRCNN_TRAINING"
                and k.startswith("resnet.") else DP_ATOL)
        np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                   rtol=DP_RTOL, atol=atol, err_msg=k)
