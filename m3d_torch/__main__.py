"""CLI task dispatcher of the port (the surface of main.py).

    python -m m3d_torch --task {RPN_TRAINING, RPN_EVALUATION,
                                TARGET_GENERATION, HEAD_TRAINING,
                                MRCNN_TRAINING, MRCNN_EVALUATION}
                        --config_path configs/....json [--summary]
                        [--device {cuda,cpu}]

The same JSON configs, on-disk datasets and artifacts as main.py; all six
tasks are ported. HEAD_TRAINING runs e2e with MODE "training_head_e2e" and
head-only (from TARGET_GENERATION's artifacts) with any other MODE, as
main.py dispatches it. RPN_TRAINING runs AUTO_TUNE_RPN (and applies its
patch under AUTO_TUNE_APPLY); every ``*_WEIGHTS`` key takes a flax msgpack
checkpoint or a reference Keras ``.h5`` (read without h5py). The model runs
on the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` the command exits non-zero before it reads or writes
anything.

GPU_COUNT > 1 (or DEVICES_PER_HOST) on a training task is data parallel
over that many ranks, one process each (m3d_torch/parallel/mesh.py), and
trains as one process would on the whole batch of IMAGES_PER_GPU x
GPU_COUNT. Started as above, the command starts the ranks itself (the
spawn start method; NCCL between cards, gloo on the CPU with ``--device
cpu``) where JAX's one process would take the devices: the port's
departure, since a rank is a process here. Under ``torchrun`` (WORLD_SIZE
in the environment) it joins the ranks it is given instead, and refuses a
world size that differs from the config's, naming both. With fewer cards
than ranks it exits non-zero, naming both numbers. Only rank 0 prints and
writes files. The other tasks run in one process whatever GPU_COUNT is, as
JAX's do.

``main(argv)`` returns the task's result (MRCNN_EVALUATION: {"summary",
"per_image", "times"}; RPN_EVALUATION: the metrics dict;
TARGET_GENERATION: the pair (output root, {split: manifest path}); the
training tasks: the trainer, whose ``model`` is trained and whose
``history`` and ``clock.records`` hold each epoch's metrics and each
step's times; a training task over ranks it started: a namespace of rank
0's ``history`` and ``records`` and the ``world_size``), so a caller in the
same process can read the kernels' launch counters after it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import torch

TASKS = (
    "RPN_TRAINING",
    "RPN_EVALUATION",
    "TARGET_GENERATION",
    "HEAD_TRAINING",
    "MRCNN_TRAINING",
    "MRCNN_EVALUATION",
)
DATA_PARALLEL = ("RPN_TRAINING", "HEAD_TRAINING", "MRCNN_TRAINING")


def _parse(argv):
    parser = argparse.ArgumentParser(
        prog="python -m m3d_torch",
        description="m3d 3D Mask R-CNN, PyTorch/CUDA port")
    parser.add_argument("--task", required=True, choices=TASKS)
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--summary", action="store_true",
                        help="print the config and model summary, then exit")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (default: the card)")
    return parser.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(no usable NVIDIA card); pass --device cpu to run "
                         "on the CPU")

    from m3d_torch.config import load_config
    from m3d_torch.parallel.mesh import mesh_size

    config = load_config(args.config_path)
    ranks = mesh_size(config) if args.task in DATA_PARALLEL else 1
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != ranks:
            raise SystemExit(
                f"{args.task}: torchrun started {world} ranks but the "
                f"config's mesh has {ranks} (GPU_COUNT / DEVICES_PER_HOST)")
        if world > 1 or args.task in DATA_PARALLEL:
            return _join(args, config)
    elif ranks > 1 and not args.summary:
        return _start_ranks(args, argv, ranks)
    return run_task(args, config, args.device)


def _rank_device(args, local_rank: int):
    return (torch.device("cuda", local_rank) if args.device == "cuda"
            else torch.device("cpu"))


def _join(args, config):
    """Join the process group torchrun set up and run the task as rank
    RANK on card LOCAL_RANK; only rank 0 prints."""
    import torch.distributed as dist

    from m3d_torch.parallel.mesh import backend_for

    device = _rank_device(args, int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device))
    try:
        if dist.get_rank() != 0:
            sys.stdout = open(os.devnull, "w")
        return run_task(args, config, device)
    finally:
        dist.destroy_process_group()


def _start_ranks(args, argv, ranks: int):
    """Start ``ranks`` processes, each running the task as one rank, and
    return rank 0's history and step records."""
    from m3d_torch.parallel.mesh import spawn

    if args.device == "cuda" and torch.cuda.device_count() < ranks:
        raise SystemExit(f"{args.task}: the config's mesh has {ranks} ranks "
                         f"(GPU_COUNT / DEVICES_PER_HOST) but "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")
    devices = [_rank_device(args, r) for r in range(ranks)]
    out = spawn(_rank_task, ranks, devices, args=(argv,))
    return types.SimpleNamespace(world_size=ranks, **out[0])


def _rank_task(rank: int, argv):
    """One rank started by ``_start_ranks``: the task, its history and step
    records returned (the model stays in the process)."""
    from m3d_torch.config import load_config

    args = _parse(argv)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    trainer = run_task(args, load_config(args.config_path),
                       _rank_device(args, rank))
    sys.stdout.flush()
    return {"history": trainer.history, "records": trainer.clock.records}


def run_task(args, config, device):
    """The task of ``args`` with ``config`` on ``device``."""
    if args.summary:
        config.display()

    if args.task == "RPN_TRAINING":
        from m3d_torch.train.rpn import RPNTrainer

        trainer = RPNTrainer(config, device=device)
        if not args.summary:
            trainer.history = trainer.train()[1]
        return trainer

    if args.task == "TARGET_GENERATION":
        from m3d_torch.train.rpn import RPNTrainer

        trainer = RPNTrainer(config, device=device)
        if args.summary:
            return None
        return trainer.head_target_generation()

    if args.task == "HEAD_TRAINING":
        from m3d_torch.train.head import HeadTrainer

        trainer = HeadTrainer(config, device=device)
        if not args.summary:
            train = (trainer.train_e2e if config.MODE == "training_head_e2e"
                     else trainer.train_head_only)
            trainer.history = train()[1]
        return trainer

    if args.task == "MRCNN_TRAINING":
        from m3d_torch.train.mrcnn import MrcnnTrainer

        trainer = MrcnnTrainer(config, device=device)
        if not args.summary:
            trainer.history = trainer.train()[1]
        return trainer

    if args.task == "RPN_EVALUATION":
        from m3d_torch.train.rpn import RPNTrainer
        from m3d_torch.utils.metrics import rpn_evaluation

        trainer = RPNTrainer(config, device=device)
        if args.summary:
            return None
        trainer.init_variables()
        predict = trainer.make_proposal_fn()
        _, test_ds = trainer.prepare_datasets()
        metrics = rpn_evaluation(predict, test_ds, config,
                                 max_images=int(config.EVALUATION_STEPS))
        print(json.dumps(metrics, indent=2))
        return metrics

    from m3d_torch.train.mrcnn import MrcnnTrainer

    trainer = MrcnnTrainer(config, device=device)
    if args.summary:
        return None
    summary, per_image = trainer.evaluate()
    return {"summary": summary, "per_image": per_image,
            "times": trainer.times}


if __name__ == "__main__":
    main()
