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
checkpoint or a reference Keras ``.h5`` (read without h5py). The one
training option not ported yet, GPU_COUNT > 1, exits non-zero naming the
ROADMAP.md item that brings it, having read nothing but the config. The
model runs on the
card unless ``--device cpu`` is given; with no card and no ``--device
cpu`` the command exits non-zero before it reads or writes anything.
``main(argv)`` returns the task's result (MRCNN_EVALUATION: {"summary",
"per_image", "times"}; RPN_EVALUATION: the metrics dict;
TARGET_GENERATION: the pair (output root, {split: manifest path}); the
training tasks: the trainer, whose ``model`` is trained and whose
``history`` and ``clock.records`` hold each epoch's metrics and each
step's times), so a caller in the same process can read the kernels'
launch counters after it.
"""

from __future__ import annotations

import argparse
import json

import torch

TASKS = (
    "RPN_TRAINING",
    "RPN_EVALUATION",
    "TARGET_GENERATION",
    "HEAD_TRAINING",
    "MRCNN_TRAINING",
    "MRCNN_EVALUATION",
)
TRAINING = ("RPN_TRAINING", "TARGET_GENERATION", "HEAD_TRAINING",
            "MRCNN_TRAINING")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m m3d_torch",
        description="m3d 3D Mask R-CNN, PyTorch/CUDA port")
    parser.add_argument("--task", required=True, choices=TASKS)
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--summary", action="store_true",
                        help="print the config and model summary, then exit")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (default: the card)")
    args = parser.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(no usable NVIDIA card); pass --device cpu to run "
                         "on the CPU")

    from m3d_torch.config import load_config, unported_training

    config = load_config(args.config_path)
    if args.task in TRAINING:
        why = unported_training(args.task, config)
        if why:
            raise SystemExit(f"{args.task}: {why}; run it with main.py")
    if args.summary:
        config.display()

    if args.task == "RPN_TRAINING":
        from m3d_torch.train.rpn import RPNTrainer

        trainer = RPNTrainer(config, device=args.device)
        if not args.summary:
            trainer.history = trainer.train()[1]
        return trainer

    if args.task == "TARGET_GENERATION":
        from m3d_torch.train.rpn import RPNTrainer

        trainer = RPNTrainer(config, device=args.device)
        if args.summary:
            return None
        return trainer.head_target_generation()

    if args.task == "HEAD_TRAINING":
        from m3d_torch.train.head import HeadTrainer

        trainer = HeadTrainer(config, device=args.device)
        if not args.summary:
            train = (trainer.train_e2e if config.MODE == "training_head_e2e"
                     else trainer.train_head_only)
            trainer.history = train()[1]
        return trainer

    if args.task == "MRCNN_TRAINING":
        from m3d_torch.train.mrcnn import MrcnnTrainer

        trainer = MrcnnTrainer(config, device=args.device)
        if not args.summary:
            trainer.history = trainer.train()[1]
        return trainer

    if args.task == "RPN_EVALUATION":
        from m3d_torch.train.rpn import RPNTrainer
        from m3d_torch.utils.metrics import rpn_evaluation

        trainer = RPNTrainer(config, device=args.device)
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

    trainer = MrcnnTrainer(config, device=args.device)
    if args.summary:
        return None
    summary, per_image = trainer.evaluate()
    return {"summary": summary, "per_image": per_image,
            "times": trainer.times}


if __name__ == "__main__":
    main()
