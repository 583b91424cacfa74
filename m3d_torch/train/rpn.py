"""RPN training and evaluation (port of ``RPNTrainer`` in m3d/train/rpn.py,
without head-target generation, which is not ported yet: ROADMAP.md §1).

The model is built as JAX builds it, with ``mode="training"`` (so
POST_NMS_ROIS_TRAINING sets the proposal count). BatchNorm runs on its
running statistics (TRAIN_BN false; true is refused).

``train``: loss = 1.0 rpn_class + 1.5 rpn_bbox (the reference's fixed
weights, overridable by LOSS_WEIGHTS' ``rpn_*_loss_override``), the
optimiser over every parameter (the heads' only through weight decay, as
in JAX), then per epoch ``rpn_evaluation`` on the test split, which gates
``BestAndLatest`` (maximise the summed detection score), ReduceLROnPlateau,
EarlyStopping and a telemetry snapshot.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from m3d_torch.anchors import normalized_pyramid_anchors
from m3d_torch.checkpoints import (BestAndLatest, load_params,
                                   params_from_jax, params_to_jax,
                                   restore_by_name)
from m3d_torch.config import unported_training
from m3d_torch.data.datasets import ToyDataset
from m3d_torch.data.generators import RPNGenerator, prefetch_to_device
from m3d_torch.models import losses as L
from m3d_torch.models.mask_rcnn import MaskRCNN, init_params
from m3d_torch.train.optim import (EarlyStopping, ReduceLROnPlateau,
                                   Optimizer, get_learning_rate,
                                   set_learning_rate)
from m3d_torch.train.profiling import EpochProfiler, StepClock
from m3d_torch.train.telemetry import Telemetry
from m3d_torch.utils.metrics import rpn_evaluation


EVAL_IMAGES = 8   # test volumes of each epoch's rpn_evaluation, as in JAX


def read_metrics(metrics: dict) -> dict:
    """Scalar tensors -> floats, in one transfer to the host."""
    vals = torch.stack([v.detach().float().reshape(()) for v in
                        metrics.values()]).cpu().tolist()
    return dict(zip(metrics, vals))


class RPNTrainer:
    def __init__(self, config, device="cuda"):
        self.config = config
        h, w = int(config.IMAGE_SHAPE[0]), int(config.IMAGE_SHAPE[1])
        if h % 64 or w % 64:
            raise ValueError("IMAGE_SHAPE height & width must be multiples of 64")
        self.device = torch.device(device)
        self.model = MaskRCNN.from_config(config, mode="training",
                                          device=self.device).eval()
        self.anchors = normalized_pyramid_anchors(
            config, voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0))
        )
        self.telemetry = Telemetry(config)
        self.clock = StepClock(self.device)

    def prepare_datasets(self):
        cfg = self.config
        train = ToyDataset()
        train.load_dataset(cfg.DATA_DIR, is_train=True,
                           class_names=tuple(cfg.CLASS_NAMES))
        train.prepare()
        train = train.filter_positive()
        test = ToyDataset()
        test.load_dataset(cfg.DATA_DIR, is_train=False,
                          class_names=tuple(cfg.CLASS_NAMES))
        test.prepare()
        test = test.filter_positive()
        return train, test

    def init_variables(self):
        """Seeded weights (SEED), then RPN_WEIGHTS restored by name.
        Returns the model."""
        init_params(self.model, int(getattr(self.config, "SEED", 0)))
        weights = getattr(self.config, "RPN_WEIGHTS", None)
        if weights:
            tree, _ = load_params(weights)
            stats = restore_by_name(self.model, params_from_jax(tree))
            print(f"[RPNTrainer] restored {weights}: {stats}")
        return self.model

    def make_train_step(self, opt):
        """batch (tensors on the device) -> metrics (floats): one forward,
        backward and optimiser step."""
        model, lw = self.model, self.config.LOSS_WEIGHTS
        w_class = float(lw.get("rpn_class_loss_override", 1.0))
        w_bbox = float(lw.get("rpn_bbox_loss_override", 1.5))

        def train_step(batch):
            for p in model.parameters():
                p.grad = None
            out = model.forward_rpn_train(batch["image"])
            lc, mc = L.rpn_class_loss(batch["rpn_match"],
                                      out["rpn_class_logits"])
            lb, mb = L.rpn_bbox_loss(batch["rpn_bbox"], batch["rpn_match"],
                                     out["rpn_bbox"])
            loss = w_class * lc + w_bbox * lb
            loss.backward()
            opt.step()
            return read_metrics({**mc, **mb, "loss": loss})

        return train_step

    def make_proposal_fn(self):
        """image [1, H, W, D, C] (numpy) -> (proposals [P, 6] normalized,
        valid [P]) as host numpy arrays."""
        model = self.model
        anchors = torch.as_tensor(self.anchors, device=self.device)

        def predict(image):
            out = model.forward_rpn(
                torch.as_tensor(image, device=self.device), anchors)
            return (out["proposals"][0].float().cpu().numpy(),
                    out["proposals_valid"][0].cpu().numpy())

        return predict

    def train(self):
        """One pass of the generator per epoch (len(gen) steps), the epoch
        evaluation on up to EVAL_IMAGES test volumes. Returns (model,
        history of epoch metrics)."""
        cfg = self.config
        why = unported_training("RPN_TRAINING", cfg)
        if why:
            raise NotImplementedError(why)
        train_ds, test_ds = self.prepare_datasets()
        gen = RPNGenerator(train_ds, cfg, mode="training",
                           seed=int(getattr(cfg, "SEED", 0)),
                           telemetry=self.telemetry)
        model = self.init_variables()
        params = dict(model.named_parameters())
        opt = Optimizer(cfg, params)
        train_step = self.make_train_step(opt)

        save_dir = cfg.WEIGHT_DIR or os.path.join(cfg.OUTPUT_DIR, "weights")
        ckpt = BestAndLatest(save_dir, mode="max")
        reduce_lr = ReduceLROnPlateau(mode="max")
        early = EarlyStopping(patience=15, mode="max")
        steps = len(gen)
        it = prefetch_to_device(iter(gen), self.device,
                                int(getattr(cfg, "PREFETCH_BUFFERS", 2)))
        profiler = EpochProfiler(cfg)
        history = []
        lr = get_learning_rate(opt)
        for epoch in range(int(cfg.FROM_EPOCH), int(cfg.EPOCHS)):
            t0 = time.time()
            profiler.maybe_start(epoch)
            agg: dict[str, list] = {}
            for _ in range(steps):
                metrics = self.clock.run(train_step, self.clock.take(it))
                for k, v in metrics.items():
                    agg.setdefault(k, []).append(v)
            profiler.maybe_stop(epoch)
            epoch_metrics = {k: float(np.mean(v)) for k, v in agg.items()}

            # Proposal quality on the test split; telemetry gets the
            # proposal / GT geometry.
            epoch_metrics.update(rpn_evaluation(
                self.make_proposal_fn(), test_ds, cfg, max_images=EVAL_IMAGES,
                telemetry=self.telemetry))
            score = epoch_metrics["detection_score"]
            ckpt.update(epoch, params_to_jax(model.state_dict()), score,
                        metadata={"kind": "rpn", "epoch": epoch})
            new_lr = reduce_lr.update(score, lr)
            if new_lr != lr:
                lr = new_lr
                set_learning_rate(opt, lr)
            epoch_metrics["lr"] = lr
            self.telemetry.snapshot_and_reset(epoch, save_dir,
                                              extra=epoch_metrics)
            print(f"[RPN][epoch {epoch}] loss={epoch_metrics['loss']:.4f} "
                  f"det_score={score:.1f} lr={lr:.2e} "
                  f"({time.time() - t0:.1f}s)")
            history.append(epoch_metrics)
            if early.update(score):
                print("[RPN] early stopping")
                break
        return model, history
