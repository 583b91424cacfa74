"""Head training (port of ``HeadTrainer`` in m3d/train/head.py): head-only
from TARGET_GENERATION's artifacts, and end to end.

Head-only (any MODE but "training_head_e2e"): ``HeadGenerator`` batches of
the pre-aligned features, a target-quality preflight over the first
batches that raises on degenerate targets, and the heads trained on them
(BatchNorm on batch statistics under TRAIN_BN). As in JAX the optimiser
covers every leaf: the trunk gets no gradient, but weight decay and
momentum move its decayed kernels. Up to 4 validation batches an epoch.

e2e (MODE "training_head_e2e"): the frozen backbone, FPN and RPN make live
proposals; ``detection_targets_batch`` samples them into fixed-T targets;
both ROIAligns run on the detached feature maps through
``pyramid_roi_align_auto`` (the padded kernel on the card); the classifier
and mask heads train on them. Only the ``mrcnn_*`` leaves get updates and
MaxNorm constraints (``_is_frozen_for_e2e``). TRAIN_BN is refused, as JAX
refuses it. Up to 2 validation batches an epoch, their targets drawn with
a fixed seed (SEED + 99).

Losses are weighted by LOSS_WEIGHTS; the validation loss (or the training
loss without a validation split) gates ``BestAndLatest`` (minimise),
ReduceLROnPlateau and EarlyStopping.

GPU_COUNT > 1 (m3d_torch/parallel/mesh.py): each rank takes its rows of
every training and validation batch and of the targets' uniforms; the
losses read the whole batch's head outputs and targets (gathered over
``data``), the gradients are summed over the ranks, so every rank makes one
process's update and sees the whole batch's metrics. Rank 0 alone writes
checkpoints and telemetry.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from m3d_torch.anchors import normalized_pyramid_anchors
from m3d_torch.checkpoints import (BestAndLatest, params_to_jax,
                                   restore_weights)
from m3d_torch.data.datasets import ToyDataset, ToyHeadDataset
from m3d_torch.data.generators import (HeadGenerator, RPNGenerator,
                                       prefetch_to_device, to_device)
from m3d_torch.models import losses as L
from m3d_torch.models.detection_targets import detection_targets_batch
from m3d_torch.models.mask_rcnn import MaskRCNN, init_params
from m3d_torch.ops.roialign3d import pyramid_roi_align_auto
from m3d_torch.parallel.mesh import (make_mesh, replicate, scale_loss,
                                     shard_batch, sync_grads)
from m3d_torch.train.optim import (EarlyStopping, ReduceLROnPlateau,
                                   Optimizer, apply_constraints,
                                   get_learning_rate, set_learning_rate)
from m3d_torch.train.profiling import EpochProfiler, StepClock
from m3d_torch.train.rpn import read_metrics
from m3d_torch.train.telemetry import Telemetry

E2E_VAL_STEPS = 2        # validation batches per epoch at most, as JAX's
HEAD_ONLY_VAL_STEPS = 4  # e2e and head-only runs take


def _is_frozen_for_e2e(path: str) -> bool:
    """Everything but the mrcnn_* heads is frozen ("/" or "." paths)."""
    return not any(seg.startswith("mrcnn_")
                   for seg in path.replace("/", ".").split("."))


def head_losses(config, outputs, batch, active_class_ids, data=None):
    """The weighted head losses and their metrics. ``data``: the mesh axis
    whose ranks hold the other rows of the batch; the losses then read the
    whole batch's outputs and targets."""
    if data is not None:
        outputs = {k: data.all_gather(v) for k, v in outputs.items()}
        batch = {k: data.all_gather(batch[k]) for k in (
            "target_class_ids", "target_bbox", "target_mask")}
        active_class_ids = data.all_gather(active_class_ids)
    lw = config.LOSS_WEIGHTS
    lc, mc = L.mrcnn_class_loss(batch["target_class_ids"],
                                outputs["mrcnn_class_logits"],
                                active_class_ids)
    lb, mb = L.mrcnn_bbox_loss(batch["target_bbox"],
                               batch["target_class_ids"],
                               outputs["mrcnn_bbox"])
    lm, mm = L.mrcnn_mask_loss(batch["target_mask"],
                               batch["target_class_ids"],
                               outputs["mrcnn_masks"])
    loss = (float(lw.get("mrcnn_class_loss", 1.0)) * lc
            + float(lw.get("mrcnn_bbox_loss", 1.0)) * lb
            + float(lw.get("mrcnn_mask_loss", 1.0)) * lm)
    return loss, {**mc, **mb, **mm, "loss": loss}


class HeadTrainer:
    def __init__(self, config, device="cuda", mesh=None):
        self.config = config
        self._mesh = mesh
        self.device = torch.device(device)
        self.model = MaskRCNN.from_config(config, mode="training",
                                          device=self.device).eval()
        self.telemetry = Telemetry(config)
        self.anchors = normalized_pyramid_anchors(
            config, voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0))
        )
        self._anchors_dev = torch.as_tensor(self.anchors, device=self.device)
        self.clock = StepClock(self.device)

    @property
    def mesh(self):
        """The data-parallel mesh (``make_mesh(config)``), made at first
        use."""
        if self._mesh is None:
            self._mesh = make_mesh(self.config)
        return self._mesh

    def init_variables(self, require_rpn=False):
        """Seeded weights (SEED), then RPN_WEIGHTS and HEAD_WEIGHTS restored
        by name; with FROM_EPOCH > 0, WEIGHT_DIR's best.msgpack on top.
        Returns the model."""
        cfg = self.config
        init_params(self.model, int(getattr(cfg, "SEED", 0)))
        rpn_weights = getattr(cfg, "RPN_WEIGHTS", None)
        if require_rpn and not rpn_weights:
            raise ValueError("RPN_WEIGHTS is required for e2e head training "
                             "(reference: core/models.py:4572-4576)")
        paths = [rpn_weights, getattr(cfg, "HEAD_WEIGHTS", None)]
        best = os.path.join(cfg.WEIGHT_DIR or "", "best.msgpack")
        if int(cfg.FROM_EPOCH) > 0 and os.path.exists(best):
            paths.append(best)
        for path in paths:
            if path:
                stats = restore_weights(self.model, path)
                print(f"[HeadTrainer] restored {path}: {stats}")
        return replicate(self.mesh, self.model)

    # Head-only ---------------------------------------------------------
    def preflight_targets(self, gen, num_batches: int = 10):
        """Raise on degenerate targets in the first ``num_batches`` batches
        (core/models.py:4730-4821): no positive ROI at all, or positive
        target masks with a mean coverage below 1e-4."""
        it = iter(gen)
        pos_fracs, mask_covs = [], []
        for _ in range(num_batches):
            batch = next(it)
            pos = batch["target_class_ids"] > 0
            pos_fracs.append(float(pos.mean()))
            if pos.any():
                mask_covs.append(float(batch["target_mask"][pos].mean()))
        if np.sum(pos_fracs) == 0:
            raise RuntimeError(
                "[preflight] no positive ROIs in sampled batches — target "
                "generation produced degenerate data")
        if mask_covs and float(np.mean(mask_covs)) < 1e-4:
            raise RuntimeError(
                "[preflight] positive target masks are empty — mask cropping "
                "is broken in the target artifacts")
        print(f"[preflight] pos_frac={np.mean(pos_fracs):.3f} "
              f"mask_cov={np.mean(mask_covs) if mask_covs else 0:.3f}")

    def _head_only_outputs(self, batch, train: bool):
        """The heads on the batch's pre-aligned features. Returns (loss,
        metrics)."""
        data = self.mesh.axis("data")
        model = self.model.bn_mode(train, data)
        out = model.forward_heads(batch["rois_aligned"],
                                  batch["mask_aligned"])
        active = torch.ones((batch["rois_aligned"].shape[0],
                             int(self.config.NUM_CLASSES)),
                            device=self.device)
        return head_losses(self.config, out, batch, active, data)

    def make_head_only_step(self, opt):
        """batch -> metrics (floats): one head-only step, the optimiser
        over every leaf, then MaxNorm."""
        params = dict(self.model.named_parameters())

        def train_step(batch):
            for p in params.values():
                p.grad = None
            loss, metrics = self._head_only_outputs(batch, True)
            scale_loss(self.mesh, loss).backward()
            sync_grads(self.mesh, params.values())
            opt.step()
            apply_constraints(params)
            return read_metrics(metrics)

        return train_step

    def _make_head_eval(self):
        """Validation forward of the head-only step, BatchNorm on its
        running statistics."""
        @torch.no_grad()
        def eval_step(batch):
            return read_metrics(self._head_only_outputs(batch, False)[1])

        return eval_step

    def train_head_only(self):
        """Head-only training on DATA_DIR's target artifacts. Returns
        (model, history of epoch metrics)."""
        cfg = self.config
        train_ds = ToyHeadDataset()
        train_ds.load_dataset(cfg.DATA_DIR, is_train=True)
        train_ds.prepare()
        test_ds = ToyHeadDataset()
        test_ds.load_dataset(cfg.DATA_DIR, is_train=False)
        test_ds.prepare()
        gen = HeadGenerator(train_ds, cfg, seed=int(getattr(cfg, "SEED", 0)))
        if len(test_ds.image_info) >= int(cfg.BATCH_SIZE):
            val_gen = HeadGenerator(test_ds, cfg, shuffle=False)
        else:   # the split cannot fill one batch: gate on the train loss
            print(f"[HEAD] test split has {len(test_ds.image_info)} images "
                  f"< BATCH_SIZE {cfg.BATCH_SIZE}; gating on train loss")
            val_gen = None
        self.preflight_targets(gen, num_batches=min(10, len(gen)))
        model = self.init_variables()
        # No freeze predicate, as in JAX: weight decay reaches every leaf.
        opt = Optimizer(cfg, dict(model.named_parameters()))
        return train_loop(self, model, gen, val_gen, opt,
                          self.make_head_only_step(opt),
                          self._make_head_eval(), HEAD_ONLY_VAL_STEPS, "head")

    # e2e ---------------------------------------------------------------
    def prepare_e2e(self):
        """Weights (RPN_WEIGHTS required), the trunk frozen (no gradients)
        and the optimiser over the mrcnn_* leaves. Returns the optimiser."""
        model = self.init_variables(require_rpn=True)
        for name, p in model.named_parameters():
            p.requires_grad_(not _is_frozen_for_e2e(name))
        return Optimizer(self.config, dict(model.named_parameters()),
                               freeze_predicate=_is_frozen_for_e2e)

    def _e2e_outputs(self, batch, generator):
        """Frozen trunk -> targets -> both ROIAligns (no gradient), then
        the heads (with gradients when enabled). Returns (loss, metrics)."""
        cfg, model = self.config, self.model
        data = self.mesh.axis("data")
        with torch.no_grad():
            rpn_out = model.forward_rpn(batch["image"], self._anchors_dev)
            targets = detection_targets_batch(
                rpn_out["proposals"], batch["gt_class_ids"],
                batch["gt_boxes"], batch["gt_masks"], cfg.BBOX_STD_DEV,
                int(cfg.TRAIN_ROIS_PER_IMAGE), float(cfg.ROI_POSITIVE_RATIO),
                float(cfg.RPN_POSITIVE_IOU), float(cfg.RPN_NEGATIVE_IOU),
                tuple(int(v) for v in cfg.MASK_SHAPE),
                use_mini_mask=bool(cfg.USE_MINI_MASK), generator=generator,
                shard=(data.index, data.size))
            feats = [f.detach() for f in rpn_out["feature_maps"][:4]]
            meta = batch["image_meta"].float()
            ra = pyramid_roi_align_auto(targets["rois"], meta, feats,
                                        int(cfg.POOL_SIZE))
            ma = pyramid_roi_align_auto(targets["rois"], meta, feats,
                                        int(cfg.MASK_POOL_SIZE))
        out = model.forward_heads(ra, ma)
        head_batch = {"target_class_ids": targets["class_ids"],
                      "target_bbox": targets["deltas"],
                      "target_mask": targets["masks"]}
        active = torch.ones((batch["image"].shape[0], int(cfg.NUM_CLASSES)),
                            device=self.device)
        loss, metrics = head_losses(cfg, out, head_batch, active, data)
        metrics["pos_count"] = data.all_gather(
            targets["pos_count"]).float().mean()
        return loss, metrics

    def make_e2e_step(self, opt, generator):
        """batch -> metrics (floats): one e2e step; the trunk is frozen and
        its features detached, so only the heads run backward."""
        params = dict(self.model.named_parameters())

        def train_step(batch):
            for p in params.values():
                p.grad = None
            loss, metrics = self._e2e_outputs(batch, generator)
            scale_loss(self.mesh, loss).backward()
            sync_grads(self.mesh, params.values())
            opt.step()
            apply_constraints(params, frozen_predicate=_is_frozen_for_e2e)
            return read_metrics(metrics)

        return train_step

    def make_e2e_eval_step(self):
        """Validation forward: the train step's loss without gradients, its
        targets drawn with a fixed seed (SEED + 99) on every call."""
        seed = int(getattr(self.config, "SEED", 0)) + 99

        @torch.no_grad()
        def eval_step(batch):
            gen = torch.Generator(self.device).manual_seed(seed)
            return read_metrics(self._e2e_outputs(batch, gen)[1])

        return eval_step

    def train_e2e(self):
        """One pass of the generator per epoch, up to E2E_VAL_STEPS
        validation batches. Returns (model, history of epoch metrics)."""
        cfg = self.config
        if bool(getattr(cfg, "TRAIN_BN", False)):
            raise ValueError(
                "TRAIN_BN=true is not supported in e2e head training: the "
                "trunk is frozen and the reference explicitly kills BN "
                "updates for frozen layers (core/models.py:4666-4668). Use "
                "TRAIN_BN with RPN_TRAINING / HEAD_TRAINING (MODE training) "
                "/ MRCNN_TRAINING instead.")
        train_ds = ToyDataset()
        train_ds.load_dataset(cfg.DATA_DIR, is_train=True,
                              class_names=tuple(cfg.CLASS_NAMES))
        train_ds.prepare()
        train_ds = train_ds.filter_positive()
        gen = RPNGenerator(train_ds, cfg, mode="e2e",
                           seed=int(getattr(cfg, "SEED", 0)))
        # Held-out validation on the test split gates best.msgpack.
        val_ds = ToyDataset()
        val_ds.load_dataset(cfg.DATA_DIR, is_train=False,
                            class_names=tuple(cfg.CLASS_NAMES))
        val_ds.prepare()
        val_ds = val_ds.filter_positive()
        if len(val_ds.image_info) >= int(cfg.BATCH_SIZE):
            val_gen = RPNGenerator(val_ds, cfg, mode="e2e", shuffle=False,
                                   augment=False)
            eval_fn = self.make_e2e_eval_step()
        else:
            if len(val_ds.image_info):
                print(f"[HEAD] test split has {len(val_ds.image_info)} images"
                      f" < BATCH_SIZE {cfg.BATCH_SIZE}; gating on train loss")
            val_gen, eval_fn = None, None
        opt = self.prepare_e2e()
        step_fn = self.make_e2e_step(opt, torch.Generator(
            self.device).manual_seed(int(getattr(cfg, "SEED", 0)) + 1))
        return train_loop(self, self.model, gen, val_gen, opt, step_fn,
                          eval_fn, E2E_VAL_STEPS, "head")


def train_loop(trainer, model, gen, val_gen, opt, step_fn, eval_fn,
               val_steps: int, kind: str):
    """The epoch loop of head and MRCNN training: one pass of ``gen`` per
    epoch through ``step_fn`` (timed by ``trainer.clock``), up to
    ``val_steps`` batches of ``val_gen`` (reset every epoch) through
    ``eval_fn``; the validation loss, or the training loss without
    ``val_gen``, gates BestAndLatest (minimise; metadata ``kind``),
    ReduceLROnPlateau and EarlyStopping(15); a telemetry snapshot per
    epoch. Under a data-parallel mesh each rank takes its rows of every
    batch and only rank 0 writes files. Returns (model, history of epoch
    metrics)."""
    cfg, tag, mesh = trainer.config, kind.upper(), trainer.mesh
    save_dir = cfg.WEIGHT_DIR or os.path.join(cfg.OUTPUT_DIR, "weights")
    ckpt = BestAndLatest(save_dir, mode="min") if mesh.is_main else None
    reduce_lr = ReduceLROnPlateau(mode="min")
    early = EarlyStopping(patience=15, mode="min")
    it = prefetch_to_device((shard_batch(mesh, b) for b in iter(gen)),
                            trainer.device,
                            int(getattr(cfg, "PREFETCH_BUFFERS", 2)))
    profiler = EpochProfiler(cfg)
    history = []
    lr = get_learning_rate(opt)
    for epoch in range(int(cfg.FROM_EPOCH), int(cfg.EPOCHS)):
        t0 = time.time()
        profiler.maybe_start(epoch)
        agg: dict[str, list] = {}
        for _ in range(len(gen)):
            metrics = trainer.clock.run(step_fn, trainer.clock.take(it))
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        profiler.maybe_stop(epoch)
        epoch_metrics = {k: float(np.mean(v)) for k, v in agg.items()}

        if val_gen is not None and eval_fn is not None:
            vit = iter(val_gen.reset())
            vals: dict[str, list] = {}
            for _ in range(min(val_steps, len(val_gen))):
                batch = to_device(shard_batch(mesh, next(vit)),
                                  trainer.device)
                for k, v in eval_fn(batch).items():
                    vals.setdefault(f"val_{k}", []).append(v)
            epoch_metrics.update(
                {k: float(np.mean(v)) for k, v in vals.items()})

        gate = epoch_metrics.get("val_loss", epoch_metrics["loss"])
        if ckpt is not None:
            ckpt.update(epoch, params_to_jax(model.state_dict()), gate,
                        metadata={"kind": kind, "epoch": epoch})
        new_lr = reduce_lr.update(gate, lr)
        if new_lr != lr:
            lr = new_lr
            set_learning_rate(opt, lr)
        epoch_metrics["lr"] = lr
        if mesh.is_main:
            trainer.telemetry.snapshot_and_reset(epoch, save_dir,
                                                 extra=epoch_metrics)
        else:
            trainer.telemetry.reset()
        print(f"[{tag}][epoch {epoch}] loss={epoch_metrics['loss']:.4f} "
              f"gate={gate:.4f} dice={epoch_metrics.get('mask_dice', 0):.3f}"
              f" lr={lr:.2e} ({time.time() - t0:.1f}s)")
        history.append(epoch_metrics)
        if early.update(gate):
            print(f"[{tag}] early stopping")
            break
    return model, history
