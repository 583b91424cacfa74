"""Mask R-CNN training and evaluation tasks (port of ``MrcnnTrainer`` in
m3d/train/mrcnn.py).

``train`` (MRCNN_TRAINING): the whole graph trains on an 80/20 split of
the train split (permutation from RandomState(SEED)). A step: the RPN with
gradients into the trunk (BatchNorm on batch statistics under TRAIN_BN),
its losses, targets sampled from the detached proposals (uniforms from a
``torch.Generator`` seeded SEED + 7), both ROIAligns through
``pyramid_roi_align_auto``, the heads and their losses, all weighted by
LOSS_WEIGHTS; the optimiser skips the leaves LEARNING_LAYERS freezes
("head": all but mrcnn_*; "rpn": the mrcnn_* heads; "all": none), and
MaxNorm follows. Frozen leaves take no gradient, so with "head" no feature
map needs one and the ROIAligns run on the padded kernel on the card; with
"all" or "rpn" the head loss reaches the FPN and backbone through the
differentiable gather, as JAX's XLA gather. The validation step (up to 4
batches, no augmentation, the same batches every epoch) runs BatchNorm on
running statistics and draws its targets from SEED + 99 on every call;
its loss gates ``BestAndLatest``, ReduceLROnPlateau and EarlyStopping.
GPU_COUNT > 1 (m3d_torch/parallel/mesh.py): each rank takes its rows of
every batch and of the targets' uniforms, the losses read the whole
batch's outputs and targets (gathered over ``data``, with autograd), the
gradients are summed over the ranks and BatchNorm's batch statistics
under TRAIN_BN are the whole batch's: every rank makes one process's
update. Rank 0 alone writes checkpoints and telemetry.

``evaluate`` (MRCNN_EVALUATION): per-image adaptive inference on the
device -> confidence / size / host-NMS filter cascade -> mask unmolding ->
pixelwise, instance-Dice and detection metrics -> label TIFF, boxes CSV
and overlay PNG artifacts -> summary with a confidence histogram and a
recommended threshold (core/models.py:6338-7196). ``times`` holds each
evaluated image's seconds by stage: load, inference (CUDA events on the
card), unmold, metrics and artifacts.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
import traceback

import numpy as np
import torch

from m3d_torch.anchors import normalized_pyramid_anchors
from m3d_torch.checkpoints import autoconfigure_heads, restore_weights
from m3d_torch.config import resolve_auto_confidence
from m3d_torch.data.datasets import ToyDataset
from m3d_torch.data.generators import MrcnnGenerator
from m3d_torch.models import losses as L
from m3d_torch.models.detection_targets import detection_targets_batch
from m3d_torch.models.inference import adaptive_inference, chunks_from_config
from m3d_torch.models.mask_rcnn import MaskRCNN, init_params
from m3d_torch.ops.roialign3d import pyramid_roi_align_auto
from m3d_torch.parallel.mesh import (make_mesh, replicate, scale_loss,
                                     sync_grads)
from m3d_torch.train.head import head_losses, train_loop
from m3d_torch.train.optim import Optimizer, apply_constraints
from m3d_torch.train.profiling import StepClock
from m3d_torch.train.rpn import read_metrics
from m3d_torch.train.telemetry import Telemetry
from m3d_torch.utils.metrics import compute_overlaps_masks
from m3d_torch.utils.tiffio import imwrite_volume
from m3d_torch.utils.unmold import (instances_to_label_volume,
                                    postprocess_detections)


VAL_STEPS = 4   # validation batches per epoch at most, as in JAX


def _freeze_predicate(learning_layers: str):
    """LEARNING_LAYERS -> predicate on a leaf path ("/" or "."), True for a
    frozen leaf; None trains everything."""
    ll = str(learning_layers).lower()

    def head(path):
        return any(seg.startswith("mrcnn_")
                   for seg in path.replace("/", ".").split("."))

    if ll == "all":
        return None
    if ll == "head":    # train the heads only
        return lambda p: not head(p)
    if ll == "rpn":     # train backbone, FPN and RPN only
        return head
    raise ValueError(f"LEARNING_LAYERS must be rpn|head|all, got {ll}")


class MrcnnTrainer:
    def __init__(self, config, device="cuda", mesh=None):
        self.config = config
        self._mesh = mesh
        self.device = torch.device(device)
        # Adapt head hyperparameters to whatever widths the checkpoints were
        # trained with (reference H5 introspection, core/models.py:5496-5502).
        autoconfigure_heads(config, [
            getattr(config, "HEAD_WEIGHTS", None),
            getattr(config, "MASK_WEIGHTS", None),
        ])
        # "auto" applies the last evaluation's recommended threshold
        # (reference recommendation machinery, core/models.py:7144-7164).
        resolve_auto_confidence(config)
        self.telemetry = Telemetry(config)
        self.anchors = normalized_pyramid_anchors(
            config, voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0))
        )
        self._anchors_dev = torch.as_tensor(self.anchors, device=self.device)
        self.clock = StepClock(self.device)
        self.times: list[dict] = []
        self._now: dict = {}

    @property
    def mesh(self):
        """The data-parallel mesh (``make_mesh(config)``), made at first
        use: evaluation never shards."""
        if self._mesh is None:
            self._mesh = make_mesh(self.config)
        return self._mesh

    def init_variables(self, model):
        """Seeded weights (SEED), then RPN_WEIGHTS, HEAD_WEIGHTS and
        MASK_WEIGHTS restored by name in that order. Returns the model."""
        cfg = self.config
        init_params(model, int(getattr(cfg, "SEED", 0)))
        for path in (getattr(cfg, "RPN_WEIGHTS", None),
                     getattr(cfg, "HEAD_WEIGHTS", None),
                     getattr(cfg, "MASK_WEIGHTS", None)):
            if path:
                stats = restore_weights(model, path)
                print(f"[MrcnnTrainer] restored {path}: {stats}")
        return model

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _outputs(self, model, batch, generator, train: bool, trunk=None):
        """The full graph's loss on a batch: RPN losses, targets from the
        detached proposals, both ROIAligns, head losses. ``trunk``: image
        -> pyramid in place of the model's own (the dryrun's Y-sharded
        one). Returns (loss, metrics)."""
        cfg = self.config
        lw = cfg.LOSS_WEIGHTS
        data = self.mesh.axis("data")
        whole = data.all_gather   # this rank's rows -> the batch
        model.bn_mode(train, data)
        rpn_out = model.rpn_outputs(
            batch["image"], self._anchors_dev,
            None if trunk is None else trunk(batch["image"]))
        match = whole(batch["rpn_match"])
        lrc, mrc = L.rpn_class_loss(match, whole(rpn_out["rpn_class_logits"]))
        lrb, mrb = L.rpn_bbox_loss(whole(batch["rpn_bbox"]), match,
                                   whole(rpn_out["rpn_bbox"]))
        targets = detection_targets_batch(
            rpn_out["proposals"], batch["gt_class_ids"], batch["gt_boxes"],
            batch["gt_masks"], cfg.BBOX_STD_DEV,
            int(cfg.TRAIN_ROIS_PER_IMAGE), float(cfg.ROI_POSITIVE_RATIO),
            float(cfg.RPN_POSITIVE_IOU), float(cfg.RPN_NEGATIVE_IOU),
            tuple(int(v) for v in cfg.MASK_SHAPE),
            use_mini_mask=bool(cfg.USE_MINI_MASK), generator=generator,
            shard=(data.index, data.size))
        feats = list(rpn_out["feature_maps"][:4])
        meta = batch["image_meta"].float()
        ra, ma = (pyramid_roi_align_auto(targets["rois"], meta, feats, int(q))
                  for q in (cfg.POOL_SIZE, cfg.MASK_POOL_SIZE))
        out = model.forward_heads(ra, ma)
        head_batch = {"target_class_ids": targets["class_ids"],
                      "target_bbox": targets["deltas"],
                      "target_mask": targets["masks"]}
        active = torch.ones((batch["image"].shape[0], int(cfg.NUM_CLASSES)),
                            device=self.device)
        head_loss, metrics = head_losses(cfg, out, head_batch, active, data)
        loss = (float(lw.get("rpn_class_loss", 1.0)) * lrc
                + float(lw.get("rpn_bbox_loss", 1.0)) * lrb + head_loss)
        metrics.update(mrc)
        metrics.update(mrb)
        metrics["loss"] = loss
        return loss, metrics

    def prepare_train(self, model):
        """Weights, the frozen leaves (LEARNING_LAYERS) without gradients,
        and the optimiser over the others. Returns the optimiser."""
        frozen = _freeze_predicate(self.config.LEARNING_LAYERS)
        replicate(self.mesh, self.init_variables(model))
        for name, p in model.named_parameters():
            p.requires_grad_(frozen is None or not frozen(name))
        return Optimizer(self.config, dict(model.named_parameters()),
                         freeze_predicate=frozen)

    def make_train_step(self, model, opt, generator):
        """batch -> metrics (floats): one MRCNN_TRAINING step."""
        frozen = _freeze_predicate(self.config.LEARNING_LAYERS)
        params = dict(model.named_parameters())

        def train_step(batch):
            for p in params.values():
                p.grad = None
            loss, metrics = self._outputs(model, batch, generator, True)
            scale_loss(self.mesh, loss).backward()
            sync_grads(self.mesh, params.values())
            opt.step()
            apply_constraints(params, frozen_predicate=frozen)
            return read_metrics(metrics)

        return train_step

    def make_eval_step(self, model):
        """Validation: the train step's loss without gradients, BatchNorm
        on running statistics, targets drawn from SEED + 99 on every
        call (the same ROI draws every epoch)."""
        seed = int(getattr(self.config, "SEED", 0)) + 99

        @torch.no_grad()
        def eval_step(batch):
            gen = torch.Generator(self.device).manual_seed(seed)
            return read_metrics(self._outputs(model, batch, gen, False)[1])

        return eval_step

    def train(self):
        """One pass of the generator per epoch, up to VAL_STEPS validation
        batches. Returns (model, history of epoch metrics)."""
        cfg = self.config
        model = MaskRCNN.from_config(cfg, mode="training",
                                     device=self.device).eval()
        self.model = model
        full = ToyDataset()
        full.load_dataset(cfg.DATA_DIR, is_train=True,
                          class_names=tuple(cfg.CLASS_NAMES))
        full.prepare()
        full = full.filter_positive()
        # 80/20 split (the reference slices it the other way round,
        # core/models.py:5815; JAX implements the documented 80/20).
        ids = np.random.RandomState(int(getattr(cfg, "SEED", 0))).permutation(
            len(full.image_info))
        split = max(1, int(0.2 * len(ids)))
        train_ds, val_ds = full.subset(ids[split:]), full.subset(ids[:split])
        print(f"[MrcnnTrainer] split train={len(train_ds.image_info)} "
              f"val={len(val_ds.image_info)}")
        gen = MrcnnGenerator(train_ds, cfg, mode="training",
                             seed=int(getattr(cfg, "SEED", 0)),
                             telemetry=self.telemetry)
        val_gen = None
        if len(val_ds.image_info) >= int(cfg.BATCH_SIZE):
            val_gen = MrcnnGenerator(val_ds, cfg, mode="training",
                                     shuffle=False, augment=False,
                                     seed=int(getattr(cfg, "SEED", 0)) + 41)
        else:
            print(f"[MrcnnTrainer] val split has {len(val_ds.image_info)} "
                  f"images < BATCH_SIZE {cfg.BATCH_SIZE}; gating on train "
                  f"loss")
        eval_fn = self.make_eval_step(model)
        opt = self.prepare_train(model)
        step_fn = self.make_train_step(model, opt, torch.Generator(
            self.device).manual_seed(int(getattr(cfg, "SEED", 0)) + 7))

        return train_loop(self, model, gen, val_gen, opt, step_fn, eval_fn,
                          VAL_STEPS, "mrcnn")

    # ------------------------------------------------------------------
    # Evaluation (inference + metrics + artifacts)
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _stage(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            self._now[name] = (self._now.get(name, 0.0)
                               + time.perf_counter() - t)

    def _infer(self, model, inputs, chunks):
        """Adaptive inference on the device; returns the detections and
        masks on the host as float32 (exact for the bf16 masks)."""
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t = time.perf_counter()
        out = adaptive_inference(
            model, inputs["image"], inputs["image_meta"], inputs["anchors"],
            classifier_chunk=chunks[0], mask_chunk=chunks[1],
            device=self.device)
        if cuda:
            ev[1].record()
        host = {k: out[k].float().cpu().numpy()
                for k in ("detections", "mrcnn_masks")}
        if cuda:
            ev[1].synchronize()
            self._now["inference"] = ev[0].elapsed_time(ev[1]) / 1e3
        else:
            self._now["inference"] = time.perf_counter() - t
        return host

    def evaluate(self, max_images=None):
        """Evaluate the test split (at most ``max_images`` images). Returns
        (summary, per-image results)."""
        cfg = self.config
        model = self.init_variables(MaskRCNN.from_config(
            cfg, mode="inference", device=self.device).eval())

        test_ds = ToyDataset()
        test_ds.load_dataset(cfg.DATA_DIR, is_train=False,
                             class_names=tuple(cfg.CLASS_NAMES))
        test_ds.prepare()
        gen = MrcnnGenerator(test_ds, cfg)
        # Valid-count-adaptive per-ROI stages (m3d_torch/models/inference.py).
        chunks = chunks_from_config(cfg, model)

        out_dir = cfg.OUTPUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        overlay_dir = os.path.join(out_dir, "overlays")
        os.makedirs(overlay_dir, exist_ok=True)

        n = len(test_ds.image_info)
        if max_images:
            n = min(n, max_images)

        per_image = []
        all_scores = []
        self.times = []
        for image_id in range(n):
            self._now = {}
            try:
                with self._stage("load"):
                    inputs = gen.get_input_prediction(image_id)
                out = self._infer(model, inputs, chunks)
                res = self._evaluate_one(test_ds, image_id, out, out_dir,
                                         overlay_dir,
                                         image_meta=inputs["image_meta"][0])
                per_image.append(res)
                all_scores.extend(res["scores"])
                self.times.append(self._now)
            except Exception as e:  # noqa: BLE001 — per-image skip (parity)
                print(f"[evaluate][{image_id}] failed: {e}")
                traceback.print_exc()

        summary = self._summarize(per_image, all_scores, out_dir)
        return summary, per_image

    def _evaluate_one(self, dataset, image_id, out, out_dir, overlay_dir,
                      image_meta=None):
        cfg = self.config
        if image_meta is not None:
            meta = np.asarray(image_meta)
            # Canonical layout (m3d_torch/image_meta.py): original_shape at
            # 1:5, padded shape at 5:9. Unmold at the padded (bucket) shape,
            # then crop back to the original window.
            H, W, D = (int(v) for v in meta[1:4])
            PH, PW, PD = (int(v) for v in meta[5:8])
        else:
            H, W, D = (int(v) for v in cfg.IMAGE_SHAPE[:3])
            PH, PW, PD = H, W, D

        # Unmold at the bucket shape, crop to the true window, then the
        # reference's confidence -> volume -> host-NMS cascade
        # (core/models.py:6911-6991).
        with self._stage("unmold"):
            boxes_px, class_ids, scores, masks = postprocess_detections(
                out["detections"][0], out["mrcnn_masks"][0], (PH, PW, PD),
                original_shape=(H, W, D),
                min_confidence=float(cfg.DETECTION_MIN_CONFIDENCE),
                min_roi_size=float(cfg.MIN_ROI_SIZE),
                nms_threshold=float(cfg.DETECTION_NMS_THRESHOLD),
                max_instances=int(cfg.DETECTION_MAX_INSTANCES),
            )

        with self._stage("load"):
            gt_boxes, gt_class_ids, gt_masks = dataset.load_data(image_id)

        # Metrics: pixelwise, instance dice, detection counts
        # (core/models.py:6644-6721).
        with self._stage("metrics"):
            pred_union = masks.any(axis=-1) if masks.shape[-1] else np.zeros(
                (H, W, D), bool)
            gt_union = (gt_masks > 0.5).any(axis=-1) if gt_masks is not None \
                and gt_masks.shape[-1] else np.zeros((H, W, D), bool)
            tp = float(np.logical_and(pred_union, gt_union).sum())
            fp = float(np.logical_and(pred_union, ~gt_union).sum())
            fn = float(np.logical_and(~pred_union, gt_union).sum())
            precision = tp / max(tp + fp, 1.0)
            recall = tp / max(tp + fn, 1.0)
            f1 = 2 * precision * recall / max(precision + recall, 1e-7)
            pixel_iou = tp / max(tp + fp + fn, 1.0)

            # Instance dice via greedy IoU matching
            inst_dice = []
            det_tp = det_fp = 0
            if masks.shape[-1] and gt_masks is not None and gt_masks.shape[-1]:
                ov = compute_overlaps_masks(masks, gt_masks)
                matched_gt = set()
                for i in np.argsort(-scores):
                    j = int(np.argmax(ov[i]))
                    if ov[i, j] >= float(cfg.EVAL_DET_IOU) and \
                            j not in matched_gt:
                        matched_gt.add(j)
                        det_tp += 1
                        inter = float(np.logical_and(
                            masks[..., i], gt_masks[..., j] > 0.5).sum())
                        s = float(masks[..., i].sum()) + float(
                            (gt_masks[..., j] > 0.5).sum())
                        inst_dice.append(2 * inter / max(s, 1.0))
                    else:
                        det_fp += 1
            det_fn = (gt_masks.shape[-1] if gt_masks is not None else 0) \
                - det_tp

        # Label volume TIFF + boxes CSV + overlay PNG
        # (core/models.py:6313-6336, 7071-7087).
        name = str(image_id).zfill(6)
        with self._stage("artifacts"):
            label_vol = instances_to_label_volume(masks, scores)
            imwrite_volume(os.path.join(out_dir, f"{name}.tiff"),
                           np.transpose(label_vol, (2, 0, 1)))
            with open(os.path.join(out_dir, f"{name}.csv"), "w",
                      newline="") as f:
                wr = csv.writer(f)
                wr.writerow(["class", "score",
                             "y1", "x1", "z1", "y2", "x2", "z2"])
                for c, s, b in zip(class_ids, scores, boxes_px):
                    wr.writerow([int(c), float(s), *map(int, b)])
            self._write_overlay(dataset, image_id, masks, gt_masks,
                                os.path.join(overlay_dir,
                                             f"{name}_masks_overlay.png"))

        return {
            "image_id": image_id,
            "n_detections": int(masks.shape[-1]),
            "n_gt": int(gt_masks.shape[-1]) if gt_masks is not None else 0,
            "pixel_precision": precision,
            "pixel_recall": recall,
            "pixel_f1": f1,
            "pixel_iou": pixel_iou,
            "instance_dice": float(np.mean(inst_dice)) if inst_dice else 0.0,
            "det_tp": det_tp, "det_fp": det_fp, "det_fn": det_fn,
            "scores": [float(s) for s in scores],
        }

    @staticmethod
    def _write_overlay(dataset, image_id, masks, gt_masks, path):
        """Mid-slice GT/prediction overlay PNG (core/models.py:6351-6642);
        written only where matplotlib imports."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        image = dataset.load_image(image_id)[..., 0]
        z = image.shape[2] // 2
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        axes[0].imshow(image[:, :, z], cmap="gray")
        axes[0].set_title("image")
        axes[1].imshow(
            (gt_masks[..., :].any(-1)[:, :, z]
             if gt_masks is not None and gt_masks.shape[-1] else
             np.zeros(image.shape[:2])), cmap="viridis")
        axes[1].set_title("GT")
        axes[2].imshow(
            (masks.any(-1)[:, :, z] if masks.shape[-1] else
             np.zeros(image.shape[:2])), cmap="viridis")
        axes[2].set_title("prediction")
        for ax in axes:
            ax.axis("off")
        fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)

    def _summarize(self, per_image, all_scores, out_dir):
        """Global summary + confidence histogram + threshold recommendation
        (core/models.py:7144-7196)."""
        if not per_image:
            return {}
        keys = ("pixel_precision", "pixel_recall", "pixel_f1", "pixel_iou",
                "instance_dice")
        summary = {k: float(np.mean([r[k] for r in per_image])) for k in keys}
        summary["det_tp"] = int(sum(r["det_tp"] for r in per_image))
        summary["det_fp"] = int(sum(r["det_fp"] for r in per_image))
        summary["det_fn"] = int(sum(r["det_fn"] for r in per_image))
        tp, fp, fn = summary["det_tp"], summary["det_fp"], summary["det_fn"]
        summary["det_precision"] = tp / max(tp + fp, 1)
        summary["det_recall"] = tp / max(tp + fn, 1)

        if all_scores:
            hist, edges = np.histogram(all_scores, bins=10, range=(0, 1))
            summary["confidence_hist"] = {
                f"{edges[i]:.1f}-{edges[i+1]:.1f}": int(hist[i])
                for i in range(10)
            }
            # Recommend the largest threshold keeping >= 80% of detections.
            scores = np.sort(all_scores)
            idx = max(0, int(0.2 * len(scores)) - 1)
            summary["recommended_confidence"] = float(scores[idx])

        with open(os.path.join(out_dir, "evaluation_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print("[evaluate] summary:", json.dumps(
            {k: v for k, v in summary.items() if not isinstance(v, dict)},
            indent=None))
        return summary
