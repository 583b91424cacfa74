"""Mask R-CNN evaluation task (port of ``MrcnnTrainer.__init__``,
``init_variables``, ``evaluate``, ``_evaluate_one``, ``_write_overlay`` and
``_summarize`` in m3d/train/mrcnn.py). Training is not ported yet
(ROADMAP.md §1).

``evaluate``: per-image adaptive inference on the device -> confidence /
size / host-NMS filter cascade -> mask unmolding -> pixelwise,
instance-Dice and detection metrics -> label TIFF, boxes CSV and overlay PNG
artifacts -> summary with a confidence histogram and a recommended threshold
(core/models.py:6338-7196). ``times`` holds each evaluated image's seconds
by stage: load, inference (CUDA events on the card), unmold, metrics and
artifacts.
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

from m3d_torch.checkpoints import (autoconfigure_heads, load_params,
                                   params_from_jax, restore_by_name)
from m3d_torch.config import resolve_auto_confidence
from m3d_torch.data.datasets import ToyDataset
from m3d_torch.data.generators import MrcnnGenerator
from m3d_torch.models.inference import adaptive_inference, chunks_from_config
from m3d_torch.models.mask_rcnn import MaskRCNN, init_params
from m3d_torch.utils.metrics import compute_overlaps_masks
from m3d_torch.utils.tiffio import imwrite_volume
from m3d_torch.utils.unmold import (instances_to_label_volume,
                                    postprocess_detections)


class MrcnnTrainer:
    def __init__(self, config, device="cuda"):
        self.config = config
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
        self.times: list[dict] = []
        self._now: dict = {}

    def init_variables(self, model):
        """Seeded weights (SEED), then RPN_WEIGHTS, HEAD_WEIGHTS and
        MASK_WEIGHTS restored by name in that order. Returns the model."""
        cfg = self.config
        init_params(model, int(getattr(cfg, "SEED", 0)))
        for path in (getattr(cfg, "RPN_WEIGHTS", None),
                     getattr(cfg, "HEAD_WEIGHTS", None),
                     getattr(cfg, "MASK_WEIGHTS", None)):
            if path:
                tree, _ = load_params(path)
                stats = restore_by_name(model, params_from_jax(tree))
                del tree
                print(f"[MrcnnTrainer] restored {path}: {stats}")
        return model

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

    # ------------------------------------------------------------------
    # Evaluation (inference + metrics + artifacts)
    # ------------------------------------------------------------------
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
