"""AutoTune: one-shot dataset analysis recommending the anchor
configuration (port of m3d/train/autotune.py, numpy only).

Parity with the reference's AutoTuneRPNCallback (core/models.py:2427-2946),
gated by AUTO_TUNE_RPN: scans the training dataset's GT geometry, estimates
the anchor -> GT delta statistics (robust 68th-percentile + MAD estimator,
core/models.py:2660-2696), and prints and returns a copy-paste JSON patch
with recommended RPN_ANCHOR_SCALES / RPN_ANCHOR_RATIOS / RPN_POSITIVE_IOU /
RPN_BBOX_STD_DEV. With AUTO_TUNE_SAVE_PATCH (default) it also writes the
patch to WEIGHT_DIR/autotune_patch.json, byte for byte the file JAX writes.
RPN_TRAINING applies the patch when AUTO_TUNE_APPLY is set
(``RPNTrainer.train``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from m3d_torch.anchors import normalized_pyramid_anchors
from m3d_torch.utils.metrics import overlaps_3d_numpy


def _snap(values, step, lo, hi, limit):
    out = sorted({
        float(np.clip(round(v / step) * step, lo, hi)) for v in values
        if np.isfinite(v) and v > 0
    })
    return out[:limit]


def _robust_std(x):
    """68th-percentile absolute deviation + MAD blend (reference estimator,
    core/models.py:2660-2696)."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 0.2
    p68 = np.percentile(np.abs(x - np.median(x)), 68)
    mad = np.median(np.abs(x - np.median(x))) * 1.4826
    return float(max(1e-3, 0.5 * (p68 + mad)))


def autotune_rpn(dataset, config, max_images: int = 50, verbose: bool = True):
    """Analyze GT geometry + anchor matching; return a config patch dict
    ({} when no image of the first ``max_images`` has a GT box)."""
    cfg = config
    scale_step = float(getattr(cfg, "AUTO_TUNE_SNAP_SCALE_STEP", 8))
    ratio_step = float(getattr(cfg, "AUTO_TUNE_SNAP_RATIO_STEP", 0.02))
    # This default spans anisotropic microscopy (z/xy ~0.05) through
    # isotropic volumes; the config's own default (0.04-0.30) wins.
    ratio_lo, ratio_hi = getattr(cfg, "AUTO_TUNE_RATIO_RANGE", [0.02, 2.0])
    scales_limit = int(getattr(cfg, "AUTO_TUNE_SCALES_LIMIT", 8))
    ratios_limit = int(getattr(cfg, "AUTO_TUNE_RATIOS_LIMIT", 8))

    H, W, D = (int(v) for v in cfg.IMAGE_SHAPE[:3])
    scale_vec = np.array([H, W, D, H, W, D], np.float32)
    anchors = normalized_pyramid_anchors(cfg)

    xy_sizes, z_sizes, z_ratios = [], [], []
    deltas_all = []
    n = min(len(dataset.image_info), max_images)
    for image_id in range(n):
        boxes, _, _ = dataset.load_data(image_id, masks_needed=False)
        if boxes.shape[0] == 0:
            continue
        b = boxes.astype(np.float32)
        dy, dx, dz = b[:, 3] - b[:, 0], b[:, 4] - b[:, 1], b[:, 5] - b[:, 2]
        xy = np.sqrt(np.maximum(1.0, dy * dx))
        xy_sizes.extend(xy.tolist())
        z_sizes.extend(dz.tolist())
        z_ratios.extend((dz / np.maximum(1.0, xy)).tolist())

        # Best-anchor deltas per GT (what the bbox head must regress).
        gt_norm = np.clip(b / scale_vec, 0, 1)
        ov = overlaps_3d_numpy(anchors, gt_norm)
        best = ov.argmax(axis=0)
        anc = anchors[best]
        ahwd = anc[:, 3:] - anc[:, :3]
        ac = anc[:, :3] + 0.5 * ahwd
        ghwd = gt_norm[:, 3:] - gt_norm[:, :3]
        gc = gt_norm[:, :3] + 0.5 * ghwd
        eps = 1e-6
        d_c = (gc - ac) / np.maximum(ahwd, eps)
        d_s = np.log(np.maximum(ghwd, eps) / np.maximum(ahwd, eps))
        deltas_all.append(np.concatenate([d_c, d_s], axis=1))

    if not xy_sizes:
        return {}

    xy = np.asarray(xy_sizes)
    percentiles = np.percentile(xy, [10, 25, 50, 75, 90])
    scales = _snap(percentiles, scale_step, scale_step, max(H, W),
                   scales_limit)
    ratios = _snap(np.percentile(np.asarray(z_ratios), [10, 25, 50, 75, 90]),
                   ratio_step, ratio_lo, ratio_hi, ratios_limit)

    deltas = (np.concatenate(deltas_all, axis=0) if deltas_all
              else np.zeros((0, 6)))
    std = ([round(_robust_std(deltas[:, i]), 3) for i in range(6)]
           if len(deltas) else list(map(float, cfg.RPN_BBOX_STD_DEV)))

    # Positive-IoU recommendation: aim where ~25% of per-GT best IoUs land.
    best_ious = []
    for image_id in range(min(n, 16)):
        boxes, _, _ = dataset.load_data(image_id, masks_needed=False)
        if boxes.shape[0] == 0:
            continue
        gt_norm = np.clip(boxes.astype(np.float32) / scale_vec, 0, 1)
        ov = overlaps_3d_numpy(anchors, gt_norm)
        best_ious.extend(ov.max(axis=0).tolist())
    pos_iou = round(float(np.percentile(best_ious, 25)) * 0.8, 2) \
        if best_ious else float(cfg.RPN_POSITIVE_IOU)
    pos_iou = float(np.clip(pos_iou, 0.2, 0.7))

    patch = {
        "RPN_ANCHOR_SCALES": [int(s) for s in scales],
        "RPN_ANCHOR_RATIOS": ratios,
        "RPN_POSITIVE_IOU": pos_iou,
        "RPN_BBOX_STD_DEV": std,
    }
    if verbose:
        print("[AutoTuneRPN] GT xy percentiles (10/25/50/75/90):",
              percentiles.round(1).tolist())
        print("[AutoTuneRPN] recommended config patch:")
        print(json.dumps(patch, indent=2))
    if getattr(cfg, "AUTO_TUNE_SAVE_PATCH", True) and cfg.WEIGHT_DIR:
        os.makedirs(cfg.WEIGHT_DIR, exist_ok=True)
        with open(os.path.join(cfg.WEIGHT_DIR, "autotune_patch.json"),
                  "w") as f:
            json.dump(patch, f, indent=2)
    return patch


def head_evaluation(eval_fn, generator, steps: int):
    """Mean/std of head losses over ``steps`` batches of ``generator``
    (core/utils.py:1417-1449): ``eval_fn(batch)`` returns a dict of scalar
    losses (floats or 0-d tensors)."""
    agg: dict[str, list] = {}
    it = iter(generator)
    for _ in range(steps):
        batch = next(it)
        for k, v in eval_fn(batch).items():
            agg.setdefault(k, []).append(float(v))
    out = {}
    for k, v in agg.items():
        out[f"head_test_{k}_mean"] = float(np.mean(v))
        out[f"head_test_{k}_std"] = float(np.std(v))
    return out
