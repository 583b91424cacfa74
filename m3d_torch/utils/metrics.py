"""Evaluation metrics (port of m3d/utils/metrics.py, plus the greedy IoU
recall bench.py reports; numpy only).

- compute_overlaps_masks / compute_matches / compute_ap
  (core/utils.py:1160-1248): mask-IoU-based greedy matching sorted by score,
  VOC-interpolated AP@threshold.
- compute_detection_score (core/utils.py:581-613): recall with a precision
  penalty when proposals outnumber GT, 0-100 scale.
- rpn_evaluation (core/utils.py:1251-1415): proposal-vs-GT Detection@IoU over
  a top-K grid plus mean coordinate error.
- detection_recall: bench.py's greedy box match of detections against GT.
"""

from __future__ import annotations

import numpy as np


def overlaps_3d_numpy(boxes1, boxes2):
    """Pairwise IoU with corner normalization (reference:
    core/utils.py:78-144; same as m3d.data.rpn_targets.overlaps_3d_numpy)."""
    b1 = np.asarray(boxes1, np.float32)
    b2 = np.asarray(boxes2, np.float32)
    if b1.size == 0 or b2.size == 0:
        return np.zeros((b1.shape[0] if b1.ndim == 2 else 0,
                         b2.shape[0] if b2.ndim == 2 else 0), np.float32)

    def norm(b):
        out = b.copy()
        out[:, :3] = np.minimum(b[:, :3], b[:, 3:])
        out[:, 3:] = np.maximum(b[:, :3], b[:, 3:])
        return out

    b1, b2 = norm(b1), norm(b2)
    lo = np.maximum(b1[:, None, :3], b2[None, :, :3])
    hi = np.minimum(b1[:, None, 3:], b2[None, :, 3:])
    inter = np.prod(np.maximum(hi - lo, 0.0), axis=-1)
    v1 = np.prod(b1[:, 3:] - b1[:, :3], axis=-1)[:, None]
    v2 = np.prod(b2[:, 3:] - b2[:, :3], axis=-1)[None, :]
    union = np.maximum(v1 + v2 - inter, 1e-10)
    return np.clip(inter / union, 0.0, 1.0).astype(np.float32)


def detection_recall(detections, detections_valid, gt_boxes, size: int,
                     iou_thr: float = 0.5):
    """Greedy IoU >= thr matching of detected boxes (normalized, [B, M, 8])
    against per-volume GT pixel boxes, highest score first, each GT taken at
    most once. Returns (n_gt, n_matched, n_det)."""
    det = np.asarray(detections, np.float32)
    valid = np.asarray(detections_valid).astype(bool)
    n_gt = n_match = n_det = 0
    for b, gt in enumerate(gt_boxes):
        n_gt += len(gt)
        boxes = det[b, valid[b], :6] * float(size)
        scores = det[b, valid[b], 7]
        n_det += boxes.shape[0]
        if not boxes.shape[0] or not len(gt):
            continue
        ov = overlaps_3d_numpy(boxes, gt)
        taken = set()
        for i in np.argsort(-scores):
            j = int(np.argmax(ov[i]))
            if ov[i, j] >= iou_thr and j not in taken:
                taken.add(j)
        n_match += len(taken)
    return n_gt, n_match, n_det


def compute_overlaps_masks(masks1, masks2):
    """IoU between two mask sets: [H,W,D,N1] x [H,W,D,N2] -> [N1,N2]."""
    if masks1.shape[-1] == 0 or masks2.shape[-1] == 0:
        return np.zeros((masks1.shape[-1], masks2.shape[-1]), np.float32)
    m1 = (masks1.reshape(-1, masks1.shape[-1]) > 0.5).astype(np.float64)
    m2 = (masks2.reshape(-1, masks2.shape[-1]) > 0.5).astype(np.float64)
    inter = m1.T @ m2
    a1 = m1.sum(0)[:, None]
    a2 = m2.sum(0)[None, :]
    union = np.maximum(a1 + a2 - inter, 1e-10)
    return (inter / union).astype(np.float32)


def compute_matches(gt_boxes, gt_class_ids, gt_masks, pred_boxes,
                    pred_class_ids, pred_scores, pred_masks,
                    iou_threshold=0.5, score_threshold=0.0):
    """Greedy score-sorted matching on mask IoU (core/utils.py:1160-1206).

    Returns (gt_match [G], pred_match [P], overlaps [P,G], ious list).
    """
    order = np.argsort(-np.asarray(pred_scores), kind="stable")
    pred_boxes = np.asarray(pred_boxes)[order]
    pred_class_ids = np.asarray(pred_class_ids)[order]
    pred_masks = np.asarray(pred_masks)[..., order]

    overlaps = compute_overlaps_masks(pred_masks, gt_masks)
    gt_match = -np.ones(len(gt_boxes))
    pred_match = -np.ones(len(pred_boxes))
    ious = []
    for i in range(len(pred_boxes)):
        sorted_ix = np.argsort(-overlaps[i])
        low = np.where(overlaps[i, sorted_ix] < score_threshold)[0]
        if low.size:
            sorted_ix = sorted_ix[: low[0]]
        for j in sorted_ix:
            if gt_match[j] > -1:
                continue
            if overlaps[i, j] < iou_threshold:
                break
            if pred_class_ids[i] == gt_class_ids[j]:
                gt_match[j] = i
                pred_match[i] = j
                ious.append(float(overlaps[i, j]))
                break
    return gt_match, pred_match, overlaps, ious


def compute_ap(gt_boxes, gt_class_ids, gt_masks, pred_boxes, pred_class_ids,
               pred_scores, pred_masks, iou_threshold=0.5):
    """VOC-style interpolated AP (core/utils.py:1209-1248).

    Returns (mAP, precision_score, recall_score, ious).
    """
    gt_match, pred_match, _, ious = compute_matches(
        gt_boxes, gt_class_ids, gt_masks, pred_boxes, pred_class_ids,
        pred_scores, pred_masks, iou_threshold,
    )
    if len(pred_match) == 0:
        return 0.0, 0.0, 0.0, []
    precisions = np.cumsum(pred_match > -1) / (np.arange(len(pred_match)) + 1)
    recalls = np.cumsum(pred_match > -1).astype(np.float32) / max(len(gt_match), 1)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    mAP = float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))
    precision_score = float(np.sum(pred_match > -1) / len(pred_match))
    recall_score = float(np.sum(pred_match > -1) / max(len(gt_match), 1))
    return mAP, precision_score, recall_score, ious


def compute_detection_score(proposals, gt_boxes, threshold):
    """Recall with precision penalty, 0-100 (core/utils.py:581-613)."""
    if len(proposals) == 0 or len(gt_boxes) == 0:
        return 0.0
    overlaps = overlaps_3d_numpy(proposals, gt_boxes)
    max_iou_per_gt = overlaps.max(axis=0)
    recall = float((max_iou_per_gt >= threshold).sum()) / len(gt_boxes)
    if len(proposals) > len(gt_boxes):
        precision = min(1.0, len(gt_boxes) / len(proposals))
        f1 = 2 * precision * recall / (precision + recall + 1e-7)
        return f1 * 100.0
    return recall * 100.0


def rpn_evaluation(predict_fn, dataset, config, max_images=None,
                   telemetry=None):
    """Proposal quality over a dataset (core/utils.py:1251-1415).

    predict_fn(image [1,H,W,D,1]) -> (proposals [P,6] normalized, valid [P]).
    Returns a metrics dict: detection@IoU over the top-K grid, mean coordinate
    error, and the summed detection score used for best-checkpoint gating.
    ``telemetry`` (m3d_torch.train.telemetry.Telemetry) is fed each image's
    proposal and GT geometry in pixels.
    """
    iou_grid = list(getattr(config, "EVAL_MATCH_IOU_GRID", [0.3, 0.4, 0.5]))
    topk_grid = list(getattr(config, "EVAL_TOPK_GRID", [500, 1000, 2000]))
    # The reference evaluates at the single EVAL_TOPK_RPN cutoff
    # (core/utils.py:1254); fold it into the grid so reference configs
    # (e.g. rats EVAL_TOPK_RPN=10000) keep their meaning. Only an
    # EXPLICITLY-configured cutoff widens the grid — the default (512)
    # would otherwise silently add a column to every run.
    explicit = getattr(config, "_explicit_keys", ())
    topk_ref = (int(getattr(config, "EVAL_TOPK_RPN", 0) or 0)
                if "EVAL_TOPK_RPN" in explicit else 0)
    if topk_ref and topk_ref not in topk_grid:
        topk_grid = sorted(topk_grid + [topk_ref])
    match_iou = float(getattr(config, "EVAL_MATCH_IOU", 0.5))

    n = len(dataset.image_info)
    if max_images:
        n = min(n, max_images)

    det_at = {(k, t): [] for k in topk_grid for t in iou_grid}
    coord_errs, det_scores = [], []
    H, W, D = (int(v) for v in config.IMAGE_SHAPE[:3])
    scale = np.array([H, W, D, H, W, D], np.float32)

    for image_id in range(n):
        image = dataset.load_image(image_id)[None]
        gt_boxes, _, _ = dataset.load_data(image_id, masks_needed=False)
        if gt_boxes.shape[0] == 0:
            continue
        proposals, valid = predict_fn(image)
        proposals = np.asarray(proposals)[np.asarray(valid)]
        props_px = proposals * scale
        if telemetry is not None:
            telemetry.update_rpn_proposals(props_px,
                                           gt_boxes.astype(np.float32))

        for k in topk_grid:
            top = props_px[:k]
            ov = overlaps_3d_numpy(top, gt_boxes.astype(np.float32))
            best = ov.max(axis=0) if ov.size else np.zeros(len(gt_boxes))
            for t in iou_grid:
                det_at[(k, t)].append(float((best >= t).mean()))

        ov = overlaps_3d_numpy(props_px, gt_boxes.astype(np.float32))
        if ov.size:
            best_prop = ov.argmax(axis=0)
            matched = ov.max(axis=0) >= match_iou
            if matched.any():
                err = np.abs(
                    props_px[best_prop[matched]] - gt_boxes[matched]
                ).mean()
                coord_errs.append(float(err))
        det_scores.append(
            compute_detection_score(props_px, gt_boxes.astype(np.float32),
                                    match_iou)
        )

    metrics = {
        f"det@{t}_top{k}": float(np.mean(v)) if v else 0.0
        for (k, t), v in det_at.items()
    }
    metrics["mean_coord_error"] = float(np.mean(coord_errs)) if coord_errs else -1.0
    metrics["detection_score"] = float(np.sum(det_scores))
    metrics["detection_score_mean"] = (
        float(np.mean(det_scores)) if det_scores else 0.0
    )
    return metrics
