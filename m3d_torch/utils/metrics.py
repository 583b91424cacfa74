"""Detection recall against ground truth (the greedy IoU match bench.py
reports, ported; numpy only)."""

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
