"""Mask unmolding: 28^3 head outputs -> full-volume instance masks (port of
m3d/utils/unmold.py; numpy and scipy on the host).

Parity with the reference (core/models.py:7198-7419):
- ``unmold_small_3d_mask``: sigmoid if logits, adaptive threshold (Otsu-like
  / percentile fallback), largest-connected-component cleanup via
  scipy.ndimage.label, trilinear resize to the detection box, paste into the
  full volume.
- ``unmold_detections``: denormalize boxes, drop zero-padding, unmold each
  mask.
- ``postprocess_detections``: the evaluation cascade (confidence, box
  volume, host greedy NMS with the native library's ``nms_3d_host``, whose
  plain version is ``nms_3d_numpy``).
- ``instances_to_label_volume``: the label TIFF's volume.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from m3d_torch import native


def _otsu_threshold(values: np.ndarray) -> float:
    """Otsu's method over a 64-bin histogram of [0,1] values."""
    hist, edges = np.histogram(values, bins=64, range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 0.5
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = total - w0
    m0 = np.cumsum(hist * centers) / np.maximum(w0, 1e-9)
    m1 = (np.sum(hist * centers) - np.cumsum(hist * centers)) / np.maximum(w1, 1e-9)
    between = w0 * w1 * (m0 - m1) ** 2
    idx = int(np.argmax(between[:-1]))
    return float(centers[idx])


def resize_trilinear(vol: np.ndarray, out_shape) -> np.ndarray:
    """Trilinear resize via scipy zoom (order=1)."""
    factors = [o / s for o, s in zip(out_shape, vol.shape)]
    if all(f == 1.0 for f in factors):
        return vol
    return ndimage.zoom(vol, factors, order=1, prefilter=False,
                        grid_mode=True, mode="nearest")


# Floor of the adaptive mask threshold.
MIN_ADAPTIVE_THRESHOLD = 0.15


def unmold_small_3d_mask(small_mask: np.ndarray, box_px,
                         image_shape) -> np.ndarray:
    """Paste one predicted mask crop into the full volume: adaptive
    threshold, then the largest connected component only.

    small_mask: [m, m, m] probabilities (or logits — auto-sigmoid).
    box_px: (y1, x1, z1, y2, x2, z2) pixel box.
    Returns a bool volume of image_shape.
    """
    m = np.asarray(small_mask, np.float32)
    if m.max() > 1.0 or m.min() < 0.0:
        m = 1.0 / (1.0 + np.exp(-m))

    # Otsu over the crop, floored; percentile fallback when the distribution
    # is degenerate (core/models.py:7236-7278).
    thr = _otsu_threshold(m.reshape(-1))
    if not (0.05 < thr < 0.95):
        thr = float(np.percentile(m, 85.0))
    thr = max(thr, MIN_ADAPTIVE_THRESHOLD)

    binary = m >= thr
    if binary.any():
        labels, n = ndimage.label(binary)
        if n > 1:
            sizes = ndimage.sum(binary, labels, range(1, n + 1))
            binary = labels == (int(np.argmax(sizes)) + 1)

    y1, x1, z1, y2, x2, z2 = (int(round(v)) for v in box_px)
    H, W, D = (int(v) for v in image_shape[:3])
    y1, x1, z1 = max(0, y1), max(0, x1), max(0, z1)
    y2, x2, z2 = min(H, y2), min(W, x2), min(D, z2)
    full = np.zeros((H, W, D), bool)
    if y2 <= y1 or x2 <= x1 or z2 <= z1 or not binary.any():
        return full

    resized = resize_trilinear(binary.astype(np.float32),
                               (y2 - y1, x2 - x1, z2 - z1)) >= 0.5
    full[y1:y2, x1:x2, z1:z2] = resized
    return full


def unmold_detections(detections, mrcnn_masks, image_shape):
    """Unpack padded detections (core/models.py:7342-7419).

    detections: [N, 8] normalized (y1,x1,z1,y2,x2,z2, class, score).
    mrcnn_masks: [N, m, m, m, C] per-class mask probabilities.
    Returns (boxes_px [K,6] int, class_ids [K], scores [K], masks [H,W,D,K]).
    """
    detections = np.asarray(detections)
    valid = detections[:, 7] > 0
    detections = detections[valid]
    mrcnn_masks = np.asarray(mrcnn_masks)[valid]

    H, W, D = (int(v) for v in image_shape[:3])
    scale = np.array([H, W, D, H, W, D], np.float32)
    boxes_px = detections[:, :6] * scale
    class_ids = detections[:, 6].astype(np.int32)
    scores = detections[:, 7]

    masks = np.zeros((H, W, D, len(detections)), bool)
    for i in range(len(detections)):
        crop = mrcnn_masks[i, ..., class_ids[i]]
        masks[..., i] = unmold_small_3d_mask(crop, boxes_px[i], (H, W, D))
    return boxes_px.round().astype(np.int32), class_ids, scores, masks


def postprocess_detections(detections, mrcnn_masks, padded_shape,
                           original_shape=None, *, min_confidence: float,
                           min_roi_size: float, nms_threshold: float,
                           max_instances: int):
    """Full single-image prediction postprocess: unmold + filter cascade.

    Unmolds at ``padded_shape`` (the compile bucket), crops back to
    ``original_shape`` (the meta window's true extent) when given, then
    applies the reference's evaluate-loop cascade (core/models.py:6911-6991):
    confidence >= min_confidence, box volume >= min_roi_size, and host
    greedy NMS at nms_threshold capped at max_instances — the final numpy
    NMS stage that removes duplicate masks surviving a loose in-graph
    DETECTION_NMS_THRESHOLD.

    Returns (boxes_px [K,6], class_ids [K], scores [K], masks [H,W,D,K]).
    """
    PH, PW, PD = (int(v) for v in padded_shape[:3])
    boxes_px, class_ids, scores, masks = unmold_detections(
        detections, mrcnn_masks, (PH, PW, PD))
    if original_shape is not None:
        H, W, D = (int(v) for v in original_shape[:3])
        if (PH, PW, PD) != (H, W, D):
            masks = masks[:H, :W, :D]
            if len(boxes_px):
                boxes_px = np.stack([
                    np.clip(boxes_px[:, 0], 0, H),
                    np.clip(boxes_px[:, 1], 0, W),
                    np.clip(boxes_px[:, 2], 0, D),
                    np.clip(boxes_px[:, 3], 0, H),
                    np.clip(boxes_px[:, 4], 0, W),
                    np.clip(boxes_px[:, 5], 0, D),
                ], axis=1)

    keep = scores >= float(min_confidence)
    vol = np.prod(np.maximum(boxes_px[:, 3:] - boxes_px[:, :3], 0), axis=1)
    keep &= vol >= float(min_roi_size)
    boxes_px, class_ids, scores = (
        boxes_px[keep], class_ids[keep], scores[keep])
    masks = masks[..., keep]

    if len(scores):
        nms_keep = native.nms_3d_host(boxes_px.astype(np.float32),
                                      scores.astype(np.float32),
                                      float(nms_threshold),
                                      int(max_instances))
        boxes_px, class_ids, scores = (
            boxes_px[nms_keep], class_ids[nms_keep], scores[nms_keep])
        masks = masks[..., nms_keep]
    return boxes_px, class_ids, scores, masks


def instances_to_label_volume(masks, scores) -> np.ndarray:
    """Paint instance masks into a label volume (core/models.py:6313-6336).

    Instances are painted in ascending-score order so on overlap the
    higher-score instance wins; labels are 1-based indices into the ORIGINAL
    instance order. uint16 (the reference's uint8 caps at 255 instances).
    """
    H, W, D = masks.shape[:3]
    label = np.zeros((H, W, D), np.uint16)
    for i in np.argsort(scores):
        label[masks[..., int(i)]] = int(i) + 1
    return label
