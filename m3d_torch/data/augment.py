"""Host-side augmentations (port of m3d/data/augment.py: numpy, the same
RandomState calls in the same order).

Parity with the reference (core/data_generators.py:13-167):
- per-axis flips with exclusive-coordinate box correction
- brightness jitter scaled by the intensity range
- additive Gaussian noise
- GT-box jitter for RPN training (per-box scale ~ N(1, sigma), integer
  translation, IoU >= threshold filter, concat to GT).
"""

from __future__ import annotations

import numpy as np


def apply_minimal_augs_3d(image, boxes, masks, config, rng=None):
    """image [Y,X,Z(,1)], boxes [N,6] px exclusive, masks [Y,X,Z,N] or None."""
    if image is None:
        return image, boxes, masks
    rng = rng or np.random.RandomState(None)
    image = image.copy()
    boxes = None if boxes is None else np.asarray(boxes, np.float32).copy()
    Y, X, Z = image.shape[:3]
    p = float(getattr(config, "AUG_PROB", 0.5))

    def flip(axis, size, lo_col, hi_col):
        nonlocal image, masks, boxes
        sl = [slice(None)] * image.ndim
        sl[axis] = slice(None, None, -1)
        image = image[tuple(sl)]
        if masks is not None:
            msl = [slice(None)] * masks.ndim
            msl[axis] = slice(None, None, -1)
            masks = masks[tuple(msl)]
        if boxes is not None and boxes.size:
            lo = size - boxes[:, hi_col]
            hi = size - boxes[:, lo_col]
            boxes[:, lo_col], boxes[:, hi_col] = lo, hi

    if getattr(config, "AUG_FLIP_Y", True) and rng.rand() < p:
        flip(0, Y, 0, 3)
    if getattr(config, "AUG_FLIP_X", True) and rng.rand() < p:
        flip(1, X, 1, 4)
    if getattr(config, "AUG_FLIP_Z", False) and rng.rand() < p:
        flip(2, Z, 2, 5)

    bd = float(getattr(config, "AUG_BRIGHTNESS_DELTA", 0.0))
    if bd > 0:
        vmin, vmax = float(image.min()), float(image.max())
        scale = bd * (vmax - vmin + 1e-6)
        image = np.clip(
            image + rng.uniform(-scale, scale, image.shape).astype(image.dtype),
            vmin, vmax,
        )

    ns = float(getattr(config, "AUG_GAUSS_NOISE_STD", 0.0))
    if ns > 0:
        image = image + rng.normal(0.0, ns, image.shape).astype(image.dtype)

    return image, boxes, masks


def jitter_boxes_3d(boxes, count=3, scale_sigma=0.10, trans=(2, 2, 1),
                    img_shape=None, iou_thr=0.40, max_keep=None, rng=None):
    """Augment GT boxes with jittered copies; returns concat [boxes, kept]."""
    if boxes is None:
        return boxes
    rng = rng or np.random.RandomState(None)
    B = np.asarray(boxes, np.float32)
    if B.size == 0 or count <= 0:
        return B

    def iou_one(b, C):
        y1 = np.maximum(b[0], C[:, 0]); y2 = np.minimum(b[3], C[:, 3])
        x1 = np.maximum(b[1], C[:, 1]); x2 = np.minimum(b[4], C[:, 4])
        z1 = np.maximum(b[2], C[:, 2]); z2 = np.minimum(b[5], C[:, 5])
        inter = (np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
                 * np.maximum(z2 - z1, 0))
        vb = max((b[3] - b[0]) * (b[4] - b[1]) * (b[5] - b[2]), 1e-6)
        vc = np.maximum((C[:, 3] - C[:, 0]) * (C[:, 4] - C[:, 1])
                        * (C[:, 5] - C[:, 2]), 1e-6)
        return inter / np.maximum(vb + vc - inter, 1e-6)

    out = []
    for b in B:
        y1, x1, z1, y2, x2, z2 = b
        h = max(1.0, y2 - y1); w = max(1.0, x2 - x1); d = max(1.0, z2 - z1)
        cy, cx, cz = (y1 + y2) / 2, (x1 + x2) / 2, (z1 + z2) / 2
        cand = []
        for _ in range(int(count)):
            nh = max(1.0, h * (1 + rng.randn() * scale_sigma))
            nw = max(1.0, w * (1 + rng.randn() * scale_sigma))
            nd = max(1.0, d * (1 + rng.randn() * scale_sigma))
            ty = cy + rng.randint(-trans[0], trans[0] + 1)
            tx = cx + rng.randint(-trans[1], trans[1] + 1)
            tz = cz + rng.randint(-trans[2], trans[2] + 1)
            nb = [ty - nh / 2, tx - nw / 2, tz - nd / 2,
                  ty + nh / 2, tx + nw / 2, tz + nd / 2]
            if img_shape is not None:
                H, W, D = img_shape
                nb[0] = np.clip(nb[0], 0, H - 1); nb[3] = np.clip(nb[3], 1, H)
                nb[1] = np.clip(nb[1], 0, W - 1); nb[4] = np.clip(nb[4], 1, W)
                nb[2] = np.clip(nb[2], 0, D - 1); nb[5] = np.clip(nb[5], 1, D)
                if nb[3] <= nb[0] or nb[4] <= nb[1] or nb[5] <= nb[2]:
                    continue
            cand.append(nb)
        if not cand:
            continue
        cand = np.asarray(cand, np.float32)
        ious = iou_one(b, cand)
        keep = cand[ious >= iou_thr]
        if keep.size:
            if max_keep and keep.shape[0] > max_keep:
                order = np.argsort(ious[ious >= iou_thr])[::-1][:int(max_keep)]
                keep = keep[order]
            out.append(keep)
    if not out:
        return B
    return np.vstack([B] + out).astype(np.float32)
