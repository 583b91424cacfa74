"""RPN target assignment (port of m3d/data/rpn_targets.py: host numpy, the
same arithmetic and the same RandomState calls, so one seed gives the same
arrays).

Parity with the reference (core/data_generators.py:2031-2178 build_rpn_targets):
dual-threshold matching plus per-GT-best guarantee, ATSS adaptive thresholding
per GT (mean + std of the top-k IoUs, min positives per GT), pos/neg balancing
to RPN_TRAIN_ANCHORS_PER_IMAGE, and standardized deltas packed into a fixed
[A_train, 6] buffer (positives first, in anchor order).

The ATSS loop is vectorized over GT boxes. The IoU matrix, the host hot
loop, comes from the native C++ library (``m3d_torch.native.iou_matrix_3d``,
the same bits as the JAX package's library; ``overlaps_3d_numpy`` of
m3d_torch/utils/metrics.py is its plain version).
"""

from __future__ import annotations

import numpy as np

from m3d_torch import native


def build_rpn_targets(anchors, gt_class_ids, gt_boxes, config, rng=None,
                      telemetry=None):
    """Returns (rpn_match [A] int32 {1,-1,0}, rpn_bbox [A_train, 6] float32).

    anchors normalized [0,1]; gt_boxes in pixels OR normalized (auto-detected
    and reconciled like the reference, core/data_generators.py:2071-2090).
    """
    rng = rng or np.random.RandomState(None)
    pos_thr = float(getattr(config, "RPN_POSITIVE_IOU", 0.15))
    neg_thr = float(getattr(config, "RPN_NEGATIVE_IOU", 0.05))
    a_train = int(getattr(config, "RPN_TRAIN_ANCHORS_PER_IMAGE", 2048))
    pos_ratio = float(getattr(config, "RPN_POSITIVE_RATIO", 0.5))
    atss_topk = int(getattr(config, "ATSS_TOPK", 24))
    atss_min_pos = int(getattr(config, "ATSS_MIN_POS_PER_GT", 4))

    A = anchors.shape[0] if anchors is not None else 0
    G = gt_boxes.shape[0] if gt_boxes is not None else 0
    rpn_match = np.zeros((A,), np.int32)
    rpn_bbox = np.zeros((a_train, 6), np.float32)
    if A == 0 or G == 0:
        rpn_match[:] = -1
        return rpn_match, rpn_bbox

    anchors_w = np.asarray(anchors, np.float32)
    gt_w = np.asarray(gt_boxes, np.float32)

    # Reconcile coordinate systems (both normalized).
    H = int(getattr(config, "IMAGE_SIZE", 0)) or int(config.IMAGE_SHAPE[0])
    W = int(getattr(config, "IMAGE_SIZE", 0)) or int(config.IMAGE_SHAPE[1])
    D = int(getattr(config, "IMAGE_DEPTH", 0)) or int(config.IMAGE_SHAPE[2])
    scale = np.array([H, W, D, H, W, D], np.float32)
    a_max = float(np.abs(anchors_w).max()) if anchors_w.size else 0.0
    g_max = float(np.abs(gt_w).max()) if gt_w.size else 0.0
    if a_max <= 1.5 < 2.0 < g_max:
        gt_w = np.clip(gt_w / scale, 0.0, 1.0)
    elif g_max <= 1.5 < 2.0 < a_max:
        anchors_w = np.clip(anchors_w / scale, 0.0, 1.0)

    overlaps = native.iou_matrix_3d(anchors_w, gt_w)                 # [A, G]
    anchor_iou_max = overlaps.max(axis=1)
    gt_argmax = overlaps.argmax(axis=0)

    # Best anchor per GT -> positive; then dual thresholds.
    rpn_match[gt_argmax] = 1
    rpn_match[anchor_iou_max < neg_thr] = -1
    rpn_match[anchor_iou_max >= pos_thr] = 1

    # ATSS: per-GT adaptive threshold (vectorized over G).
    k = min(atss_topk, A)
    top_idx = np.argpartition(-overlaps, k - 1, axis=0)[:k]          # [k, G]
    top_ious = np.take_along_axis(overlaps, top_idx, axis=0)         # [k, G]
    mu = top_ious.mean(axis=0)
    sd = top_ious.std(axis=0)
    thr = np.maximum(pos_thr, mu + sd)                               # [G]
    has_overlap = overlaps.max(axis=0) > 0.0
    for g in np.where(has_overlap)[0]:
        cand = np.where(overlaps[:, g] >= thr[g])[0]
        if cand.size < atss_min_pos:
            cand = top_idx[:atss_min_pos, g]
        rpn_match[cand] = 1

    # Balance to the training budget.
    target_pos = int(round(a_train * pos_ratio))
    pos_ids = np.where(rpn_match == 1)[0]
    if pos_ids.size > target_pos:
        order = np.argsort(-anchor_iou_max[pos_ids])
        rpn_match[pos_ids[order[target_pos:]]] = 0
    neg_ids = np.where(rpn_match == -1)[0]
    target_neg = min(len(neg_ids), a_train - int((rpn_match == 1).sum()))
    if len(neg_ids) > target_neg:
        drop = rng.choice(neg_ids, size=len(neg_ids) - target_neg, replace=False)
        rpn_match[drop] = 0

    # Deltas for positives, packed into the fixed buffer (anchor order).
    pos_final = np.where(rpn_match == 1)[0]
    if pos_final.size:
        gt_of_pos = overlaps[pos_final].argmax(axis=1)
        anc, gt = anchors_w[pos_final], gt_w[gt_of_pos]

        def cywhd(b):
            hwd = b[:, 3:] - b[:, :3]
            c = b[:, :3] + 0.5 * hwd
            return c, hwd

        ac, ahwd = cywhd(anc)
        gc, ghwd = cywhd(gt)
        eps = 1e-6
        d_c = (gc - ac) / np.maximum(ahwd, eps)
        d_s = np.log(np.maximum(ghwd, eps) / np.maximum(ahwd, eps))
        deltas = np.concatenate([d_c, d_s], axis=1).astype(np.float32)
        std = np.asarray(
            getattr(config, "RPN_BBOX_STD_DEV",
                    [0.1, 0.1, 0.1, 0.2, 0.2, 0.2]), np.float32)
        deltas = deltas / std[None, :]
        count = min(deltas.shape[0], a_train)
        rpn_bbox[:count] = deltas[:count]

    if telemetry is not None:
        # Report pixel-space anchor geometry (the reference feeds whatever
        # coordinate system it had — normalized — which degenerates its
        # xy histograms to 1.0; we fix that deliberately).
        telemetry.update_rpn_targets(anchors_w * scale, anchor_iou_max,
                                     rpn_match)
        telemetry.update_gt_stats(gt_w * scale)
    return rpn_match, rpn_bbox
