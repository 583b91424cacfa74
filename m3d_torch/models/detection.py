"""Final detection refinement (port of m3d/models/detection.py).

Foreground probability from class column 1, confidence filter, class-1
delta application in pixel space (BBOX_STD_DEV and the log-scale clamp),
clip to the image, pixel min-size filter (1 px y/x, 0.5 px z), NMS (3-D, or
on the x-y footprint with ``nms_xy_only``, the reference's behaviour), top K,
renormalize, pad to DETECTION_MAX_INSTANCES. Rows are
``(y1, x1, z1, y2, x2, z2, class_id, score)`` in normalized coordinates.
Every image of the batch is refined in the same tensor ops.
"""

from __future__ import annotations

import torch

from m3d_torch import boxes as B
from m3d_torch import trace
from m3d_torch.image_meta import parse_image_meta
from m3d_torch.ops.nms3d import nms_3d


def refine_detections_batch(rois, probs, deltas, image_meta, bbox_std_dev,
                            min_confidence: float, nms_threshold: float,
                            max_instances: int, nms_xy_only: bool = False):
    """rois [B, R, 6], probs [B, R, C], deltas [B, R, C, 6], image_meta
    [B, META] -> (detections [B, max_instances, 8],
    valid [B, max_instances]). Opens the ``detection`` span."""
    with trace.span("detection"):
        rois = rois.float()
        fg = probs.float()[..., 1]
        roi_valid = rois.abs().sum(dim=-1) > 0
        keep = (fg >= min_confidence) & roi_valid

        with trace.waits("table.refine_detections_batch"):
            std = torch.as_tensor(bbox_std_dev, dtype=torch.float32,
                                  device=rois.device)
        d = deltas.float()[:, :, 1, :] * std
        shape = parse_image_meta(image_meta.float())["image_shape"][:, :3]
        h, w, dd = (shape[:, i:i + 1] for i in range(3))          # [B, 1]
        boxes_px = B.apply_deltas(B.denorm_boxes(rois, (h, w, dd)), d,
                                  clip_log_scale=True)
        lo = torch.zeros_like(boxes_px)
        hi = torch.stack([h, w, dd, h, w, dd], dim=-1).expand_as(boxes_px)
        boxes_px = torch.minimum(torch.maximum(boxes_px, lo), hi)

        hh = boxes_px[..., 3] - boxes_px[..., 0]
        ww = boxes_px[..., 4] - boxes_px[..., 1]
        zz = boxes_px[..., 5] - boxes_px[..., 2]
        keep = keep & (hh >= 1.0) & (ww >= 1.0) & (zz >= 0.5)

        nms_boxes = boxes_px
        if nms_xy_only:
            nms_boxes = boxes_px.clone()
            nms_boxes[..., 2] = 0.0
            nms_boxes[..., 5] = 1.0

        idx, out_valid = nms_3d(nms_boxes, fg, nms_threshold,
                                max_output=max_instances, valid=keep)
        final_px = torch.gather(boxes_px, 1, idx[..., None].expand(-1, -1, 6))
        final_px = torch.where(out_valid[..., None], final_px,
                               torch.zeros_like(final_px))
        final_scores = torch.where(out_valid, torch.gather(fg, 1, idx),
                                   torch.zeros_like(fg[:, :1]))
        final_norm = B.norm_boxes(final_px, (h, w, dd), clip=False)
        class_col = out_valid.float()
        detections = torch.cat(
            [final_norm, class_col[..., None], final_scores[..., None]],
            dim=-1)
        return detections, out_valid
