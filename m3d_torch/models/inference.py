"""Valid-count-adaptive Mask R-CNN inference (port of
m3d/models/inference.py).

Both per-ROI stages are compacted across the batch: the ROI boxes are
sorted valid-first over the flattened batch x slot axis (stable, so the live
block stays image-major and score-ordered), and per-ROI work runs in chunks
of that flat axis, skipping every chunk that starts at or beyond the total
live count. Skipped chunks come back as exact zeros.

JAX gates chunks with ``lax.cond`` on a traced count. Eager torch instead
reads the live count on the host once per stage (one device->host sync for
the classifier stage, one for the mask stage) and launches only the live
chunks. The mask-stage ROIAlign kernel itself reads ``total`` on the device.
"""

from __future__ import annotations

import torch

from m3d_torch.models.detection import refine_detections_batch
from m3d_torch.models.mask_rcnn import MaskRCNN


def default_chunks(model: MaskRCNN):
    """(classifier_chunk, mask_chunk) on the flattened batch x slot axis;
    None runs a stage in one call. Same values as the JAX package."""
    cls = None
    if model.post_nms_rois > 128:
        cls = min(256, max(64, -(-model.post_nms_rois // 4)))
    mask = None
    if model.detection_max_instances > 10:
        mask = 40
    return cls, mask


def chunked_roi_stage(apply_chunk, rois, n_live: int, chunk: int):
    """Apply a per-ROI stage over chunks of axis 1 of ``rois`` [B, N, ...],
    skipping chunks that start at or beyond ``n_live`` (a host int).

    ``apply_chunk`` maps [B, chunk, ...] to a tuple of [B, chunk, ...]
    tensors. Returns the tuple it would return for the whole axis, with
    skipped-chunk slots zero.
    """
    n = rois.shape[1]
    chunk = int(chunk)
    if chunk >= n:
        return apply_chunk(rois)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        rois = torch.cat(
            [rois, rois.new_zeros((rois.shape[0], pad) + rois.shape[2:])], 1)
    outs = [apply_chunk(rois[:, i * chunk:(i + 1) * chunk])
            for i in range(n_chunks) if i * chunk < n_live]
    if not outs:  # nothing live: one chunk runs for its shapes, zeroed
        probe = apply_chunk(rois[:, :chunk])
        outs = [tuple(torch.zeros_like(t) for t in probe)]
    skipped = n_chunks - len(outs)
    stitched = []
    for parts in zip(*outs):
        full = torch.cat(parts, dim=1)
        if skipped:
            full = torch.cat([full, full.new_zeros(
                (full.shape[0], skipped * chunk) + full.shape[2:])], 1)
        stitched.append(full[:, :n])
    return tuple(stitched)


def _compact_perm(valid):
    """Valid-first stable permutation of the flattened [B, N] mask.
    Returns (perm, inv, total [] int32 tensor)."""
    b, n = valid.shape[:2]
    flat = valid.reshape(b * n)
    perm = torch.sort((~flat).to(torch.uint8), stable=True).indices
    inv = torch.argsort(perm)
    total = flat.sum().to(torch.int32)
    return perm, inv, total


def compacted_classifier_stage(model: MaskRCNN, proposals, prop_valid,
                               image_meta, mrcnn_feats, chunk: int):
    """Classifier stage with cross-batch box-level compaction. Returns
    (class_logits, class_probs, bbox_deltas) shaped [B, N, ...]; slots past
    the last live chunk are zero."""
    b, n = prop_valid.shape[:2]
    perm, inv, total = _compact_perm(prop_valid)
    boxes_f = proposals.reshape(b * n, 6)[perm]
    batch_f = torch.arange(b, device=proposals.device)
    batch_f = batch_f.repeat_interleave(n)[perm]
    packed = torch.cat([boxes_f, batch_f.float()[:, None]], dim=-1)[None]

    def cls_chunk(x):  # [1, chunk, 7]
        logits, probs, deltas = model.classify_rois_flat(
            x[0, :, :6], x[0, :, 6].to(torch.int32), image_meta, mrcnn_feats)
        return logits[None], probs[None], deltas[None]

    # Host sync: the live proposal count decides which chunks launch.
    outs = chunked_roi_stage(cls_chunk, packed, int(total), chunk)
    return tuple(x[0][inv].reshape((b, n) + x.shape[2:]) for x in outs)


def compacted_mask_stage(model: MaskRCNN, detections, det_valid, image_meta,
                         mrcnn_feats, chunk: int):
    """Mask head over rows that exist: the compact ROIAlign kernel writes
    the pooled features already compacted (rows >= total are zero), and the
    mask-head convolutions run chunk-gated on the same total. Returns masks
    [B, N, 2m, 2m, 2m, K]; slots past the last live chunk are zero."""
    b, n = det_valid.shape[:2]
    perm, inv, total = _compact_perm(det_valid)
    boxes_f = detections[..., :6].reshape(b * n, 6)[perm]
    batch_f = torch.arange(b, device=detections.device)
    batch_f = batch_f.repeat_interleave(n)[perm]
    aligned = model.mask_align_compact(boxes_f, batch_f.to(torch.int32), total,
                                       image_meta, mrcnn_feats)
    # Host sync: the live detection count decides which chunks launch.
    masks_flat = chunked_roi_stage(lambda x: (model.apply_mask_head(x),),
                                   aligned[None], int(total), chunk)[0][0]
    return masks_flat[inv].reshape((b, n) + masks_flat.shape[1:])


@torch.no_grad()
def adaptive_inference(model: MaskRCNN, image, image_meta, anchors, *,
                       classifier_chunk: int | None = None,
                       mask_chunk: int | None = None, device="cuda"):
    """Full inference with the per-ROI stages chunk-gated on live counts.

    image [B, H, W, D, C], image_meta [B, META] and anchors [A, 6] may be
    numpy arrays or tensors; they are moved to ``device``, where the model
    must be. Chunk arguments must be set (the monolithic graph is not ported
    yet). Returns the same dict as m3d's ``adaptive_inference``.
    """
    if not classifier_chunk or not mask_chunk:
        raise NotImplementedError(
            "only the chunked adaptive path is ported; pass both chunks "
            "(default_chunks(model))")
    image, image_meta, anchors = (torch.as_tensor(x, device=device)
                                  for x in (image, image_meta, anchors))
    image_meta = image_meta.float()

    feats = model.extract_features(image.float())
    logits, probs, deltas = model.rpn_forward(list(feats))
    proposals, prop_valid = model.propose(probs, deltas, anchors)
    cap = int(model.head_max_rois or 0)
    if cap and cap < proposals.shape[1]:
        proposals = proposals[:, :cap]
        prop_valid = prop_valid[:, :cap]
    mrcnn_feats = list(feats[:4])

    cls_logits, cls_probs, cls_bbox = compacted_classifier_stage(
        model, proposals, prop_valid, image_meta, mrcnn_feats,
        chunk=int(classifier_chunk))
    detections, det_valid = refine_detections_batch(
        proposals, cls_probs, cls_bbox, image_meta, model.bbox_std_dev,
        model.detection_min_confidence, model.detection_nms_threshold,
        model.detection_max_instances, nms_xy_only=model.detection_nms_xy_only)
    masks = compacted_mask_stage(model, detections, det_valid, image_meta,
                                 mrcnn_feats, chunk=int(mask_chunk))
    return {
        "detections": detections,
        "detections_valid": det_valid,
        "mrcnn_masks": masks,
        "mrcnn_probs": cls_probs,
        "mrcnn_bbox": cls_bbox,
        "proposals": proposals,
        "proposals_valid": prop_valid,
    }
