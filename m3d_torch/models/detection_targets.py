"""Detection-target sampling: proposals + GT -> fixed-T training targets
(port of m3d/models/detection_targets.py, batched over B without vmap).

Positives are proposals with max-GT-IoU >= the positive threshold, negatives
below the negative one; positives are sampled down to
round(T * ROI_POSITIVE_RATIO), negatives fill the rest. Slot layout: [0,
n_pos) positives, [n_pos, n_pos + n_neg) negatives, the rest padding. Each
positive gets its argmax GT's class, its deltas / BBOX_STD_DEV and its GT
mask cropped to ``mask_shape`` by ``crop_and_resize_3d`` and rounded.

The random order comes from uniforms, one per proposal for the positive
draw and one for the negative draw, from a ``torch.Generator`` on the
proposals' device, or injected as ``uniforms=(r_pos, r_neg)`` ([B, P] each;
the parity tests pass JAX's ``jax.random.uniform`` values under its split
keys, so both packages draw the same samples). A rank of a data-parallel
mesh passes ``shard=(index, count)``: it draws the uniforms of the whole
batch of ``count * B`` rows, as one process would, and keeps its rows.
"""

from __future__ import annotations

import torch

from m3d_torch.boxes import box_hwd, overlaps_3d
from m3d_torch.ops.roialign3d import crop_and_resize_3d

NEG_INF = -1e30


def encode_deltas(boxes, gt_boxes, eps: float = 1e-6):
    """Deltas taking ``boxes`` to ``gt_boxes`` (m3d.boxes.encode_deltas);
    the caller divides by BBOX_STD_DEV."""
    h, w, d = box_hwd(boxes)
    gh, gw, gd = box_hwd(gt_boxes)
    out = []
    for a, (s, g) in enumerate(((h, gh), (w, gw), (d, gd))):
        c = boxes[..., a] + 0.5 * s
        gc = gt_boxes[..., a] + 0.5 * g
        out.append((gc - c) / s.clamp_min(eps))
    for s, g in ((h, gh), (w, gw), (d, gd)):
        out.append(torch.log(g.clamp_min(eps) / s.clamp_min(eps)))
    return torch.stack(out, dim=-1)


def _sample_k(r, eligible, cap: int):
    """Random order of the eligible positions of each row: (idx [B, cap],
    count [B]); idx[:, :count] are the chosen positions, the tail is
    arbitrary. Ties go to the lower index, as ``jax.lax.top_k``."""
    keys = torch.where(eligible, r, torch.full_like(r, NEG_INF))
    idx = torch.sort(keys, dim=1, descending=True, stable=True).indices
    count = eligible.sum(1).clamp_max(cap)
    return idx[:, :cap], count


def detection_targets_batch(proposals, gt_class_ids, gt_boxes, gt_masks,
                            bbox_std_dev, train_rois_per_image: int,
                            roi_positive_ratio: float,
                            positive_iou_threshold: float,
                            negative_iou_threshold: float,
                            mask_shape=(28, 28, 28), use_mini_mask=False,
                            generator=None, uniforms=None, shard=None):
    """proposals [B, P, 6] normalized, zero-padded; gt_class_ids [B, G]
    (0 = padding); gt_boxes [B, G, 6] normalized; gt_masks [B, H, W, D, G]
    full-size masks, or with ``use_mini_mask`` [B, mH, mW, mD, G] masks
    spanning exactly their GT box. Returns a dict with T =
    train_rois_per_image: rois [B, T, 6], gt_boxes [B, T, 6], class_ids
    [B, T] int64, deltas [B, T, 6], masks [B, T, *mask_shape], pos_count
    [B], valid [B, T] bool. No gradient flows through any of it."""
    proposals = proposals.detach().float()
    gt_boxes = gt_boxes.float()
    dev = proposals.device
    bsz, n_prop = proposals.shape[:2]
    T = int(train_rois_per_image)
    pos_cap = min(int(round(T * roi_positive_ratio)), n_prop)
    neg_cap = min(T, n_prop)
    if uniforms is None:
        index, count = shard or (0, 1)
        r_pos, r_neg = (torch.rand((bsz * count, n_prop), generator=generator,
                                   device=dev)[index * bsz:(index + 1) * bsz]
                        for _ in range(2))
    else:
        r_pos, r_neg = (torch.as_tensor(u, device=dev).float()
                        for u in uniforms)

    prop_valid = proposals.abs().sum(-1) > 0                    # [B, P]
    gt_valid = gt_boxes.abs().sum(-1) > 0                       # [B, G]
    overlaps = overlaps_3d(proposals, gt_boxes)                 # [B, P, G]
    overlaps = torch.where(gt_valid[:, None, :] & prop_valid[:, :, None],
                           overlaps, overlaps.new_zeros(()))
    roi_iou_max = overlaps.max(-1).values
    positive = (roi_iou_max >= positive_iou_threshold) & prop_valid
    negative = (roi_iou_max < negative_iou_threshold) & prop_valid

    pos_idx, n_pos = _sample_k(r_pos, positive, pos_cap)
    neg_idx, n_neg_avail = _sample_k(r_neg, negative, neg_cap)
    n_neg = torch.minimum(T - n_pos, n_neg_avail)

    slots = torch.arange(T, device=dev)[None]
    is_pos = slots < n_pos[:, None]
    is_valid = slots < (n_pos + n_neg)[:, None]
    pos_for = pos_idx.gather(1, slots.clamp_max(pos_cap - 1).expand(bsz, -1))
    neg_for = neg_idx.gather(1, (slots - n_pos[:, None]).clamp(0, neg_cap - 1))
    roi_for = torch.where(is_pos, pos_for, neg_for)             # [B, T]

    rois = proposals.gather(1, roi_for[..., None].expand(-1, -1, 6))
    rois = torch.where(is_valid[..., None], rois, rois.new_zeros(()))
    ov_slot = overlaps.gather(
        1, roi_for[..., None].expand(-1, -1, overlaps.shape[-1]))
    gt_assign = ov_slot.argmax(-1)                              # [B, T]
    assigned = gt_boxes.gather(1, gt_assign[..., None].expand(-1, -1, 6))
    assigned = torch.where(is_pos[..., None], assigned, assigned.new_zeros(()))
    class_ids = torch.where(is_pos, gt_class_ids.long().gather(1, gt_assign),
                            torch.zeros_like(gt_assign))
    std = torch.as_tensor(bbox_std_dev, dtype=torch.float32, device=dev)
    deltas = encode_deltas(rois, assigned) / std
    deltas = torch.where(is_pos[..., None], deltas, deltas.new_zeros(()))

    # Mask targets for the first pos_cap slots (positives come first).
    crop_boxes = rois[:, :pos_cap]
    if use_mini_mask:
        # The mini-mask's unit cube is the GT box: express each ROI in it.
        gt_b = assigned[:, :pos_cap]
        corner = torch.cat([gt_b[..., :3], gt_b[..., :3]], -1)
        ext = gt_b[..., 3:] - gt_b[..., :3]
        crop_boxes = (crop_boxes - corner) / torch.cat([ext, ext],
                                                       -1).clamp_min(1e-6)
    n_gt = gt_masks.shape[-1]
    masks_t = gt_masks.float().permute(0, 4, 1, 2, 3).reshape(
        bsz * n_gt, *gt_masks.shape[1:4], 1)
    img = torch.arange(bsz, device=dev)[:, None] * n_gt
    crop = crop_and_resize_3d(masks_t, crop_boxes.reshape(-1, 6),
                              (img + gt_assign[:, :pos_cap]).reshape(-1),
                              mask_shape)[..., 0]
    crop = torch.round(crop).reshape(bsz, pos_cap, *mask_shape)
    masks = torch.zeros((bsz, T, *mask_shape), device=dev)
    masks[:, :pos_cap] = torch.where(is_pos[:, :pos_cap, None, None, None],
                                     crop, crop.new_zeros(()))
    return {"rois": rois, "gt_boxes": assigned, "class_ids": class_ids,
            "deltas": deltas, "masks": masks, "pos_count": n_pos,
            "valid": is_valid}
