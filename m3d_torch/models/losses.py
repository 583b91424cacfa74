"""Loss functions (port of m3d/models/losses.py), in float32 on fixed shapes
with mask-based selection, as JAX computes them:

- rpn_class_loss: softmax CE on +-1 anchors with focal modulation
  (1 - p_t)^1.5 and alpha 0.9 positive weighting.
- rpn_bbox_loss: the r-th positive anchor of an image pairs with packed
  target row r (cumsum rank); Huber with separate XY (delta 1) and Z
  (delta 0.5, half weight) branches, prediction clip +-5, diff clip +-2.
- mrcnn_class_loss: focal gamma 3 alpha 0.85, active-class masking, 2x
  penalty for confident false positives, weight-sum normalisation.
- mrcnn_bbox_loss: soft clip 3 tanh(pred / 3), then Huber delta 1.
- mrcnn_mask_loss: per-class gather, empty targets filtered,
  0.3 BCE + 0.7 Dice.

Each returns (scalar loss, metrics dict of scalar tensors).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-7


def _safe_mean(x, mask, dim=None):
    """Mean of x over the entries mask selects (0 if none)."""
    mask = mask.to(x.dtype)
    if dim is None:
        return (x * mask).sum() / mask.sum().clamp_min(1.0)
    return (x * mask).sum(dim) / mask.sum(dim).clamp_min(1.0)


def _match(rpn_match):
    return rpn_match[..., 0] if rpn_match.ndim == 3 else rpn_match


def rpn_class_loss(rpn_match, rpn_class_logits, alpha: float = 0.90,
                   gamma: float = 1.5):
    """rpn_match: [B, A] int {1, -1, 0}; logits: [B, A, 2]."""
    rpn_match = _match(rpn_match)
    logits = rpn_class_logits.float()
    selected = rpn_match != 0
    labels = (rpn_match == 1).long()
    log_probs = F.log_softmax(logits, dim=-1)
    ce = -log_probs.gather(-1, labels[..., None])[..., 0]
    p_t = torch.exp(-ce)
    focal = torch.pow(1.0 - p_t, gamma) * ce
    alpha_t = torch.where(labels == 1, alpha, 1.0 - alpha)
    loss = _safe_mean(alpha_t * focal, selected)
    return loss, {
        "rpn_class_loss": loss,
        "rpn_n_pos": (rpn_match == 1).sum(),
        "rpn_n_neg": (rpn_match == -1).sum(),
        "rpn_ce_mean": _safe_mean(focal, selected),
    }


def rpn_bbox_loss(target_bbox, rpn_match, rpn_bbox):
    """target_bbox: [B, A_train, 6] packed positives-first in anchor order;
    rpn_match: [B, A]; rpn_bbox: [B, A, 6] predictions."""
    rpn_match = _match(rpn_match)
    pred = rpn_bbox.float().clamp(-5.0, 5.0)
    target = target_bbox.float()
    pos = rpn_match == 1
    rank = (torch.cumsum(pos.long(), dim=1) - 1).clamp(0, target.shape[1] - 1)
    matched = target.gather(1, rank[..., None].expand(-1, -1, 6))
    diff = (matched - pred).clamp(-2.0, 2.0)
    abs_diff = diff.abs()
    xy = diff.new_tensor([1., 1., 0., 1., 1., 0.])
    z = diff.new_tensor([0., 0., 1., 0., 0., 1.])
    huber_xy = torch.where(abs_diff < 1.0, 0.5 * diff * diff,
                           abs_diff - 0.5) * xy
    huber_z = torch.where(abs_diff < 0.5, 0.5 * diff * diff,
                          0.5 * abs_diff - 0.25) * z
    loss = _safe_mean((huber_xy + huber_z).mean(-1), pos)
    return loss, {"rpn_bbox_loss": loss}


def mrcnn_class_loss(target_class_ids, pred_class_logits, active_class_ids,
                     gamma: float = 3.0, alpha: float = 0.85,
                     fp_conf_threshold: float = 0.5, fp_penalty: float = 2.0):
    """targets: [B, T] int; logits: [B, T, C]; active: [B, C]."""
    logits = pred_class_logits.float().clamp(-10.0, 10.0)
    c = logits.shape[-1]
    target = target_class_ids.long().clamp(0, c - 1)
    # The background column is always active.
    active = active_class_ids.float()
    active = torch.cat([torch.ones_like(active[:, :1]), active[:, 1:]], 1)
    true_active = active.gather(1, target)                      # [B, T]

    log_probs = F.log_softmax(logits, dim=-1)
    probs = torch.exp(log_probs)
    ce = -log_probs.gather(-1, target[..., None])[..., 0]
    pt = torch.exp(-ce).clamp(EPS, 1.0 - EPS)
    focal = torch.pow(1.0 - pt, gamma) * ce

    is_fg = (target > 0).float()
    class_weights = is_fg * alpha + (1.0 - is_fg) * (1.0 - alpha)
    max_fg_prob = probs[..., 1:].max(-1).values
    confident_fp = ((target == 0) & (max_fg_prob > fp_conf_threshold)).float()
    focal = focal * (1.0 + confident_fp * (fp_penalty - 1.0))
    weighted = focal * class_weights * true_active
    weight_sum = (class_weights * true_active).sum().clamp_min(EPS)
    loss = weighted.sum() / weight_sum

    pred_labels = logits.argmax(-1)
    pos_mask = is_fg > 0.5
    return loss, {
        "mrcnn_class_loss": loss,
        "class_pos_count": pos_mask.sum(),
        "class_fg_prob": _safe_mean(pt, pos_mask),
        "class_pos_acc": _safe_mean((pred_labels == target).float(),
                                    pos_mask),
        "class_bg_acc": _safe_mean((pred_labels == 0).float(), ~pos_mask),
        "class_confident_fp": confident_fp.sum(),
    }


def mrcnn_bbox_loss(target_bbox, target_class_ids, pred_bbox):
    """targets: [B, T, 6]; class ids: [B, T]; pred: [B, T, C, 6]."""
    target = target_bbox.float()
    pred = pred_bbox.float()
    cls = target_class_ids.long().clamp(0, pred.shape[2] - 1)
    pred_cls = pred.gather(2, cls[..., None, None].expand(-1, -1, 1, 6))[:, :, 0]
    pred_cls = 3.0 * torch.tanh(pred_cls / 3.0)
    abs_diff = (target - pred_cls).abs()
    huber = torch.where(abs_diff <= 1.0, 0.5 * abs_diff * abs_diff,
                        abs_diff - 0.5)
    pos = cls > 0
    loss = _safe_mean(huber.mean(-1), pos)
    return loss, {
        "mrcnn_bbox_loss": loss,
        "bbox_mean_err": _safe_mean(abs_diff.mean(-1), pos),
        "bbox_max_err": torch.where(pos[..., None], abs_diff, 0.0).max(),
        "bbox_pct_large": _safe_mean((abs_diff > 2.0).float().mean(-1), pos),
    }


def mrcnn_mask_loss(target_masks, target_class_ids, pred_masks,
                    bce_weight: float = 0.3, dice_weight: float = 0.7):
    """targets: [B, T, m, m, m]; class ids: [B, T]; pred: [B, T, m, m, m, C]
    sigmoid probabilities."""
    b, t = target_masks.shape[:2]
    yt = target_masks.float().reshape(b, t, -1)
    c = pred_masks.shape[-1]
    yp = pred_masks.float().reshape(b, t, -1, c)
    cls = target_class_ids.long().clamp(0, c - 1)
    yp_cls = yp.gather(3, cls[:, :, None, None].expand(-1, -1, yp.shape[2], 1))
    yp_cls = yp_cls[..., 0].clamp(EPS, 1.0 - EPS)               # [B, T, V]

    valid = (cls > 0) & (yt.sum(-1) > 0)
    bce = -(yt * torch.log(yp_cls) + (1.0 - yt) * torch.log(1.0 - yp_cls))
    bce_loss = _safe_mean(bce.mean(-1), valid)
    inter = (yt * yp_cls).sum(-1)
    union = yt.sum(-1) + yp_cls.sum(-1)
    dice = (2.0 * inter + 1.0) / (union + 1.0)
    dice_mean = _safe_mean(dice, valid)
    any_valid = (valid.sum() > 0).float()
    loss = (bce_weight * bce_loss + dice_weight * (1.0 - dice_mean)) * any_valid
    return loss, {
        "mrcnn_mask_loss": loss,
        "mask_dice": dice_mean,
        "mask_bce": bce_loss,
        "mask_fg_pred": _safe_mean(yp_cls.mean(-1), valid),
        "mask_fg_true": _safe_mean(yt.mean(-1), valid),
        "mask_valid_count": valid.sum(),
    }
