"""Proposal generation (port of m3d/models/proposal.py).

Take the top PRE_NMS_LIMIT anchors by foreground score, de-standardize the
deltas and clip them to +-3, apply them to the anchors, clip to [0, 1],
enforce min sizes, run 3D NMS at RPN_NMS_THRESHOLD and pad to
``proposal_count`` with zero boxes. Proposals come out score-sorted.
"""

from __future__ import annotations

import torch

from m3d_torch import boxes as B
from m3d_torch import trace
from m3d_torch.ops.nms3d import nms_3d


def top_k_stable(scores, k: int):
    """``jax.lax.top_k`` along the last axis: descending, and among equal
    scores the lower index first (``torch.topk`` does not promise that, and
    bf16 RPN probabilities tie often)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def generate_proposals(rpn_probs, rpn_deltas, anchors, rpn_bbox_std_dev,
                       proposal_count: int, nms_threshold: float,
                       pre_nms_limit: int, image_depth: int):
    """rpn_probs [B, A, 2], rpn_deltas [B, A, 6], anchors [A, 6] ->
    (proposals [B, proposal_count, 6] zero-padded,
    valid [B, proposal_count])."""
    scores = rpn_probs.float()[..., 1]
    with trace.waits("table.generate_proposals"):
        std = torch.as_tensor(rpn_bbox_std_dev, dtype=torch.float32,
                              device=scores.device)
    deltas = (rpn_deltas.float() * std).clamp(-3.0, 3.0)
    anchors = anchors.float()
    k = min(pre_nms_limit, anchors.shape[0])
    min_z = max(1.0 / max(float(image_depth), 1.0), 1e-4)

    top_scores, top_idx = top_k_stable(scores, k)                # [B, k]
    top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 6))
    top_anchors = anchors[top_idx]                               # [B, k, 6]
    boxes = B.apply_deltas(top_anchors, top_deltas, clip_log_scale=False)
    boxes = B.enforce_min_size(boxes.clamp(0.0, 1.0), min_yx=1e-6,
                               min_z=min_z)

    idx, valid = nms_3d(boxes, top_scores, nms_threshold,
                        max_output=proposal_count)
    props = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 6))
    props = torch.where(valid[..., None], props, torch.zeros_like(props))
    return props, valid
