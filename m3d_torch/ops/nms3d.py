"""3D greedy non-max suppression, batched (port of ``nms_3d_fixpoint`` in
m3d/ops/nms3d.py).

Sort by score (stable: among equal scores the lower index comes first, as
``jnp.argsort`` orders them), build the triangular suppression matrix
``M[j, i] = (j before i) & (IoU > thr)`` once, then iterate
``alive <- alive0 & ~(alive @ M)`` until it stops changing. The fixpoint is
the greedy keep set. Every image of the batch runs in the same matrix
products; there is no Python loop over boxes.

Output contract (m3d/models/inference.py relies on it): exactly
``max_output`` indices per image, the kept ones first in descending score
order, then padding slots with index 0 and ``valid`` False.
"""

from __future__ import annotations

import torch

from m3d_torch.boxes import overlaps_3d

NEG_INF = -1e30


def nms_3d(boxes, scores, iou_threshold: float, max_output: int,
           valid=None, max_rounds: int = 64):
    """Greedy NMS over [B, N, 6] boxes and [B, N] scores.

    Returns (indices [B, K] int64 into the N axis, valid [B, K] bool).
    Reads one bool per round on the host to stop at the fixpoint.
    """
    boxes = boxes.float()
    scores = scores.float()
    b, n = scores.shape
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))

    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 6))
    scores_s = torch.gather(scores, 1, order)
    alive0 = scores_s > NEG_INF / 2

    iou = overlaps_3d(boxes_s, boxes_s, eps=1e-10)        # [B, N, N]
    pos = torch.arange(n, device=boxes.device)
    earlier = pos[:, None] < pos[None, :]                 # j before i
    sup = ((iou > iou_threshold) & earlier).float()       # [B, N(j), N(i)]
    del iou

    alive = alive0
    for _ in range(max_rounds):
        killed = torch.bmm(alive.float()[:, None, :], sup)[:, 0] > 0.5
        new_alive = alive0 & ~killed
        changed = bool((new_alive != alive).any())
        alive = new_alive
        if not changed:
            break

    # Kept slots first (in score order), then the rest in position order:
    # the order jax.lax.top_k gives on key = where(alive, -pos, -inf).
    k = min(max_output, n)
    sel = torch.sort((~alive).to(torch.uint8), dim=1, stable=True).indices
    sel = sel[:, :k]
    out_valid = torch.gather(alive, 1, sel)
    indices = torch.where(out_valid, torch.gather(order, 1, sel),
                          torch.zeros_like(sel))
    if max_output > n:
        pad = max_output - n
        indices = torch.cat([indices, indices.new_zeros(b, pad)], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(b, pad)], dim=1)
    return indices, out_valid
