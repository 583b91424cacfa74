"""3D greedy non-max suppression, batched (port of m3d/ops/nms3d.py).

``nms_3d`` dispatches on the candidate count N as JAX's does: up to
``FIXPOINT_MAX_N`` the fixpoint algorithm, above it the exact blockwise
greedy, whose memory grows as N and not N^2.

Fixpoint (``nms_3d_fixpoint``): sort by score (stable: among equal scores
the lower index comes first, as ``jnp.argsort`` orders them), build the
triangular suppression matrix ``M[j, i] = (j before i) & (IoU > thr)``
once, then iterate ``alive <- alive0 & ~(alive @ M)`` until it stops
changing. The fixpoint is the greedy keep set. Every image of the batch
runs in the same matrix products; there is no Python loop over boxes.

Blockwise (``nms_3d_blockwise``): boxes in score order, in blocks of
``block_size``. Each block is resolved exactly by the same fixpoint on its
[block, block] tile, then one [B, block, N] IoU propagates the kills of
its kept boxes to every later box.

Output contract (m3d/models/inference.py relies on it): exactly
``max_output`` indices per image, the kept ones first in descending score
order, then padding slots with index 0 and ``valid`` False.

Under ``torch.export`` (m3d_torch/serve.py) no value is read on the host
while tracing: the fixpoint becomes a ``while_loop`` with the same round
cap, and the blockwise greedy a static loop over every block, each gated
by ``torch.cond`` on the live count. Both give the eager forms' bits; the
eager forms, which training and evaluation run, keep their host reads.

``nms_3d_numpy`` is the plain greedy oracle (a copy of JAX's), for the
tests and the card-side checks.
"""

from __future__ import annotations

import numpy as np
import torch

from m3d_torch import trace

NEG_INF = -1e30

# Above this candidate count the fixpoint's [N, N] suppression matrix gets
# too large and nms_3d takes the blockwise greedy; equal to
# m3d/ops/nms3d.py's FIXPOINT_MAX_N.
FIXPOINT_MAX_N = 16384
# The blockwise branch reads its in-block fixpoint's convergence flag on the
# host once per this many rounds (one sync per round would cost more than
# the extra rounds).
CHECK_EVERY = 4


def pairwise_iou(a, b, vol_a, vol_b, eps: float = 1e-10):
    """IoU between [..., A, 6] and [..., M, 6] boxes with their volumes ->
    [..., A, M], each product and sum in the order of JAX's
    ``_pairwise_iou`` and of ``nms_3d_numpy`` (float32 elementwise ops, so
    the card gives the same bits as the CPU)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    d = [torch.clamp_min(torch.minimum(a[..., k + 3], b[..., k + 3])
                         - torch.maximum(a[..., k], b[..., k]), 0.0)
         for k in range(3)]
    inter = d[0] * d[1] * d[2]
    union = torch.clamp_min(vol_a[..., :, None] + vol_b[..., None, :] - inter,
                            eps)
    return inter / union


def _volume(boxes):
    return ((boxes[..., 3] - boxes[..., 0]) * (boxes[..., 4] - boxes[..., 1])
            * (boxes[..., 5] - boxes[..., 2]))


def _sorted(boxes, scores, valid):
    """float32 boxes and scores (invalid scores at NEG_INF), sorted by
    descending score (stable): (order, boxes_s, vols_s, alive0)."""
    boxes = boxes.float()
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    b, n = scores.shape
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 6))
    alive0 = torch.gather(scores, 1, order) > NEG_INF / 2
    return order, boxes_s, _volume(boxes_s), alive0


def _select(order, kept, max_output: int, n: int):
    """Kept slots first (in score order), then the rest in position order:
    the order jax.lax.top_k gives on key = where(kept, -pos, -inf). Indices
    of padding rows (>= n) are clamped to n - 1 and never valid."""
    b, n_all = kept.shape
    k = min(max_output, n_all)
    sel = torch.sort((~kept).to(torch.uint8), dim=1, stable=True).indices
    sel = sel[:, :k]
    out_valid = torch.gather(kept, 1, sel)
    idx = torch.clamp_max(torch.gather(order, 1, sel), max(n - 1, 0))
    indices = torch.where(out_valid, idx, torch.zeros_like(sel))
    if max_output > k:
        pad = max_output - k
        indices = torch.cat([indices, indices.new_zeros(b, pad)], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(b, pad)], dim=1)
    return indices, out_valid


def _fixpoint(alive0, sup, check_every: int, max_rounds: int):
    """Iterate alive <- alive0 & ~(alive @ sup) from alive0 ([B, n] bool,
    sup [B, n, n] float) for at most ``max_rounds`` rounds; the host reads
    whether the last round changed anything once every ``check_every``
    rounds. Under export: ``_fixpoint_traced``, the same set (rounds past
    the fixpoint change nothing, and both stop at the cap). Counts the
    rounds as ``nms.rounds``."""
    if torch.compiler.is_exporting():
        return _fixpoint_traced(alive0, sup, max_rounds)
    alive = alive0
    rounds = 0
    while rounds < max_rounds:
        for _ in range(min(check_every, max_rounds - rounds)):
            prev = alive
            killed = torch.bmm(alive.float()[:, None, :], sup)[:, 0] > 0.5
            alive = alive0 & ~killed
            rounds += 1
        if not trace.host_read((alive != prev).any(), "nms.fixpoint"):
            break
    trace.count("nms.rounds", rounds)
    return alive


def _fixpoint_traced(alive0, sup, max_rounds: int):
    """``_fixpoint`` as one ``while_loop``: a round runs while the last one
    changed something and fewer than ``max_rounds`` have run. The loop
    reads its predicate when the graph runs, never while tracing. The
    operators are called directly, every tensor passed in (their graphs
    lift no captured tensor), as ``chunked_roi_stage_traced`` does."""
    def cond(rounds, alive, changed, alive0, sup):
        return changed & (rounds < max_rounds)

    def body(rounds, alive, changed, alive0, sup):
        killed = torch.bmm(alive.float()[:, None, :], sup)[:, 0] > 0.5
        nxt = alive0 & ~killed
        return rounds + 1, nxt, (nxt != alive).any()

    start = (torch.zeros((), dtype=torch.int64, device=alive0.device),
             alive0.clone(),
             torch.ones((), dtype=torch.bool, device=alive0.device))
    return torch.ops.higher_order.while_loop(cond, body, start,
                                             (alive0, sup))[1]


def nms_3d(boxes, scores, iou_threshold: float, max_output: int,
           valid=None, block_size: int = 128):
    """Greedy NMS over [B, N, 6] boxes and [B, N] scores: the fixpoint for
    N <= FIXPOINT_MAX_N, else the blockwise greedy (as m3d.ops.nms3d.nms_3d
    dispatches). Returns (indices [B, max_output] int64 into the N axis,
    valid [B, max_output] bool). Opens the ``nms`` span."""
    with trace.span("nms"):
        if scores.shape[1] <= FIXPOINT_MAX_N:
            return nms_3d_fixpoint(boxes, scores, iou_threshold, max_output,
                                   valid=valid)
        return nms_3d_blockwise(boxes, scores, iou_threshold, max_output,
                                valid=valid, block_size=block_size)


def nms_3d_fixpoint(boxes, scores, iou_threshold: float, max_output: int,
                    valid=None, max_rounds: int = 64):
    """The fixpoint greedy (port of m3d.ops.nms3d.nms_3d_fixpoint): one
    [B, N, N] suppression matrix, at most ``max_rounds`` rounds, one bool
    read on the host per round."""
    n = scores.shape[1]
    order, boxes_s, vols, alive0 = _sorted(boxes, scores, valid)
    iou = pairwise_iou(boxes_s, boxes_s, vols, vols)      # [B, N, N]
    pos = torch.arange(n, device=boxes_s.device)
    earlier = pos[:, None] < pos[None, :]                 # j before i
    sup = ((iou > iou_threshold) & earlier).float()       # [B, N(j), N(i)]
    del iou
    alive = _fixpoint(alive0, sup, 1, max_rounds)
    return _select(order, alive, max_output, n)


def nms_3d_blockwise(boxes, scores, iou_threshold: float, max_output: int,
                     valid=None, block_size: int = 128):
    """Exact greedy NMS in blocks (port of m3d.ops.nms3d.nms_3d_blockwise,
    batched over B).

    Inputs are padded with -inf scores to a multiple of ``block_size`` and
    to at least ``max_output``. Each block's boxes, minus those killed by
    earlier blocks, are resolved by the fixpoint on the block's
    [block, block] tile (at most ``block_size`` rounds, which settle any
    chain; the host reads the convergence flag every ``CHECK_EVERY``
    rounds); its kept boxes then kill every later box they overlap through
    one [B, block, N] IoU. Blocks past the last live box (invalid and
    padding rows sort last) are skipped: one host read for their count.
    The largest tensor is [B, block, N]: no [B, N, N] is allocated.
    """
    boxes = boxes.float()
    scores = scores.float()
    b, n = scores.shape
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    n_min = max(n, max_output)
    n_pad = (n_min - n) + ((-n_min) % block_size)
    if n_pad:
        boxes = torch.cat([boxes, boxes.new_zeros(b, n_pad, 6)], dim=1)
        scores = torch.cat([scores, scores.new_full((b, n_pad), NEG_INF)],
                           dim=1)
    n_total = n + n_pad
    order, boxes_s, vols, alive0 = _sorted(boxes, scores, None)

    pos = torch.arange(block_size, device=boxes.device)
    earlier = pos[:, None] < pos[None, :]
    if torch.compiler.is_exporting():
        kept = _blockwise_traced(boxes_s, vols, alive0, earlier,
                                 iou_threshold, block_size)
        return _select(order, kept, max_output, n)
    suppressed = torch.zeros_like(alive0)
    kept = torch.zeros_like(alive0)
    n_live = trace.host_read(alive0.sum(1).max(), "nms.blockwise") if b \
        else 0
    for start in range(0, n_live, block_size):
        end = start + block_size
        blk, blk_vols = boxes_s[:, start:end], vols[:, start:end]
        iou = pairwise_iou(blk, blk, blk_vols, blk_vols)
        sup = ((iou > iou_threshold) & earlier).float()
        blk_alive0 = alive0[:, start:end] & ~suppressed[:, start:end]
        blk_kept = _fixpoint(blk_alive0, sup, CHECK_EVERY, block_size)
        kept[:, start:end] = blk_kept
        if end < n_total:
            iou = pairwise_iou(blk, boxes_s[:, end:], blk_vols, vols[:, end:])
            kills = ((iou > iou_threshold) & blk_kept[:, :, None]).any(1)
            suppressed[:, end:] |= kills
    return _select(order, kept, max_output, n)


def _block_step(start: int, end: int, n_total: int, iou_threshold: float,
                block_size: int):
    """The live branch of block [start, end) in ``_blockwise_traced``."""
    def live(kept, suppressed, boxes_s, vols, alive0, earlier):
        blk, blk_vols = boxes_s[:, start:end], vols[:, start:end]
        iou = pairwise_iou(blk, blk, blk_vols, blk_vols)
        sup = ((iou > iou_threshold) & earlier).float()
        blk_alive0 = alive0[:, start:end] & ~suppressed[:, start:end]
        blk_kept = _fixpoint_traced(blk_alive0, sup, block_size)
        kept = torch.cat([kept[:, :start], blk_kept, kept[:, end:]], 1)
        if end < n_total:
            iou = pairwise_iou(blk, boxes_s[:, end:], blk_vols, vols[:, end:])
            kills = ((iou > iou_threshold) & blk_kept[:, :, None]).any(1)
            suppressed = torch.cat(
                [suppressed[:, :end], suppressed[:, end:] | kills], 1)
        else:
            suppressed = suppressed.clone()
        return kept, suppressed

    return live


def _blockwise_traced(boxes_s, vols, alive0, earlier, iou_threshold: float,
                      block_size: int):
    """The block loop of ``nms_3d_blockwise`` for export: every block of the
    padded axis, each under a ``cond`` on ``start < n_live`` (a device
    value), written without in-place updates. A dead block leaves ``kept``
    and ``suppressed`` as they were, as the eager loop that stops before it
    does. Returns ``kept`` [B, N_total] bool."""
    b, n_total = alive0.shape
    n_live = alive0.sum(1).max() if b else alive0.new_zeros((), torch.int64)
    suppressed = torch.zeros_like(alive0)
    kept = torch.zeros_like(alive0)

    def dead(kept, suppressed, boxes_s, vols, alive0, earlier):
        return kept.clone(), suppressed.clone()

    for start in range(0, n_total, block_size):
        live = _block_step(start, start + block_size, n_total, iou_threshold,
                           block_size)
        kept, suppressed = torch.ops.higher_order.cond(
            n_live > start, live, dead,
            (kept, suppressed, boxes_s, vols, alive0, earlier))
    return kept


def nms_3d_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
                 max_output: int):
    """Plain-numpy greedy NMS oracle over one image's [N, 6] boxes and [N]
    scores (a copy of m3d.ops.nms3d.nms_3d_numpy). Returns the kept indices
    in descending score order, at most ``max_output``."""
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    vols = (
        (boxes[:, 3] - boxes[:, 0])
        * (boxes[:, 4] - boxes[:, 1])
        * (boxes[:, 5] - boxes[:, 2])
    )
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0 and len(keep) < max_output:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        yy1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        xx1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        zz1 = np.maximum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        xx2 = np.minimum(boxes[i, 4], boxes[rest, 4])
        zz2 = np.minimum(boxes[i, 5], boxes[rest, 5])
        inter = (
            np.maximum(yy2 - yy1, 0) * np.maximum(xx2 - xx1, 0)
            * np.maximum(zz2 - zz1, 0)
        )
        union = np.maximum(vols[i] + vols[rest] - inter, 1e-10)
        iou = inter / union
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int32)
