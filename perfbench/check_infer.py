"""The comparison that decides ``correct`` for an inference cell.

For each sampled batch the float32 reference (perfbench/reference) works
out, from the same volumes and the same weights, everything the program's
outputs claim, stage by stage, and nine numbers say how far the program
lies from it. Top-k, NMS and the confidence threshold flip on rounding
near ties, so the reference follows the program's own proposals and
classifier outputs where a stage consumes them, and each selection is
judged by what it guarantees instead of by equality:

- ``prop_err_vox``: each valid proposal against the nearest box that the
  reference decodes from any anchor of the same image (trunk, RPN head and
  box decoding), L-inf in voxels; the widest. ``prop_err_p99``: the 99th
  percentile of the same gaps over the batch's valid proposals.
- ``prop_rank_gap``: the top-k and the keeping of the best survivors. Each
  valid proposal's reference objectness (the best score among the anchors
  whose decoded box lies within ``rank_tol_vox`` voxels of it, or the
  nearest's) against the least score a proposal may have in the
  reference's own selection (its last kept proposal where its list is
  full, else its PRE_NMS_LIMIT-th candidate), in logits: how far the
  lowest proposal falls below it.
- ``prop_overlap``: the proposal NMS. The largest IoU between two valid
  proposals of one image; NMS keeps none above RPN_NMS_THRESHOLD.
- ``cls_err``: foreground probability of every valid proposal against the
  reference's classifier on the program's proposal boxes; the widest gap.
- ``bbox_err``: the class-1 box deltas of the same rows; the widest gap.
- ``det_refine_vox``: the detection layer. The reference's detection
  layer on the program's own proposals and classifier outputs against the
  program's detections: the widest L-inf gap, in voxels, from a detection
  on either side to the nearest of the other side's in the same image (the
  image's largest side where the other side has none).
- ``det_overlap``: the detection NMS. The largest IoU between two valid
  detections of one image (in the plane where the configuration's NMS is
  xy-only); NMS keeps none above DETECTION_NMS_THRESHOLD.
- ``mask_err``: the reference's mask head on each valid program detection
  box against the program's mask there: the mean absolute gap of the
  class-1 mask over the detection's voxels; the widest detection.

Each number is the widest over the sampled batches. A non-finite number
fails its limit.
"""

from __future__ import annotations

import sys

import torch

from perfbench.reference.maskrcnn import iou

NUMBERS = ("prop_err_vox", "prop_err_p99", "prop_rank_gap", "prop_overlap",
           "cls_err", "bbox_err", "det_refine_vox", "det_overlap",
           "mask_err")


def nearest_box_vox(props, boxes, scores, scale, tol: float,
                    block: int = 4096):
    """Per row of ``props`` [n, 6]: the least L-inf distance in voxels to
    any row of ``boxes`` [A, 6], and the best of ``scores`` [A] among the
    boxes within ``tol`` voxels and the nearest box."""
    n = props.shape[0]
    best = torch.full((n,), float("inf"), device=props.device)
    near = torch.full((n,), float("-inf"), device=props.device)
    within = torch.full((n,), float("-inf"), device=props.device)
    for s in range(0, boxes.shape[0], block):
        d = ((props[:, None, :] - boxes[None, s:s + block, :]).abs()
             * scale).amax(-1)
        sc = scores[s:s + block]
        dmin, arg = d.min(1)
        near = torch.where(dmin < best, sc[arg], near)
        best = torch.minimum(best, dmin)
        within = torch.maximum(within, torch.where(
            d <= tol, sc[None, :], float("-inf")).amax(1))
    return best, torch.maximum(within, near)


def logit(p):
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def max_overlap(boxes) -> float:
    """The largest IoU between two rows of ``boxes`` [n, 6]."""
    if boxes.shape[0] < 2:
        return 0.0
    o = iou(boxes, boxes)
    o.fill_diagonal_(0.0)
    return float(o.max())


def two_sided_vox(a, b, big: float) -> float:
    """The widest L-inf distance from a row of ``a`` or ``b`` ([n, 6] in
    voxels) to the nearest row of the other; ``big`` where one is empty
    and the other not."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return big if a.shape[0] + b.shape[0] else 0.0
    d = (a[:, None, :] - b[None, :, :]).abs().amax(-1)
    return float(torch.maximum(d.amin(1).max(), d.amin(0).max()))


@torch.no_grad()
def batch_numbers(ref, anchors, images, meta, out, compare: dict) -> dict:
    """The numbers for one batch: ``out`` the program's outputs (any
    device), ``images`` [B, H, W, D, C] and ``meta`` [B, META] on the
    reference's device."""
    cfg = ref.cfg
    dev = images.device
    out = {k: v.to(dev) for k, v in out.items()}
    h, w, d = (float(v) for v in meta[0, 5:8])
    scale = torch.tensor([h, w, d, h, w, d], device=dev)
    fms = ref.features(images)
    scores, boxes = ref.rpn_scores_boxes(fms, anchors)
    _, _, floor = ref.proposals(scores, boxes)
    props, pvalid = out["proposals"].float(), out["proposals_valid"]
    bsz = props.shape[0]
    tol = float(compare["rank_tol_vox"])

    gaps, below = [], []
    prop_overlap = 0.0
    for b in range(bsz):
        p = props[b][pvalid[b]]
        if p.numel():
            g, s = nearest_box_vox(p, boxes[b], scores[b], scale, tol)
            gaps.append(g)
            below.append((logit(floor[b]) - logit(s)).clamp_min(0.0))
        prop_overlap = max(prop_overlap, max_overlap(p))
    gaps = torch.cat(gaps) if gaps else torch.zeros(1, device=dev)
    prop_err = float(gaps.max())
    prop_err_p99 = float(torch.quantile(gaps, 0.99))
    rank_gap = float(torch.cat(below).max()) if below else 0.0

    probs, deltas = ref.classify(props, meta, fms)
    live = pvalid
    cls_err = float((out["mrcnn_probs"].float()[..., 1] - probs[..., 1])
                    .abs()[live].max()) if live.any() else 0.0
    bbox_err = float((out["mrcnn_bbox"].float()[..., 1, :] - deltas[..., 1, :])
                     .abs()[live].max()) if live.any() else 0.0

    rdet, rvalid_d = ref.refine(props, out["mrcnn_probs"].float(),
                                out["mrcnn_bbox"].float(), meta)
    pdet, pvalid_d = out["detections"].float(), out["detections_valid"]
    xy_only = bool(cfg.get("DETECTION_NMS_XY_ONLY", False))
    refine_vox = det_overlap = 0.0
    for b in range(bsz):
        r = rdet[b][rvalid_d[b], :6] * scale
        p = pdet[b][pvalid_d[b], :6] * scale
        refine_vox = max(refine_vox, two_sided_vox(r, p, max(h, w, d)))
        if xy_only:
            p = p.clone()
            p[:, 2], p[:, 5] = 0.0, 1.0
        det_overlap = max(det_overlap, max_overlap(p))

    rows = torch.nonzero(pvalid_d)
    mask_err = 0.0
    if rows.numel():
        rmask = ref.masks(pdet[rows[:, 0], rows[:, 1], :6], rows[:, 0], meta,
                          fms)
        pmask = out["mrcnn_masks"].float()[rows[:, 0], rows[:, 1]]
        gap = (pmask[..., 1] - rmask[..., 1]).abs().flatten(1).mean(1)
        mask_err = float(gap.max())
    return {"prop_err_vox": prop_err, "prop_err_p99": prop_err_p99,
            "prop_rank_gap": rank_gap, "prop_overlap": prop_overlap,
            "cls_err": cls_err, "bbox_err": bbox_err,
            "det_refine_vox": refine_vox, "det_overlap": det_overlap,
            "mask_err": mask_err}


def worst(readings: list[dict]) -> dict:
    """The widest reading of each number over batches (NaN wins)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings]
        out[k] = float("nan") if any(v != v for v in vals) else max(vals)
    return out


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the cell gives a limit within it, {name: {"value",
    "limit"}}). A number without a limit in the cell's file is worked out
    but not compared: its control does not separate it from the program
    (perfbench/workloads/<cell>.json says so)."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS
             if k in limits}
    ok = all(numbers[k] <= limits[k] for k in table)   # NaN fails
    return ok, table


def run_check(cell, pool, kept, seed: int, dev, root: str):
    """The reference over the sampled window batches ``kept`` ((pool
    indices, outputs on the host) pairs): (correct, each number beside its
    limit, volumes of the batches that fail a limit). Runs after the
    program's state is freed, one image or one block of rows at a time.
    Also returns every number, compared or not."""
    from perfbench.infer import image_meta, reference_state
    from perfbench.reference.anchors import anchors as ref_anchors
    from perfbench.reference.maskrcnn import Reference, float32_math

    cfg = cell.config["model"]
    limits = cell.check["limits"]
    with float32_math(), torch.no_grad():
        ref = Reference(cfg).to(dev)
        ref.load_state_dict(reference_state(cell.config, seed, dev, root),
                            strict=True)
        anchors = torch.as_tensor(ref_anchors(cfg), device=dev)
        meta = torch.as_tensor(image_meta(cfg, int(cell.traffic["batch"])),
                               device=dev)
        readings, failed = [], 0
        for idx, out in kept:
            images = pool[torch.as_tensor(idx, device=dev)]
            r = batch_numbers(ref, anchors, images, meta, out,
                              cell.check["compare"])
            readings.append(r)
            if not judged(r, limits)[0]:
                failed += len(idx)
    numbers = worst(readings)
    ok, table = judged(numbers, limits)
    for k in NUMBERS:
        if k not in table:
            print(f"not compared: {k} = {numbers[k]!r}", file=sys.stderr)
    return ok, table, failed, numbers
