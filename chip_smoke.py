"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives m3d_torch's adaptive Mask R-CNN inference at the bench configuration
(128^3 volumes, batch 4, ResNet-50, bf16) on the tracked checkpoint
weights/bench_ckpt.f16.msgpack and four seeded synthetic volumes, through
the compact mask-stage ROIAlign kernel (m3d_torch/csrc/roialign_compact.cu).
Phases, each printing one flushed line with the elapsed seconds:

  env       card name and power limit, torch/CUDA versions, nvcc; arms a
            watchdog that dumps every thread's stack and exits non-zero
  build     nvcc build of the kernel library (or the cached one)
  load      flax msgpack -> state dict; fails if a tensor is missing
  kernel    kernel vs its plain PyTorch version on random compact batches
            at the bench shapes, total in {0, 1, 37, N}
  adaptive  adaptive_inference on the bench volumes; recall against GT
            must be >= 0.7 and the kernel must have been launched
  captured  kernel vs plain version on the mask-stage inputs of `adaptive`
  time      adaptive vol/s, and kernel / plain / F.grid_sample ms with the
            kernel's memory bound, all timed with CUDA events

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Writes nothing into the tree but m3d_torch/_build/.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.dont_write_bytecode = True  # leave no __pycache__ in the checkout

WATCHDOG_S = 1100          # below the 1200 s limit the smoke runs under
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores
BATCH, SIZE = 4, 128
RECALL_FLOOR = 0.7
KERNEL_TOL = 1e-2          # x max|ref|: one bf16 rounding of the output
REPLACES = "m3d/ops/pallas_roialign.py:1022"  # _kernel_vmem_compact

T0 = time.perf_counter()


def phase(name: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.1f}s] {name}: {msg}", flush=True)


def bench_config():
    from m3d_torch.config import Config

    return Config(
        IMAGE_SIZE=SIZE, IMAGE_DEPTH=SIZE,
        BACKBONE_STRIDES=[(4, 4, 4), (8, 8, 8), (16, 16, 16), (32, 32, 32),
                          (64, 64, 64)],
        RPN_ANCHOR_SCALES=(16, 24, 32, 48, 64),
        RPN_ANCHOR_RATIOS=[0.75, 1.0, 1.33],
        PRE_NMS_LIMIT=6000, POST_NMS_ROIS_INFERENCE=500,
        DETECTION_MAX_INSTANCES=50,
        FPN_CLASSIF_FC_LAYERS_SIZE=512,
    )


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back runs (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(args, label: str) -> float:
    """Kernel vs plain version on the same inputs; returns max abs error."""
    from m3d_torch.ops.roialign_compact import (roialign_compact,
                                                roialign_compact_plain)

    levels, bat, total, pos, fms = args
    got = roialign_compact(*args)
    ref = roialign_compact_plain(levels, bat, total, pos,
                                 [f.float() for f in fms])
    torch.cuda.synchronize()
    t = int(total)
    err = (got.float() - ref).abs().max().item() if got.numel() else 0.0
    scale = ref.abs().max().item() if ref.numel() else 0.0
    if err > KERNEL_TOL * scale:
        raise AssertionError(f"{label}: max abs err {err} > "
                             f"{KERNEL_TOL} * max|ref| {scale}")
    if (got[t:] != 0).any():
        raise AssertionError(f"{label}: rows >= total={t} are not zero")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{label}: non-finite output")
    phase("kernel", f"{label}: N={pos.shape[0]} total={t} "
          f"max_abs_err={err:.3e} max|ref|={scale:.3e}")
    return err


def random_compact_batch(fms, n: int, total: int, p: int, gen):
    """Compact ROI rows at the bench shapes: image-grouped live rows first,
    levels cycling over all four, boxes inside the unit cube."""
    from m3d_torch.ops.roialign3d import axis_positions

    dev = fms[0].device
    bsz = fms[0].shape[0]
    lo = torch.rand(n, 3, generator=gen, device=dev) * 0.6
    ext = 0.05 + torch.rand(n, 3, generator=gen, device=dev) * 0.35
    boxes = torch.cat([lo, (lo + ext).clamp(max=1.0)], dim=1)
    levels = (torch.arange(n, device=dev) % 4).to(torch.int32)
    bat = torch.sort(torch.randint(0, bsz, (n,), generator=gen,
                                   device=dev)).values.to(torch.int32)
    dims = torch.tensor([f.shape[1:4] for f in fms], device=dev)[levels.long()]
    pos = torch.stack([axis_positions(boxes[:, a], boxes[:, a + 3],
                                      dims[:, a], p) for a in range(3)], 1)
    total_t = torch.tensor(total, dtype=torch.int32, device=dev)
    return levels, bat, total_t, pos.contiguous(), fms


def touched_voxels(levels, bat, total, pos, fms) -> int:
    """Distinct feature voxels the live rows' 8-tap samples read."""
    t = int(total)
    count = 0
    for lv in range(4):
        rows = (torch.nonzero(levels[:t] == lv).flatten())
        if rows.numel() == 0:
            continue
        b, h, w, d = fms[lv].shape[:4]
        occ = torch.zeros(b, h, w, d, dtype=torch.bool, device=pos.device)
        idx = []
        for a, size in enumerate((h, w, d)):
            pc = pos[rows, a].clamp(0, size - 1)
            i0 = pc.floor().long()
            idx.append(torch.cat([i0, (i0 + 1).clamp(max=size - 1)], 1))
        yy, xx, zz = idx
        bb = bat[rows].long()[:, None, None, None]
        occ[bb, yy[:, :, None, None], xx[:, None, :, None],
            zz[:, None, None, :]] = True
        count += int(occ.sum())
    return count


def kernel_bound_ms(args) -> float:
    """Least time for the function's bytes on this card: the output written
    once, each voxel the live rows touch read once, the row metadata read
    once. (Its ~16 float32 flops per live output element are far below.)"""
    levels, bat, total, pos, fms = args
    n, _, p = pos.shape
    c, item = fms[0].shape[-1], fms[0].element_size()
    out_bytes = n * p ** 3 * c * item
    in_bytes = touched_voxels(*args) * c * item + pos.numel() * 4 + 8 * n + 4
    ops = 16 * int(total) * p ** 3 * c
    return max((out_bytes + in_bytes) / HBM_BYTES_PER_S,
               ops / FP32_FLOPS) * 1e3


def grid_sample_call(args):
    """One F.grid_sample over the same pooled rows, as a yardstick only:
    levels zero-padded to one extent, rows of each (image, level) pair
    stacked along the output's first axis. Returns a closure to time."""
    import torch.nn.functional as F

    levels, bat, total, pos, fms = args
    t = int(total)
    p = pos.shape[2]
    ext = [max(f.shape[1 + a] for f in fms) for a in range(3)]
    bsz = fms[0].shape[0]
    groups = [(lv, b) for lv in range(4) for b in range(bsz)]
    inp = torch.zeros(len(groups), fms[0].shape[-1], *ext,
                      dtype=fms[0].dtype, device=pos.device)
    rows_of = []
    for g, (lv, b) in enumerate(groups):
        f = fms[lv][b]
        h, w, d = f.shape[:3]
        inp[g, :, :h, :w, :d] = f.permute(3, 0, 1, 2)
        rows_of.append(torch.nonzero((levels[:t] == lv) & (bat[:t] == b))
                       .flatten())
    r_max = max(1, max(len(r) for r in rows_of))
    grid = torch.zeros(len(groups), r_max * p, p, p, 3, device=pos.device)
    for g, rows in enumerate(rows_of):
        if len(rows) == 0:
            continue
        norm = [pos[rows, a] / (ext[a] - 1) * 2 - 1 for a in range(3)]
        ny, nx, nz = (v.reshape(len(rows), p) for v in norm)
        sl = grid[g, :len(rows) * p].view(len(rows), p, p, p, 3)
        sl[..., 0] = nz[:, None, None, :]     # innermost input axis (z)
        sl[..., 1] = nx[:, None, :, None]
        sl[..., 2] = ny[:, :, None, None]
    grid = grid.to(inp.dtype)
    return lambda: F.grid_sample(inp, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def stage_ms(model, image, meta_b, anchors, chunks) -> dict:
    """CUDA-event ms of each stage of one adaptive step, chained as
    adaptive_inference chains them (host syncs inside a stage count in
    its time)."""
    from m3d_torch.models.detection import refine_detections_batch
    from m3d_torch.models.inference import (compacted_classifier_stage,
                                            compacted_mask_stage)

    names = ("trunk", "rpn_head", "proposals", "classifier", "detection",
             "mask")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    torch.cuda.synchronize()
    with torch.no_grad():
        ev[0].record()
        feats = model.extract_features(image)
        ev[1].record()
        _, probs, deltas = model.rpn_forward(list(feats))
        ev[2].record()
        props, pvalid = model.propose(probs, deltas, anchors)
        ev[3].record()
        _, cls_probs, cls_bbox = compacted_classifier_stage(
            model, props, pvalid, meta_b, list(feats[:4]), chunks[0])
        ev[4].record()
        det, dvalid = refine_detections_batch(
            props, cls_probs, cls_bbox, meta_b, model.bbox_std_dev,
            model.detection_min_confidence, model.detection_nms_threshold,
            model.detection_max_instances,
            nms_xy_only=model.detection_nms_xy_only)
        ev[5].record()
        compacted_mask_stage(model, det, dvalid, meta_b, list(feats[:4]),
                             chunks[1])
        ev[6].record()
    torch.cuda.synchronize()
    return {n: round(ev[i].elapsed_time(ev[i + 1]), 3)
            for i, n in enumerate(names)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # env --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    phase("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} nvcc {nvcc} "
          f"device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(smi, flush=True)

    from m3d_torch.anchors import normalized_pyramid_anchors
    from m3d_torch.checkpoints import (load_params, params_from_jax,
                                       restore_by_name)
    from m3d_torch.data.synthetic import make_volumes
    from m3d_torch.image_meta import default_meta
    from m3d_torch.models.inference import adaptive_inference, default_chunks
    from m3d_torch.models.mask_rcnn import MaskRCNN
    from m3d_torch.ops import roialign3d
    from m3d_torch.ops import roialign_compact as rc
    from m3d_torch.utils.metrics import detection_recall

    # build ------------------------------------------------------------
    t = time.perf_counter()
    rc.load_library()
    ptxas = " | ".join(ln.strip() for ln in rc.KERNEL.build_log.splitlines()
                       if "registers" in ln or "spill" in ln)
    phase("build", f"{time.perf_counter() - t:.2f}s "
          f"({'built' if rc.KERNEL.build_seconds else 'cached'}) {ptxas}")

    # load -------------------------------------------------------------
    t = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tree, meta = load_params(os.path.join(here, "weights",
                                          "bench_ckpt.f16.msgpack"))
    cfg = bench_config()
    model = MaskRCNN.from_config(cfg, mode="inference", device=dev).eval()
    stats = restore_by_name(model, params_from_jax(tree))
    del tree
    phase("load", f"{time.perf_counter() - t:.2f}s loaded={stats['loaded']} "
          f"skipped={stats['skipped']} missing={stats['missing']} "
          f"(checkpoint epoch {meta.get('epoch')})")
    if stats["missing"] or stats["skipped"]:
        raise AssertionError(f"checkpoint does not cover the model: {stats}")

    # kernel: random compact batches at the bench shapes ------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    m = cfg.MASK_POOL_SIZE
    shapes = cfg.backbone_shapes()[:4]
    fms = [torch.randn(BATCH, *map(int, s), cfg.TOP_DOWN_PYRAMID_SIZE,
                       generator=gen, device=dev).to(torch.bfloat16)
           for s in shapes]
    n_rows = BATCH * cfg.DETECTION_MAX_INSTANCES
    errs = {}
    for total in (0, 1, 37, n_rows):
        args = random_compact_batch(fms, n_rows, total, m, gen)
        errs[f"random total={total}"] = compare(args, f"random total={total}")
    del fms

    # adaptive ---------------------------------------------------------
    image, gt_boxes = make_volumes(BATCH, SIZE)
    anchors = torch.as_tensor(normalized_pyramid_anchors(cfg), device=dev)
    meta_b = torch.as_tensor(np.tile(default_meta(cfg)[None], (BATCH, 1)),
                             device=dev)
    image = torch.as_tensor(image, device=dev)
    cls_chunk, mask_chunk = default_chunks(model)
    captured = []
    real_kernel = roialign3d.roialign_compact

    def capture(*args):
        captured.append(args)
        return real_kernel(*args)

    def run():
        return adaptive_inference(model, image, meta_b, anchors,
                                  classifier_chunk=cls_chunk,
                                  mask_chunk=mask_chunk)

    roialign3d.roialign_compact = capture
    t = time.perf_counter()
    rc.KERNEL.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = rc.KERNEL.launches
    roialign3d.roialign_compact = real_kernel
    first_s = time.perf_counter() - t
    det = out["detections"].float().cpu().numpy()
    valid = out["detections_valid"].cpu().numpy()
    masks = out["mrcnn_masks"]
    n_gt, n_match, n_det = detection_recall(det, valid, gt_boxes, SIZE)
    recall = n_match / n_gt if n_gt else 0.0
    phase("adaptive", f"first call {first_s:.2f}s gt_objects={n_gt} "
          f"detections={n_det} matched={n_match} recall={recall:.4f} "
          f"proposals/image={out['proposals_valid'].sum(1).tolist()} "
          f"detections/image={valid.sum(1).tolist()} "
          f"chunks=({cls_chunk},{mask_chunk}) kernel launches={launches}")
    want = (BATCH, cfg.DETECTION_MAX_INSTANCES, 2 * m, 2 * m, 2 * m,
            cfg.NUM_CLASSES)
    if tuple(masks.shape) != want or not torch.isfinite(masks).all() \
            or not np.isfinite(det).all():
        raise AssertionError(f"bad outputs: masks {tuple(masks.shape)}")
    if float(masks.min()) < 0 or float(masks.max()) > 1:
        raise AssertionError("mask probabilities outside [0, 1]")
    if launches < 1 or len(captured) != launches:
        raise AssertionError(f"mask-stage kernel launches={launches}")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall {recall:.4f} < {RECALL_FLOOR}")

    # captured: the main path's own kernel inputs ----------------------
    args = captured[0]
    err_main = compare(args, "captured mask-stage inputs")

    # time -------------------------------------------------------------
    run()
    torch.cuda.synchronize()
    reps = 3
    wall = []
    for _ in range(reps):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
    step_ms = cuda_ms(run, reps)
    vols = BATCH / (step_ms / 1e3)
    kern = lambda: rc.roialign_compact(*args)  # noqa: E731
    levels, bat, total, pos, fms_main = args
    plain = lambda: rc.roialign_compact_plain(  # noqa: E731
        levels, bat, total, pos, fms_main)
    library = grid_sample_call(args)
    kern()
    plain()
    library()
    kernel_ms = cuda_ms(kern, 50)
    plain_ms = cuda_ms(plain, 5)
    library_ms = cuda_ms(library, 20)
    kernel_ms_2 = cuda_ms(kern, 50)
    bound = kernel_bound_ms(args)
    stages = stage_ms(model, image, meta_b, anchors, (cls_chunk, mask_chunk))
    phase("time", f"adaptive {vols:.4f} vol/s ({step_ms:.2f} ms per batch of "
          f"{BATCH}, CUDA events; host wall {[round(w, 4) for w in wall]} s); "
          f"kernel {kernel_ms:.4f} / {kernel_ms_2:.4f} ms, plain "
          f"{plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, bound "
          f"{bound:.4f} ms (N={pos.shape[0]} total={int(total)}); "
          f"stages ms {stages}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{smi}] peak memory {peak:.2f} GiB", flush=True)

    summary = {"kernels": [{
        "name": "roialign_compact",
        "route": "cuda",
        "source": "m3d_torch/csrc/roialign_compact.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max([err_main] + list(errs.values())),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }]}
    print(json.dumps(summary), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
