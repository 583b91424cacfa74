"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives m3d_torch's Mask R-CNN inference at the bench configuration (128^3
volumes, batch 4, ResNet-50, bf16) on the tracked checkpoint
weights/bench_ckpt.f16.msgpack and four seeded synthetic volumes, along two
paths: the adaptive graph (the compact ROIAlign kernel of both per-ROI
stages, m3d_torch/csrc/roialign_compact.cu) and the monolithic graph
(``MaskRCNN.forward``: the fused ROIAlign + FC kernel
m3d_torch/csrc/roialign_fc.cu, the slab kernel m3d_torch/csrc/roialign_slab.cu
for its fallback rows, and the compact kernel through its padded entry for
the mask stage). Phases, each printing flushed lines with the elapsed
seconds:

  env         card name and power limit, torch/CUDA versions, nvcc, g++,
              the host's CPU model and cores, which host modules import
              (h5py for the record: the port does not use it); arms a
              watchdog that dumps every thread's stack and exits non-zero
  build       the three kernel libraries, one nvcc each, and the native
              host library (g++), started together
  load        flax msgpack -> state dict; fails if a tensor is missing
  kernel      compact kernel vs its plain PyTorch version on random compact
              batches at the bench shapes, total in {0, 1, 37, N}; padded,
              slab and fused kernels vs theirs on random batches at the
              bench shapes, bounds (0, 0), (0, 1), (0, N) and an offset;
              the slab kernel also on dense random weights (its general
              path) and on a batch mixing both, and the span-tiered branch
              of pyramid_roi_align_pallas (three slab launches) against the
              padded kernel on the same boxes
  nms         nms_3d at the hela configs' 30000 candidates (the blockwise
              branch) on proposal-like boxes: the kept set must equal the
              numpy oracle's exactly
  adaptive    adaptive_inference on the bench volumes; recall against GT
              must be >= 0.7 and the compact kernel must have been launched
              twice (classifier and mask stages)
  captured    compact kernel vs plain version on the inputs of `adaptive`;
              the fused kernel vs its plain version on the adaptive
              classifier's first chunk (timing only: that path runs the
              compact kernel there)
  monolithic  MaskRCNN.forward on the same volumes: recall >= 0.7, finite
              outputs, masks in [0, 1], and the fused, slab and padded
              kernels each launched; detections matched against `adaptive`
  captured    padded, fused and slab kernels vs their plain versions on the
              inputs of `monolithic`, and on a forced-fallback classifier
              (fc_slab_cap (8, 8, 16): most rows take the slab kernel),
              whose split result must equal the default split's
  time        adaptive and monolithic vol/s and stage splits, and each
              kernel's / plain / library ms beside its bound, all timed
              with CUDA events; the adaptive classifier chunk's compact
              kernel + conv1 beside the fused kernel on the same rows
  serve       m3d_torch.serve on the tracked checkpoint at 128^3: an
              adaptive bundle (default chunks) and a monolithic one (chunks
              0) at B = 4, each exported with torch.export, loaded and run
              through ServingBundle.predict on the bench volumes: export,
              load and first-predict seconds, graph.pt2 bytes, the graph's
              ms beside in-process inference (CUDA events); outputs held to
              in-process adaptive_inference / MaskRCNN.forward
              (detections_valid equal, boxes within 1e-3, masks within one
              bf16 rounding), recall >= 0.7, #1 launched by the adaptive
              bundle, #2, #3 and #4 by the monolithic one; one call of
              each graph and of its in-process twin under torch.profiler
              (host syncs and scalar reads, ATen ops and host us per op,
              kernels launched, device busy and idle ms); then
              export_bucketed at B = 1 over 128^3 and 100x120x60 and four
              segment_volume requests, two per bucket: ms per request,
              instances found, each label volume held to the in-process
              postprocess of the padded volume, whose compact-kernel calls
              (the bucket shapes at B = 1) are held to the plain version
  eval        writes the bench volumes (seeds 1000-1003) as an on-disk
              dataset with the port's generator into a temporary directory,
              all four the test split, and runs
              ``python -m m3d_torch --task MRCNN_EVALUATION`` in-process on
              configs/milestone128/mrcnn_eval_synth128_resume.json with the
              tracked checkpoint: once as configured (the compact kernel),
              once with CLASSIFIER_CHUNK 0 and MASK_CHUNK 0 (the fused and
              padded kernels, the slab kernel for fallback rows). Each run
              must evaluate all four volumes, write their label TIFFs and
              CSVs and the summary, reach det_recall >= 0.7 and launch its
              kernels; prints both summaries and each image's seconds by
              stage (load, inference by CUDA events, unmold, metrics,
              artifacts)
  rpn_eval    RPN_EVALUATION on configs/milestone128/rpn_synth128.json and
              the same data: det@0.5_top500 >= 0.7
  native      after six more 128^3 volumes are written (seeds 2000-2005;
              four for training, two for testing): the native host
              library's IoU (rpn_synth128's anchors x every volume's GT,
              within 1e-6 of numpy, equal argmaxes), NMS (30000 proposal-
              like boxes, the numpy kept list), TIFF decode (every volume
              written, the numpy reader's arrays) and a 128^3 MRC round
              trip in modes 0, 1, 2, 6, 12; then the host ms of one
              training batch by part (TIFF decode native / numpy, bz2 GT
              masks, RPN targets with native / numpy IoU). Every later
              training phase runs on the library
  rpn_train   on those volumes, runs
              ``python -m m3d_torch --task RPN_TRAINING`` in-process on
              configs/milestone128/rpn_synth128_resume.json from the
              tracked checkpoint for one epoch (two steps of B = 2): finite
              losses, the epoch's det@0.5_top500 >= 0.7, every checkpoint
              file, sidecar and the telemetry snapshot, and latest.msgpack
              read back by the port giving the trained model's RPN outputs
              exactly; the step split (forward, backward, optimiser)
  autotune    RPN_TRAINING as rpn_train with AUTO_TUNE_RPN and
              AUTO_TUNE_APPLY: autotune_patch.json equal to autotune_rpn
              recomputed here, the trainer's anchors and RPN head the
              patched config's, finite losses; det@0.5_top500 printed
              without a floor (the checkpoint was trained for other anchors)
  e2e_train   HEAD_TRAINING (MODE training_head_e2e) on
              configs/milestone128/heads_e2e_synth128_resume.json from the
              tracked checkpoint, one epoch: finite losses, the padded
              kernel launched 2 per train step and 2 per validation step,
              each launch held against its plain version, every trunk leaf
              of latest.msgpack bit-equal to the checkpoint's and some head
              leaf changed
  train_eval  MRCNN_EVALUATION on the bench volumes with the e2e run's
              best.msgpack as HEAD_WEIGHTS: det_recall >= 0.7
  e2e_fit     fresh heads (JAX's initialiser distributions) on the tracked
              trunk and RPN, 20 e2e steps on one batch: the mean of the
              last five losses below the first; the e2e step split
  targeting   TARGET_GENERATION on configs/milestone128/targeting_synth128
              .json (TARGET_RATIO 1.0) over the six training volumes with
              the tracked checkpoint: every file of every kept image and
              both manifests; the padded kernel launched 2 per targeted
              image (p = 7 and 14, 64 rows), each launch held against its
              plain version; seconds per image by stage (forward, targets,
              ROIAlign, write) and the bytes written
  head_train  head-only HEAD_TRAINING (MODE "training") on those
              artifacts, SGD 0.0005 / momentum 0.9, HEAD_WEIGHTS the
              tracked checkpoint, one epoch: finite losses, the BatchNorm
              parameters and running statistics bit-equal (as JAX leaves
              them); then MRCNN_EVALUATION of its best.msgpack
              (head_eval): det_recall >= 0.7
  mrcnn_train writes ten more volumes (seeds 2006-2015, all in the train
              split: 8 / 2 after the trainer's 80/20 split) and runs
              MRCNN_TRAINING on the e2e config's model, LEARNING_LAYERS
              "all", SGD 0.001 / momentum 0.9, from the tracked checkpoint,
              one epoch: finite losses, trunk, FPN, RPN and head leaves
              moved, the padded kernel launched 0 times in the train steps
              (their ROIAligns take the gather, with gradients) and 2 per
              validation step, each launch held against its plain version;
              the step split and the gather's forward and backward ms; then
              MRCNN_EVALUATION of its best.msgpack (mrcnn_eval):
              det_recall >= 0.7
  parallel    after mrcnn_eval (it reuses mrcnn_train's data, config and
              checkpoint): MRCNN_TRAINING as mrcnn_train ran it, through
              ``python -m torch.distributed.run --standalone
              --nproc_per_node 1 -m m3d_torch`` (one NCCL rank on the
              distributed path), its latest.msgpack within PAR_EPOCH_TOL
              of mrcnn_train's update (beside that run repeated in
              process, the plain path's own spread); then PAR_RANKS gloo
              ranks sharing cuda:0 (m3d_torch.parallel.mesh.spawn; NCCL
              refuses two ranks on one device), each held to one process
              on the card: two MRCNN steps at a global batch of 2 (the
              first's loss, the parameters within PAR_STEP_TOL of one
              process's update), spatial_extract_features of
              the 4 bench volumes with Y over 2 ranks (the pyramid within
              one bf16 rounding; layout and halo bytes), make_spatial_
              inference (recall >= 0.7, detections matched to the
              monolithic graph's), dryrun_step on a (1, 2) mesh (loss);
              every kernel call in the ranks held to its plain version;
              then a data_parallel=2 monolithic bundle on cuda:0 twice
              (one card: the slices in turn), each slice held to
              MaskRCNN.forward on it and that twin's #2, #3, #4 calls to
              their plain versions. Prints the step
              ms of 1 and 2 ranks, the trunk ms, peak memory per rank and
              the phase's seconds
  train_bn    TRAIN_BN on RPN_TRAINING (one epoch) and MRCNN_TRAINING (one
              step): finite losses, every running statistic the run's
              BatchNorms see moved in latest.msgpack; det@0.5_top500
              printed without a floor
  h5          the reference's Keras weight files (tests/fixtures): both
              read by the port's own HDF5 reader, every manifest weight
              with its sum; the fixtures' tiny model restored from
              keras231_tiny.h5 on the card (all 92 weights, none skipped)
              through adaptive_inference on seeded 64x64x8 volumes, every
              compact-kernel launch held against its plain version, and
              through MaskRCNN.forward: at C = 32 every classifier row
              takes #4 (no #2), each #4 and #3 launch held against its
              plain version; then MRCNN_EVALUATION (chunks 0: #4, not #2)
              and RPN_EVALUATION through the CLI with keras231_tiny.h5 as
              weights on two volumes written here: every image evaluated,
              every artifact written
Each training phase prints its step ms (CUDA events), the host ms to take
each batch, the device's idle share, the peak memory and its wall time.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Writes nothing into the tree but m3d_torch/_build/; the evaluation dataset
and its artifacts live in a temporary directory that is removed at the end.

    python3 chip_smoke.py --dp-cards N

needs N cards and runs only this: a data_parallel=N monolithic bundle of
the bench configuration over cuda:0 .. cuda:N-1 (one slice a card, each
through its own copy of the graph), every slice held to MaskRCNN.forward
on it (held_to); prints the predict ms (host wall, every card
synchronised) against the same graphs called from a host thread each, one
slice's graph alone, and the data_parallel=1 bundle on cuda:0, then the
same last line.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.dont_write_bytecode = True  # leave no __pycache__ in the checkout

WATCHDOG_S = 1100          # below the 1200 s limit the smoke runs under
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM, bf16 tensor cores, dense
BATCH, SIZE = 4, 128
RECALL_FLOOR = 0.7
# TRAIN_BN witness: each trunk BatchNorm's running-statistic update against
# float64 statistics of its bf16 input, relative to the update's own scale
# ((1 - m) E[x^2] for the variance, (1 - m) sqrt(E[x^2]) for the mean).
# float32 sums give ~1e-6; an unbiased variance would add var / E[x^2] /
# (N - 1), up to 8e-3 at res5's N = 2 * 4^3 values.
BN_UPDATE_TOL = 1e-3
KERNEL_TOL = 1e-2          # x max|ref|: one bf16 rounding of the output
FORCED_CAP = (8, 8, 16)    # fc_slab_cap that sends most rows to the slab kernel
NMS_N, NMS_THR, NMS_K = 30000, 0.7, 3000  # hela: PRE_NMS_LIMIT, RPN NMS, POST_NMS
CHUNK_FC = "roialign_fc (adaptive chunk)"  # timing only: not on a main path
PALLAS = "m3d/ops/pallas_roialign.py"
# TPU kernel bodies the port's kernels replace (file:line).
REPLACES = {"roialign_compact": f"{PALLAS}:1022",     # _kernel_vmem_compact
            "roialign_fc (kron)": f"{PALLAS}:497",    # _kernel_slab_fc_kron
            "roialign_padded": f"{PALLAS}:177",       # _kernel_vmem
            "roialign_slab": f"{PALLAS}:42",          # _kernel
            "roialign_fc (separable)": f"{PALLAS}:273",  # _kernel_slab_fc
            CHUNK_FC: f"{PALLAS}:497"}

EVAL_CONFIG = "configs/milestone128/mrcnn_eval_synth128_resume.json"
RPN_CONFIG = "configs/milestone128/rpn_synth128.json"
CHECKPOINT = "weights/bench_ckpt.f16.msgpack"
EVAL_IMAGES, EVAL_SEED = 4, 1000  # the bench volumes: make_volumes(4, 128)
EVAL_STAGES = ("load", "inference", "unmold", "metrics", "artifacts")
RPN_TRAIN_CONFIG = "configs/milestone128/rpn_synth128_resume.json"
E2E_CONFIG = "configs/milestone128/heads_e2e_synth128_resume.json"
TARGET_CONFIG = "configs/milestone128/targeting_synth128.json"
# configs/heads/scp_heads_config.json's and configs/mrcnn/
# scp_mrcnn_training.json's optimisers.
HEAD_OPTIMIZER = {"name": "SGD", "parameters": {"learning_rate": 0.0005,
                                                "momentum": 0.9}}
MRCNN_OPTIMIZER = {"name": "SGD", "parameters": {"learning_rate": 0.001,
                                                 "momentum": 0.9}}
# MRCNN_TRAINING volumes, all in the train split (seeds 2006-2015).
MRCNN_IMAGES, MRCNN_SEED = 10, 2006
# Training volumes: four for two training batches of 2, two for one test
# batch (seeds 2000-2005, none of them a bench volume).
TRAIN_IMAGES, TRAIN_SEED, TRAIN_TEST_RATIO = 6, 2000, 0.34
FIT_STEPS = 20
CKPT_FILES = ("latest.msgpack", "best.msgpack", "latest_head.msgpack",
              "best_head.msgpack")
EVAL_METRIC_TOL = 1e-3     # |adaptive - monolithic| pixel metrics and dice
IOU_TOL = 1e-6             # native IoU vs overlaps_3d_numpy (float32)
MRC_MODES = {0: np.int8, 1: np.int16, 2: np.float32, 6: np.uint16,
             12: np.float16}
# The reference's Keras weight files committed as test fixtures (layer
# weights in each), and the fixtures' model: tests/test_h5_interop.py:29-41.
H5_FIXTURES = {"keras231_tiny": 92, "keras231_tiny_head": 50}
H5_TINY = dict(IMAGE_SIZE=64, IMAGE_DEPTH=8, NUM_CLASSES=2,
               BACKBONE_STRIDES=[[4, 4, 1], [8, 8, 1], [16, 16, 1],
                                 [32, 32, 1], [64, 64, 1]],
               RPN_ANCHOR_SCALES=[8, 12, 16, 24, 32],
               RPN_ANCHOR_RATIOS=[0.5, 1.0], FPN_CLASSIF_FC_LAYERS_SIZE=64,
               HEAD_CONV_CHANNEL=32, TOP_DOWN_PYRAMID_SIZE=32, POOL_SIZE=7,
               MASK_POOL_SIZE=14, CLASS_NAMES=["object"], MIN_ROI_SIZE=8,
               PRE_NMS_LIMIT=512, POST_NMS_ROIS_INFERENCE=64,
               DETECTION_MAX_INSTANCES=8, DETECTION_MIN_CONFIDENCE=0.0)
H5_IMAGES, H5_SEED = 2, 3000  # 64 x 64 x 8 volumes of the h5 phase
# The h5 phase's adaptive run (#1 on the mask stage). Its monolithic runs
# take no chunks: at C = 32 the classifier's rows all take #4 and conv3d_fc,
# as #2 needs C % 64 == 0.
H5_CHUNKS = dict(CLASSIFIER_CHUNK=64, MASK_CHUNK=8)
# serve: the router's raw volume shapes (buckets 128^3 and 128x128x64), two
# requests each; the bundles held to in-process inference (detections_valid
# equal, boxes within SERVE_BOX_TOL, masks within KERNEL_TOL * max: one bf16
# rounding) and the router's label volumes to the in-process postprocess
# (at most SERVE_LABEL_TOL of the voxels differ, the same instance count).
SERVE_SHAPES = ((SIZE, SIZE, SIZE), (100, 120, 60))
SERVE_BOX_TOL = 1e-3
SERVE_LABEL_TOL = 1e-3
# parallel: PAR_RANKS gloo ranks sharing cuda:0, each computation held to
# the same one in one process on the card, in bf16. The MRCNN step (global
# batch 2): loss within PAR_LOSS_TOL relative, the parameters within
# PAR_STEP_TOL of one process's update (``update_gap``: a 2x loss scale
# gives 1, a rank's gradient missing ~0.7; cuDNN's nondeterministic
# backward alone gave 0.0029 when one process ran the step twice, the
# ranks 0.0035, measured on an NVIDIA H100 80GB HBM3 at 700 W). The NCCL
# world-size-1 MRCNN_TRAINING epoch within PAR_EPOCH_TOL of the
# mrcnn_train phase's update: over an epoch the ROI samples that noise
# flips spread one process's own rerun by 0.24-0.30 (the same card; the
# NCCL run 0.25-0.32). The Y-sharded pyramid within KERNEL_TOL x max|level|
# (one bf16 rounding); spatial inference's detections: at least PAR_MATCH
# of them matched (IoU >= 0.5) to the monolithic graph's, recall >=
# RECALL_FLOOR; the dryrun step's loss within PAR_LOSS_TOL; the
# data_parallel=2 bundle held to in-process MaskRCNN.forward on each half
# of the batch as the serve phase holds its bundles (held_to), the twin's
# kernel calls to their plain versions.
PAR_RANKS = 2
PAR_LOSS_TOL = 1e-2
PAR_STEP_TOL = 2e-2
PAR_EPOCH_TOL = 0.6
PAR_MATCH = 0.9

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


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for s, e in sorted(spans):
        if reach is None or s > reach:
            total, reach = total + e - s, e
        elif e > reach:
            total, reach = total + e - reach, e
    return total


def host_profile(fn) -> dict:
    """One call of ``fn`` (warmed up) under ``torch.profiler`` with CPU and
    CUDA activity, read within the call's span: the host's stream
    synchronisations and reads of a device value
    (``aten::_local_scalar_dense``), the ATen ops it dispatched at top
    level, the host ms spent outside waits per op, the ms before the first
    op (argument handling), the kernels launched, and the device's busy and
    idle ms. Device numbers are None where the profiler saw no device
    activity. The profiler's own cost is inside every host number."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("host_profile_call"):
            fn()
            torch.cuda.synchronize()
    kinds = torch.autograd.DeviceType
    events = list(prof.events())
    call = next(e for e in events if e.name == "host_profile_call"
                and e.device_type == kinds.CPU)
    lo, hi = call.time_range.start, call.time_range.end
    cpu = [e for e in events if e.device_type == kinds.CPU
           and lo <= e.time_range.start <= hi]
    # Kernels, copies and sets; not the annotation's device-side span.
    dev = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
           for e in events
           if e.device_type == kinds.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name != "host_profile_call"
           and e.time_range.end > lo and e.time_range.start < hi]

    def top_level(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return False
            p = p.cpu_parent
        return True

    ops = [e for e in cpu if e.name.startswith("aten::") and top_level(e)]
    syncs = sorted((e for e in cpu if e.name in SYNC_CALLS),
                   key=lambda e: e.time_range.start)
    # The closing synchronize, which waits for the call's device work, is
    # not one of the call's; its wait is.
    closing = 1 if syncs and syncs[-1].name == "cudaDeviceSynchronize" \
        else 0
    wait_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in syncs])
    wall_us = hi - lo
    busy_us = _union_us(dev) if dev else None
    return {
        "wall_ms": wall_us / 1e3,
        "syncs": len(syncs) - closing,
        "scalar_reads": sum(e.name == "aten::_local_scalar_dense"
                            for e in cpu),
        "aten_ops": len(ops),
        "host_us_per_op": (wall_us - wait_us) / max(len(ops), 1),
        "lead_in_ms": ((min(e.time_range.start for e in ops) - lo) / 1e3
                       if ops else None),
        "kernel_launches": sum(e.name in LAUNCH_CALLS for e in cpu),
        "device_busy_ms": None if busy_us is None else busy_us / 1e3,
        "device_idle_ms": (None if busy_us is None
                           else (wall_us - busy_us) / 1e3),
    }


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """Least time on this card (ms) for the bytes (each input read once,
    each output written once) and the operations. Memory, the float32
    units and the tensor cores work at once, so the least time is the
    largest of the three. Returns (ms, "bytes" or "operations", the unit
    that sets it)."""
    times = {"HBM": nbytes / HBM_BYTES_PER_S,
             "float32 units": f32_ops / FP32_FLOPS,
             "bf16 tensor cores": bf16_ops / BF16_FLOPS}
    unit = max(times, key=times.get)
    return times[unit] * 1e3, ("bytes" if unit == "HBM" else "operations"), \
        unit


def reset_counts() -> None:
    from m3d_torch.ops import roialign_compact as rc
    from m3d_torch.ops import roialign_fc as rf
    from m3d_torch.ops import roialign_slab as rs

    for k in (rc.KERNEL, rc.PADDED, rf.KERNEL, rs.KERNEL):
        k.launches = 0


def check_close(got, ref, label: str, lo: int = 0, hi=None) -> float:
    """max |got - ref| <= KERNEL_TOL * max|ref|, rows outside [lo, hi)
    exactly zero, everything finite. Returns the max abs error."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    hi = got.shape[0] if hi is None else hi
    err = (got - ref).abs().max().item() if got.numel() else 0.0
    scale = ref.abs().max().item() if ref.numel() else 0.0
    if err > KERNEL_TOL * scale:
        raise AssertionError(f"{label}: max abs err {err} > "
                             f"{KERNEL_TOL} * max|ref| {scale}")
    if (got[:lo] != 0).any() or (got[hi:] != 0).any():
        raise AssertionError(f"{label}: rows outside [{lo}, {hi}) not zero")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    phase("kernel", f"{label}: N={got.shape[0]} rows [{lo}, {hi}) "
          f"max_abs_err={err:.3e} max|ref|={scale:.3e}")
    return err


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


def kernel_bound_ms(args):
    """Least time of the compact kernel's function on this card: the
    output written once, each voxel the live rows touch read once, the row
    metadata read once; ~16 float32 flops per live output element. Returns
    bound()'s triple."""
    levels, bat, total, pos, fms = args
    n, _, p = pos.shape
    c, item = fms[0].shape[-1], fms[0].element_size()
    out_bytes = n * p ** 3 * c * item
    in_bytes = touched_voxels(*args) * c * item + pos.numel() * 4 + 8 * n + 4
    return bound(out_bytes + in_bytes, f32_ops=16 * int(total) * p ** 3 * c)


def grid_sample_call(args):
    """One F.grid_sample over the same pooled rows, as a yardstick only:
    levels zero-padded to one extent, rows of each (image, level) pair
    stacked along the output's first axis. Returns a closure to time."""
    return grid_sample_rows(args)[0]


def grid_sample_rows(args):
    """grid_sample_call's closure, its row count per group, and where each
    row (in row order) lies in the output's flattened (group, row) axis."""
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
    flat_idx = torch.zeros(t, dtype=torch.long, device=pos.device)
    for g, rows in enumerate(rows_of):
        flat_idx[rows] = g * r_max + torch.arange(len(rows),
                                                  device=pos.device)
    return (lambda: F.grid_sample(inp, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
            r_max, flat_idx)


def weight_positions(origins, wy, wx, wz):
    """[N, 3, p] sample positions that slab weights interpolate at
    (origin + sum_s s * w_s over a row of two linear taps); -1 where a row
    of weights is zero (a sample outside the level)."""
    out = []
    for a, w in enumerate((wy, wx, wz)):
        cols = torch.arange(w.shape[2], device=w.device, dtype=torch.float32)
        tot = w.sum(-1)
        pos = origins[:, a, None].float() + (w * cols).sum(-1) / \
            tot.clamp_min(1e-30)
        out.append(torch.where(tot > 0, pos, torch.full_like(pos, -1.0)))
    return torch.stack(out, 1).contiguous()


def slab_rows_in_bounds(args):
    """(levels, batch, count, positions, features) of the rows inside a
    slab-contract call's bounds, in grid_sample_call's argument form."""
    levels, bat, origins, wy, wx, wz, fms = args[:7]
    off, cnt = args[-1].tolist()
    sl = slice(off, off + cnt)
    return (levels[sl], bat[sl], torch.tensor(cnt),
            weight_positions(origins[sl], wy[sl], wx[sl], wz[sl]), fms)


def fc_library_call(args):
    """F.grid_sample over the rows in bounds, then torch.matmul with the
    FC weight, as a yardstick only. Returns a closure to time."""
    wk = args[7]
    gs_args = slab_rows_in_bounds(args)
    p = gs_args[3].shape[2]
    sample, r_max, flat_idx = grid_sample_rows(gs_args)

    def run():
        out = sample()                                 # [G, C, R*p, p, p]
        g, c = out.shape[:2]
        rows = out.reshape(g, c, r_max, p, p, p).permute(
            0, 2, 3, 4, 5, 1).reshape(g * r_max, -1)
        return rows.index_select(0, flat_idx) @ wk.t()
    return run


def slab_touched(args):
    """Distinct feature voxels the rows inside a slab-contract call's bounds
    read with a nonzero weight, and the taps (nonzero weight products) they
    sum."""
    levels, bat, origins, wy, wx, wz, fms = args[:7]
    off, cnt = args[-1].tolist()
    rows = torch.arange(off, off + cnt, device=wy.device)
    voxels, taps = 0, 0.0
    for lv in range(4):
        r_all = rows[levels[rows] == lv]
        if r_all.numel() == 0:
            continue
        b, h, w, d = fms[lv].shape[:4]
        occ = torch.zeros(b, h + 1, w + 1, d + 1, dtype=torch.bool,
                          device=wy.device)
        for r in r_all.split(256):
            idx, nnz = [], []
            for a, (wt, size) in enumerate(zip((wy, wx, wz), (h, w, d))):
                ww = wt[r]                                      # [r, p, S]
                co = origins[r, a].long()[:, None] + torch.arange(
                    ww.shape[2], device=wy.device)
                nz = (ww != 0) & ((co >= 0) & (co < size))[:, None, :]
                idx.append(torch.where(nz.any(1), co,
                                       torch.full_like(co, size)))
                nnz.append(nz.sum((1, 2)).double())
            taps += float((nnz[0] * nnz[1] * nnz[2]).sum())
            occ[bat[r].long()[:, None, None, None], idx[0][:, :, None, None],
                idx[1][:, None, :, None], idx[2][:, None, None, :]] = True
        voxels += int(occ[:, :h, :w, :d].sum())
    return voxels, taps


def slab_bound(args, fc: bool = False):
    """Least time of the slab kernel's (or, with ``fc``, the fused
    kernel's) function on these inputs: every output row written once, the
    voxels and the weights of the rows in bounds read once, 2 float32 flops
    a tap and channel; the fused kernel adds its weight, read once, and
    2 * rows * K * F bf16 tensor-core flops. Returns bound()'s triple."""
    wy, wx, wz, fms = args[3], args[4], args[5], args[6]
    n, p = wy.shape[:2]
    cnt = int(args[-1][1])
    c, item = fms[0].shape[-1], fms[0].element_size()
    voxels, taps = slab_touched(args)
    in_bytes = (voxels * c * item + 20 * cnt
                + cnt * p * (wy.shape[2] + wx.shape[2] + wz.shape[2]) * 4 + 8)
    if not fc:
        return bound(n * p ** 3 * c * item + in_bytes, f32_ops=2 * taps * c)
    wk = args[7]
    f, k = wk.shape
    return bound(n * f * 4 + k * f * wk.element_size() + in_bytes,
                 f32_ops=2 * taps * c, bf16_ops=2.0 * cnt * k * f)


def compare_padded(args, label: str) -> float:
    from m3d_torch.ops import roialign_compact as rc

    levels, pos, fms, n_per = args
    n = pos.shape[0]
    got = rc.roialign_padded(*args)
    bat = torch.div(torch.arange(n, device=pos.device, dtype=torch.int32),
                    n_per, rounding_mode="floor")
    total = torch.tensor(n, dtype=torch.int32, device=pos.device)
    ref = rc.roialign_compact_plain(levels, bat, total, pos,
                                    [f.float() for f in fms])
    return check_close(got, ref, label)


def compare_slab(args, label: str) -> float:
    from m3d_torch.ops import roialign_slab as rs

    got = rs.roialign_slab(*args)
    ref = rs.roialign_slab_plain(*args[:6], [f.float() for f in args[6]],
                                 args[7])
    off, cnt = args[7].tolist()
    return check_close(got, ref, label, off, off + cnt)


def dense_random(w, gen, rows=None):
    """w with ``rows`` (default all) replaced by random weights, ~30 % of
    each row's columns nonzero: far more than two taps a sample, which is
    the slab kernel's general path."""
    r = torch.randn(w.shape, generator=gen, device=w.device) * (
        torch.rand(w.shape, generator=gen, device=w.device) < 0.3)
    if rows is None:
        return r.contiguous()
    out = w.clone()
    out[rows] = r[rows]
    return out


def tiered_check(fms, meta_b, p: int, gen) -> float:
    """The span-tiered branch of pyramid_roi_align_pallas (slab
    (32, 32, 32): tiers (8, 8, 16), (16, 16, 24) and the full slab, one slab
    kernel launch each) against the padded kernel on the same random boxes;
    the two compute the same function. Every tier must get rows."""
    from m3d_torch.ops import roialign3d
    from m3d_torch.ops import roialign_slab as rs

    dev = fms[0].device
    n = 500  # boxes per image, the bench config's POST_NMS_ROIS_INFERENCE
    lo = torch.rand(BATCH, n, 3, generator=gen, device=dev) * 0.5
    ext = 0.03 + torch.rand(BATCH, n, 3, generator=gen, device=dev) * 0.6
    boxes = torch.cat([lo, (lo + ext).clamp(max=1.0)], -1)
    spy = Spy()
    before = rs.KERNEL.launches
    tiered = roialign3d.pyramid_roi_align_pallas(boxes, meta_b, fms, p,
                                                 slab=(32, 32, 32))
    launched = rs.KERNEL.launches - before
    spy.restore()
    counts = [int(a[-1][1]) for a in spy.calls["roialign_slab"]]
    if launched != 3 or len(counts) != 3 or min(counts) < 1:
        raise AssertionError(f"tiered branch: {launched} slab launches, "
                             f"rows per tier {counts}")
    padded = roialign3d.pyramid_roi_align_pallas(boxes, meta_b, fms, p)
    return check_close(tiered.flatten(0, 1), padded.flatten(0, 1),
                       f"tiered slab branch (rows per tier {counts}) vs "
                       f"padded kernel")


def compare_fc(args, label: str) -> float:
    """The fused kernel against its plain version in the working type: both
    round the pooled rows to bf16 and multiply by the bf16 weight."""
    from m3d_torch.ops import roialign_fc as rf

    got = rf.roialign_fc(*args)
    ref = rf.roialign_fc_plain(*args)
    off, cnt = args[8].tolist()
    return check_close(got, ref, label, off, off + cnt)


def random_slab_batch(fms, n: int, p: int, gen, cap, bounds):
    """Slab-contract rows at the bench shapes (levels cycling over all
    four, boxes inside the unit cube), weights for the slab
    min(cap, exact-coverage slab) as the fused classifier places them."""
    from m3d_torch.ops import roialign3d

    dev = fms[0].device
    bsz = fms[0].shape[0]
    lo = torch.rand(n, 3, generator=gen, device=dev) * 0.6
    ext = 0.05 + torch.rand(n, 3, generator=gen, device=dev) * 0.35
    boxes = torch.cat([lo, (lo + ext).clamp(max=1.0)], dim=1)
    levels = (torch.arange(n, device=dev) % 4).to(torch.int32)
    bat = torch.sort(torch.randint(0, bsz, (n,), generator=gen,
                                   device=dev)).values.to(torch.int32)
    rd, pos = roialign3d._level_positions(boxes, levels, fms, p)
    slab, pdims = roialign3d._slab_geometry(fms)
    tier = tuple(min(a, b) for a, b in zip(cap, slab))
    weights = roialign3d._slab_weights(pos, rd, pdims[levels.long()], tier)
    return [levels, bat, *weights, fms,
            torch.tensor(bounds, dtype=torch.int32, device=dev)]


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


def monolithic_stage_ms(model, image, meta_b, anchors) -> dict:
    """CUDA-event ms of each stage of one monolithic step, chained as
    MaskRCNN.forward chains them."""
    from m3d_torch.models.detection import refine_detections_batch

    names = ("trunk", "rpn_head", "proposals", "classifier", "detection",
             "mask")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    torch.cuda.synchronize()
    with torch.no_grad():
        ev[0].record()
        feats = model.extract_features(image.float())
        ev[1].record()
        _, probs, deltas = model.rpn_forward(list(feats))
        ev[2].record()
        props, _ = model.propose(probs, deltas, anchors)
        ev[3].record()
        _, cls_probs, cls_bbox = model.classify_rois(props, meta_b,
                                                     list(feats[:4]))
        ev[4].record()
        det, _ = refine_detections_batch(
            props, cls_probs, cls_bbox, meta_b, model.bbox_std_dev,
            model.detection_min_confidence, model.detection_nms_threshold,
            model.detection_max_instances,
            nms_xy_only=model.detection_nms_xy_only)
        ev[5].record()
        model.mask_rois(det[..., :6], meta_b, list(feats[:4]))
        ev[6].record()
    torch.cuda.synchronize()
    return {n: round(ev[i].elapsed_time(ev[i + 1]), 3)
            for i, n in enumerate(names)}


class Spy:
    """Replaces kernel entry points in m3d_torch.ops.roialign3d by wrappers
    that record their arguments, until ``restore``."""

    NAMES = ("roialign_fc", "roialign_slab", "roialign_padded",
             "roialign_compact")

    def __init__(self):
        from m3d_torch.ops import roialign3d

        self.mod = roialign3d
        self.real = {n: getattr(roialign3d, n) for n in self.NAMES}
        self.calls = {n: [] for n in self.NAMES}
        for n in self.NAMES:
            setattr(roialign3d, n, self._wrap(n))

    def _wrap(self, name):
        def spy(*args):
            self.calls[name].append(args)
            return self.real[name](*args)
        return spy

    def restore(self) -> None:
        for n, fn in self.real.items():
            setattr(self.mod, n, fn)


def launch_counts() -> dict:
    from m3d_torch.ops import roialign_compact as rc
    from m3d_torch.ops import roialign_fc as rf
    from m3d_torch.ops import roialign_slab as rs

    return {"roialign_compact": rc.KERNEL.launches,
            "roialign_padded": rc.PADDED.launches,
            "roialign_fc (kron)": rf.KERNEL.launches,
            "roialign_slab": rs.KERNEL.launches}


def write_config(src: str, path: str, **keys) -> str:
    """The JSON config ``src`` with ``keys`` replaced, written to ``path``."""
    with open(src) as f:
        cfg = json.load(f)
    cfg.update(keys)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


# Per path kernel: (launch-count key, Spy name, check against the plain
# version).
EVAL_CHECKS = (("roialign_compact", "roialign_compact", compare),
               ("roialign_fc (kron)", "roialign_fc", compare_fc),
               ("roialign_padded", "roialign_padded", compare_padded),
               ("roialign_slab", "roialign_slab", compare_slab))


def eval_run(here: str, tmp: str, label: str, smi: str, errs: dict, **keys):
    """One MRCNN_EVALUATION through the port's CLI, in this process. Every
    kernel call of the run (B = 1) is held against its plain version and its
    error added to ``errs``. Returns (kernel launches, summary)."""
    from m3d_torch import __main__ as cli
    from m3d_torch.utils.tiffio import imread_volume

    out_dir = os.path.join(tmp, f"out_{label}")
    ckpt = os.path.join(here, CHECKPOINT)
    keys = dict(dict(DATA_DIR=os.path.join(tmp, "data"), OUTPUT_DIR=out_dir,
                     WEIGHT_DIR=os.path.join(out_dir, "weights"),
                     RPN_WEIGHTS=ckpt, HEAD_WEIGHTS=ckpt), **keys)
    path = write_config(os.path.join(here, EVAL_CONFIG),
                        os.path.join(tmp, f"{label}.json"), **keys)
    t = time.perf_counter()
    reset_counts()
    spy = Spy()
    try:
        res = cli.main(["--task", "MRCNN_EVALUATION", "--config_path", path])
        torch.cuda.synchronize()
    finally:
        spy.restore()
    launches = launch_counts()
    wall = time.perf_counter() - t
    summary, per_image, times = res["summary"], res["per_image"], res["times"]
    shown = {k: v for k, v in keys.items() if k not in
             ("DATA_DIR", "OUTPUT_DIR", "WEIGHT_DIR", "RPN_WEIGHTS")}
    phase("eval", f"{label} {shown}: {wall:.2f}s, "
          f"{len(per_image)} of {EVAL_IMAGES} images, kernel launches "
          f"{launches}")
    print(f"[{smi}] eval {label} summary: {json.dumps(summary)}", flush=True)
    for i, (r, tm) in enumerate(zip(per_image, times)):
        split = {k: round(tm.get(k, 0.0), 4) for k in EVAL_STAGES}
        phase("eval", f"{label} image {i}: {r['n_detections']} detections, "
              f"{r['n_gt']} GT, seconds {split}")
    mean = {k: float(np.mean([tm.get(k, 0.0) for tm in times]))
            for k in EVAL_STAGES}
    phase("eval", f"{label} mean seconds per image {mean} "
          f"(inference by CUDA events)")
    if len(per_image) != EVAL_IMAGES:
        raise AssertionError(f"eval {label}: {len(per_image)} of "
                             f"{EVAL_IMAGES} images evaluated")
    names = [str(i).zfill(6) for i in range(EVAL_IMAGES)]
    want = [f"{n}.{ext}" for n in names for ext in ("tiff", "csv")]
    want.append("evaluation_summary.json")
    try:
        import matplotlib  # noqa: F401
        want += [f"overlays/{n}_masks_overlay.png" for n in names]
    except ImportError:
        pass
    absent = [w for w in want if not os.path.exists(os.path.join(out_dir, w))]
    if absent:
        raise AssertionError(f"eval {label}: artifacts missing: {absent}")
    label_vol = imread_volume(os.path.join(out_dir, f"{names[0]}.tiff"))
    if label_vol.shape != (SIZE,) * 3 or label_vol.dtype != np.uint16:
        raise AssertionError(f"eval {label}: label TIFF reads back as "
                             f"{label_vol.shape} {label_vol.dtype}")
    if summary["det_recall"] < RECALL_FLOOR:
        raise AssertionError(f"eval {label}: det_recall "
                             f"{summary['det_recall']:.4f} < {RECALL_FLOOR}")
    # The path's own kernel inputs: a wrapper launches once for each call
    # with rows (none for zero rows), and every such call is checked.
    for key, name, check in EVAL_CHECKS:
        calls = [a for a in spy.calls[name] if a[0].shape[0]]
        if len(calls) != launches[key]:
            raise AssertionError(f"eval {label}: {len(calls)} {name} calls "
                                 f"with rows, {launches[key]} launches")
        for i, args in enumerate(calls):
            errs[key].append(check(args, f"eval {label} captured {name} "
                                         f"inputs, call {i}"))
    return launches, summary


def rpn_eval_run(here: str, tmp: str, smi: str):
    """RPN_EVALUATION through the port's CLI, in this process. Returns the
    kernel launches of the run."""
    from m3d_torch import __main__ as cli

    path = write_config(
        os.path.join(here, RPN_CONFIG), os.path.join(tmp, "rpn.json"),
        DATA_DIR=os.path.join(tmp, "data"),
        OUTPUT_DIR=os.path.join(tmp, "out_rpn"),
        WEIGHT_DIR=os.path.join(tmp, "out_rpn", "weights"),
        RPN_WEIGHTS=os.path.join(here, CHECKPOINT))
    t = time.perf_counter()
    reset_counts()
    metrics = cli.main(["--task", "RPN_EVALUATION", "--config_path", path])
    torch.cuda.synchronize()
    launches = launch_counts()
    phase("rpn_eval", f"{time.perf_counter() - t:.2f}s kernel launches "
          f"{launches}")
    print(f"[{smi}] rpn_eval metrics: {json.dumps(metrics)}", flush=True)
    if metrics["det@0.5_top500"] < RECALL_FLOOR:
        raise AssertionError(f"rpn_eval det@0.5_top500 "
                             f"{metrics['det@0.5_top500']:.4f} < "
                             f"{RECALL_FLOOR}")
    return launches


def train_timing(name: str, trainer, smi: str) -> dict:
    """Print and return a training run's step split: each step's ms (CUDA
    events) and host ms to take its batch, the median after the first
    step, and the peak memory since the phase began. Fails on a
    non-finite loss."""
    recs = trainer.clock.records
    losses = [r["loss"] for r in recs]
    if not recs or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    later = recs[1:] or recs
    out = {"steps": len(recs),
           "step_ms": [round(r["step_ms"], 3) for r in recs],
           "host_ms": [round(r["host_ms"], 3) for r in recs],
           "step_ms_median_after_first": float(np.median(
               [r["step_ms"] for r in later])),
           "host_ms_median_after_first": float(np.median(
               [r["host_ms"] for r in later])),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": losses}
    # With batch assembly on the caller's thread, the card idles while the
    # host takes each batch.
    busy = out["step_ms_median_after_first"]
    out["device_idle_share"] = 1.0 - busy / (busy + out[
        "host_ms_median_after_first"])
    print(f"[{smi}] {name} timing: {json.dumps(out)}", flush=True)
    return out


def check_ckpt_files(name: str, wdir: str) -> None:
    want = [f for c in CKPT_FILES for f in (c, c + ".json")]
    want.append("telemetry.jsonl")
    absent = [w for w in want if not os.path.exists(os.path.join(wdir, w))]
    if absent:
        raise AssertionError(f"{name}: files missing: {absent}")


def _split_ms(stages, reps: int = 3) -> dict:
    """Mean CUDA-event ms of each (name, fn) stage of one step, the stages
    run in order, over ``reps`` steps after one warm-up step; each fn takes
    the previous one's result."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    total = {n: 0.0 for n, _ in stages}
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        ev[0].record()
        x = None
        for i, (_, fn) in enumerate(stages):
            x = fn(x)
            ev[i + 1].record()
        torch.cuda.synchronize()
        if rep:
            for i, (n, _) in enumerate(stages):
                total[n] += ev[i].elapsed_time(ev[i + 1]) / reps
    return {n: round(v, 3) for n, v in total.items()}


def rpn_step_split(trainer, batch) -> dict:
    """The RPN train step's parts: forward with the losses, backward, the
    optimiser's update (a new optimiser over the trained model)."""
    from m3d_torch.models import losses as L
    from m3d_torch.train.optim import Optimizer

    model = trainer.model
    opt = Optimizer(trainer.config, dict(model.named_parameters()))

    def forward(_):
        for p in model.parameters():
            p.grad = None
        out = model.forward_rpn_train(batch["image"])
        return (L.rpn_class_loss(batch["rpn_match"],
                                 out["rpn_class_logits"])[0]
                + 1.5 * L.rpn_bbox_loss(batch["rpn_bbox"], batch["rpn_match"],
                                        out["rpn_bbox"])[0])

    return _split_ms([("forward + losses", forward),
                      ("backward", lambda loss: loss.backward()),
                      ("optimizer", lambda _: opt.step())])


def e2e_step_split(trainer, opt, batch) -> dict:
    """The e2e train step's parts, chained as HeadTrainer._e2e_outputs and
    make_e2e_step chain them."""
    from m3d_torch.models.detection_targets import detection_targets_batch
    from m3d_torch.ops.roialign3d import pyramid_roi_align_auto
    from m3d_torch.train.head import _is_frozen_for_e2e, head_losses
    from m3d_torch.train.optim import apply_constraints

    cfg, model = trainer.config, trainer.model
    params = dict(model.named_parameters())
    gen = torch.Generator(trainer.device).manual_seed(2)
    active = torch.ones((batch["image"].shape[0], int(cfg.NUM_CLASSES)),
                        device=trainer.device)
    st = {}

    def trunk(_):
        with torch.no_grad():
            st["rpn"] = model.forward_rpn(batch["image"], trainer._anchors_dev)

    def targets(_):
        with torch.no_grad():
            st["t"] = detection_targets_batch(
                st["rpn"]["proposals"], batch["gt_class_ids"],
                batch["gt_boxes"], batch["gt_masks"], cfg.BBOX_STD_DEV,
                int(cfg.TRAIN_ROIS_PER_IMAGE), float(cfg.ROI_POSITIVE_RATIO),
                float(cfg.RPN_POSITIVE_IOU), float(cfg.RPN_NEGATIVE_IOU),
                tuple(int(v) for v in cfg.MASK_SHAPE),
                use_mini_mask=bool(cfg.USE_MINI_MASK), generator=gen)

    def align(_):
        feats = list(st["rpn"]["feature_maps"][:4])
        meta = batch["image_meta"].float()
        with torch.no_grad():
            return [pyramid_roi_align_auto(st["t"]["rois"], meta, feats,
                                           int(q)) for q in
                    (cfg.POOL_SIZE, cfg.MASK_POOL_SIZE)]

    def heads(aligned):
        for p in params.values():
            p.grad = None
        out = model.forward_heads(*aligned)
        t = st["t"]
        return head_losses(cfg, out, {"target_class_ids": t["class_ids"],
                                      "target_bbox": t["deltas"],
                                      "target_mask": t["masks"]}, active)[0]

    return _split_ms([
        ("trunk + RPN + proposals", trunk), ("targets", targets),
        ("ROIAlign #3 x2", align), ("heads forward + losses", heads),
        ("heads backward", lambda loss: loss.backward()),
        ("optimizer + constraints", lambda _: (opt.step(), apply_constraints(
            params, frozen_predicate=_is_frozen_for_e2e)))])


def rpn_train_run(here: str, tmp: str, smi: str) -> dict:
    """RPN_TRAINING through the port's CLI, in this process: one epoch
    from the tracked checkpoint (EPOCHS = FROM_EPOCH + 1). Checks finite
    losses, det@0.5_top500 of the epoch's evaluation, the files, and that
    latest.msgpack read back by the port reproduces the trained model's
    RPN outputs exactly."""
    from m3d_torch import __main__ as cli
    from m3d_torch.checkpoints import (load_params, params_from_jax,
                                       restore_by_name)
    from m3d_torch.data.datasets import ToyDataset
    from m3d_torch.models.mask_rcnn import MaskRCNN

    with open(os.path.join(here, RPN_TRAIN_CONFIG)) as f:
        from_epoch = int(json.load(f)["FROM_EPOCH"])
    out = os.path.join(tmp, "out_rpn_train")
    wdir = os.path.join(out, "weights")
    path = write_config(
        os.path.join(here, RPN_TRAIN_CONFIG),
        os.path.join(tmp, "rpn_train.json"),
        DATA_DIR=os.path.join(tmp, "train_data"), OUTPUT_DIR=out,
        WEIGHT_DIR=wdir, RPN_WEIGHTS=os.path.join(here, CHECKPOINT),
        EPOCHS=from_epoch + 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    trainer = cli.main(["--task", "RPN_TRAINING", "--config_path", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    timing = train_timing("rpn_train", trainer, smi)
    (epoch,) = trainer.history
    phase("rpn_train", f"{wall:.2f}s, {timing['steps']} steps, kernel "
          f"launches {launch_counts()}; epoch {json.dumps(epoch)}")
    if epoch["det@0.5_top500"] < RECALL_FLOOR:
        raise AssertionError(f"rpn_train det@0.5_top500 "
                             f"{epoch['det@0.5_top500']:.4f} < {RECALL_FLOOR}")
    check_ckpt_files("rpn_train", wdir)
    # The saved file, read back by the port, is the trained model.
    dev = trainer.device
    fresh = MaskRCNN.from_config(trainer.config, mode="training",
                                 device=dev).eval()
    stats = restore_by_name(fresh, params_from_jax(
        load_params(os.path.join(wdir, "latest.msgpack"))[0]))
    if stats["missing"] or stats["skipped"]:
        raise AssertionError(f"rpn_train latest.msgpack: {stats}")
    ds = ToyDataset()
    ds.load_dataset(os.path.join(tmp, "train_data"), is_train=False,
                    class_names=tuple(trainer.config.CLASS_NAMES))
    ds.prepare()
    image = torch.as_tensor(ds.load_image(0)[None], device=dev)
    anchors = torch.as_tensor(trainer.anchors, device=dev)
    a = trainer.model.forward_rpn(image, anchors)
    b = fresh.forward_rpn(image, anchors)
    for k in ("rpn_class_logits", "rpn_bbox", "proposals"):
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"rpn_train: latest.msgpack gives other "
                                 f"{k} than the trained model")
    phase("rpn_train", "latest.msgpack read back reproduces the trained "
          "model's RPN logits, deltas and proposals exactly")
    from m3d_torch.data.generators import RPNGenerator, to_device

    ds = ToyDataset()
    ds.load_dataset(os.path.join(tmp, "train_data"), is_train=True,
                    class_names=tuple(trainer.config.CLASS_NAMES))
    ds.prepare()
    batch = to_device(next(iter(RPNGenerator(ds, trainer.config,
                                             mode="training"))), dev)
    split = rpn_step_split(trainer, batch)
    phase("rpn_train", f"step split ms (CUDA events, mean of 3): {split}")
    return dict(timing, wall_s=wall, epoch=epoch, split=split)


def padded_shapes(calls, name: str) -> dict:
    """#3 at the shapes of ``calls`` (captured roialign_padded arguments,
    one per pool size): kernel, plain and library ms (CUDA events) beside
    the bound, keyed "p7" / "p14"."""
    from m3d_torch.ops import roialign_compact as rc

    shapes = {}
    for args in calls:
        levels, pos, fms, n_per = args
        n, _, p = pos.shape
        compact = (levels, torch.div(
            torch.arange(n, device=pos.device, dtype=torch.int32), n_per,
            rounding_mode="floor"), torch.tensor(n, dtype=torch.int32,
                                                 device=pos.device), pos, fms)
        library = grid_sample_call(compact)
        library()
        bound_ms, bound_by, unit = kernel_bound_ms(compact)
        shapes[f"p{p}"] = {
            "rows": n, "ms": cuda_ms(lambda: rc.roialign_padded(*args), 50),
            "plain_ms": cuda_ms(lambda: rc.roialign_compact_plain(*compact),
                                2),
            "library_ms": cuda_ms(library, 10), "bound_ms": bound_ms,
            "bound_by": bound_by}
        phase(name, f"roialign_padded at p={p}, {n} rows: "
              f"{json.dumps(shapes[f'p{p}'])} ({unit})")
    return shapes


def e2e_train_run(here: str, tmp: str, smi: str, errs: dict):
    """e2e HEAD_TRAINING through the port's CLI, in this process: one
    epoch from the tracked checkpoint. Every #3 launch (2 per train step,
    2 per validation step) is held against its plain version; the trunk of
    latest.msgpack must equal the checkpoint's, some head leaf must
    differ. Returns (timing, best.msgpack path, the run's launch counts)."""
    from m3d_torch import __main__ as cli
    from m3d_torch.checkpoints import load_params, params_from_jax

    out = os.path.join(tmp, "out_e2e")
    wdir = os.path.join(out, "weights")
    ckpt = os.path.join(here, CHECKPOINT)
    path = write_config(
        os.path.join(here, E2E_CONFIG), os.path.join(tmp, "e2e.json"),
        DATA_DIR=os.path.join(tmp, "train_data"), OUTPUT_DIR=out,
        WEIGHT_DIR=wdir, RPN_WEIGHTS=ckpt, HEAD_WEIGHTS=ckpt, EPOCHS=1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spy = Spy()
    t = time.perf_counter()
    try:
        trainer = cli.main(["--task", "HEAD_TRAINING", "--config_path",
                            path])
        torch.cuda.synchronize()
    finally:
        spy.restore()
    wall = time.perf_counter() - t
    counts = launch_counts()
    launches = counts["roialign_padded"]
    timing = train_timing("e2e_train", trainer, smi)
    (epoch,) = trainer.history
    phase("e2e_train", f"{wall:.2f}s, {timing['steps']} steps, kernel "
          f"launches {counts}; epoch {json.dumps(epoch)}")
    if not np.isfinite(epoch["val_loss"]):
        raise AssertionError(f"e2e_train val_loss {epoch['val_loss']}")
    val_steps = 1   # min(val_steps 2, one test batch)
    want = 2 * timing["steps"] + 2 * val_steps
    calls = spy.calls["roialign_padded"]
    if launches != want or len(calls) != want:
        raise AssertionError(f"e2e_train: {launches} roialign_padded "
                             f"launches, {len(calls)} calls, want {want}")
    for i, args in enumerate(calls):
        errs["roialign_padded"].append(compare_padded(
            args, f"e2e_train captured roialign_padded call {i} "
                  f"(p={args[1].shape[-1]})"))
    shapes = padded_shapes(calls[:2], "e2e_train")  # the first train step
    check_ckpt_files("e2e_train", wdir)
    src = params_from_jax(load_params(ckpt)[0])
    saved = params_from_jax(load_params(os.path.join(wdir,
                                                     "latest.msgpack"))[0])
    if src.keys() != saved.keys():
        raise AssertionError("e2e_train: latest.msgpack leaves differ from "
                             "the checkpoint's")
    heads = [k for k in src if "mrcnn_" in k]
    trunk_diff = [k for k in src if k not in heads
                  and not torch.equal(src[k], saved[k])]
    moved = [k for k in heads if not torch.equal(src[k], saved[k])]
    if trunk_diff or not moved:
        raise AssertionError(f"e2e_train: trunk leaves changed {trunk_diff}; "
                             f"head leaves changed {len(moved)}")
    phase("e2e_train", f"{len(src) - len(heads)} trunk leaves (params and "
          f"batch_stats) bit-equal to the checkpoint; {len(moved)} of "
          f"{len(heads)} head leaves changed; #3 launches {launches} = 2 x "
          f"{timing['steps']} train + 2 x {val_steps} val steps")
    return dict(timing, wall_s=wall, epoch=epoch, padded=shapes), \
        os.path.join(wdir, "best.msgpack"), counts


def e2e_fit_run(here: str, tmp: str, smi: str) -> dict:
    """Fresh heads (JAX's initialiser distributions) on the tracked trunk
    and RPN, FIT_STEPS e2e steps on one fixed batch: the mean of the last
    five losses must be below the first."""
    from m3d_torch.checkpoints import (load_params, params_from_jax,
                                       params_to_jax, save_params)
    from m3d_torch.config import load_config
    from m3d_torch.data.datasets import ToyDataset
    from m3d_torch.data.generators import RPNGenerator, to_device
    from m3d_torch.train.head import HeadTrainer

    trunk = {k: v for k, v in params_from_jax(
        load_params(os.path.join(here, CHECKPOINT))[0]).items()
        if "mrcnn_" not in k}
    rpn_only = save_params(os.path.join(tmp, "rpn_only.msgpack"),
                           params_to_jax(trunk))
    out = os.path.join(tmp, "out_fit")
    config = load_config(write_config(
        os.path.join(here, E2E_CONFIG), os.path.join(tmp, "fit.json"),
        DATA_DIR=os.path.join(tmp, "train_data"), OUTPUT_DIR=out,
        WEIGHT_DIR=os.path.join(out, "weights"), RPN_WEIGHTS=rpn_only,
        HEAD_WEIGHTS=None))
    torch.cuda.reset_peak_memory_stats()
    trainer = HeadTrainer(config)
    opt = trainer.prepare_e2e()
    ds = ToyDataset()
    ds.load_dataset(config.DATA_DIR, is_train=True,
                    class_names=tuple(config.CLASS_NAMES))
    ds.prepare()
    batch = to_device(next(iter(RPNGenerator(ds, config, mode="e2e"))),
                      trainer.device)
    step = trainer.make_e2e_step(opt, torch.Generator(
        trainer.device).manual_seed(1))
    for _ in range(FIT_STEPS):
        trainer.clock.run(step, batch)
    timing = train_timing("e2e_fit", trainer, smi)
    losses = timing["losses"]
    last = float(np.mean(losses[-5:]))
    phase("e2e_fit", f"{FIT_STEPS} steps on one batch, loss "
          f"{[round(v, 4) for v in losses]}; first {losses[0]:.4f}, mean "
          f"of the last five {last:.4f}")
    if not last < losses[0]:
        raise AssertionError(f"e2e_fit: the loss did not fall "
                             f"({losses[0]:.4f} -> {last:.4f})")
    split = e2e_step_split(trainer, opt, batch)
    phase("e2e_fit", f"e2e step split ms (CUDA events, mean of 3): {split}")
    return dict(timing, split=split)


def leaf_groups(state: dict) -> dict:
    """Leaf names by group: trunk (ResNet), FPN, RPN, heads, BatchNorm
    parameters outside the heads, and running statistics."""
    groups = {"resnet": [], "fpn": [], "rpn": [], "heads": [],
              "trunk_bn": [], "stats": []}
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            groups["stats"].append(k)
        elif "mrcnn_" in k:
            groups["heads"].append(k)
        elif any("bn" in seg.lower() for seg in k.split(".")):
            groups["trunk_bn"].append(k)
        else:
            groups[k.split(".")[0]].append(k)
    return groups


def saved_vs(src: dict, path: str) -> tuple[dict, list]:
    """(the leaves of checkpoint ``path``, the names that differ from
    ``src``)."""
    from m3d_torch.checkpoints import load_params, params_from_jax

    saved = params_from_jax(load_params(path)[0])
    if saved.keys() != src.keys():
        raise AssertionError(f"{path}: leaves differ from the checkpoint's")
    return saved, [k for k in src if not torch.equal(src[k], saved[k])]


def targeting_run(here: str, tmp: str, smi: str, errs: dict):
    """TARGET_GENERATION through the port's CLI on the training volumes
    (TARGET_RATIO 1.0: every image of both splits), artifacts under
    DATA_DIR/head_targets. Every #3 launch (2 per targeted image, p = 7
    and 14) is held against its plain version; every file of every kept
    image and both manifests must exist. Returns (timing, output root,
    the run's launch counts)."""
    import csv

    from m3d_torch import __main__ as cli
    from m3d_torch.train import rpn as trpn

    data = os.path.join(tmp, "train_data")
    out = os.path.join(tmp, "out_targeting")
    path = write_config(
        os.path.join(here, TARGET_CONFIG), os.path.join(tmp, "target.json"),
        DATA_DIR=data, OUTPUT_DIR=out, WEIGHT_DIR=os.path.join(out, "weights"),
        RPN_WEIGHTS=os.path.join(here, CHECKPOINT), TARGET_RATIO=1.0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spy = Spy()
    real = trpn.RPNTrainer.head_target_generation
    trainers = []   # the CLI's trainer, for its per-image stage seconds

    def capture(obj, *args, **kw):
        trainers.append(obj)
        return real(obj, *args, **kw)

    trpn.RPNTrainer.head_target_generation = capture
    t = time.perf_counter()
    try:
        root, manifests = cli.main(["--task", "TARGET_GENERATION",
                                    "--config_path", path])
        torch.cuda.synchronize()
    finally:
        spy.restore()
        trpn.RPNTrainer.head_target_generation = real
    wall = time.perf_counter() - t
    counts = launch_counts()
    launches = counts["roialign_padded"]
    trainer = trainers[0]
    if root != os.path.join(data, "head_targets"):
        raise AssertionError(f"targeting: output root {root}")
    kept, processed = 0, 0
    for split in ("train", "test"):
        with open(os.path.join(data, "datasets", f"{split}.csv")) as f:
            processed += sum(1 for _ in f) - 1
        with open(manifests[split], newline="") as f:
            rows = list(csv.reader(f))
        if rows[0] != list(trpn.TARGET_KEYS):
            raise AssertionError(f"targeting: {split} manifest header "
                                 f"{rows[0]}")
        absent = [p for r in rows[1:] for p in r if not os.path.exists(p)]
        if absent or len(rows) < 2:
            raise AssertionError(f"targeting: {split}: {len(rows) - 1} "
                                 f"images, files missing {absent}")
        kept += len(rows) - 1
    calls = spy.calls["roialign_padded"]
    if launches != 2 * processed or len(calls) != launches:
        raise AssertionError(f"targeting: {launches} roialign_padded "
                             f"launches, {len(calls)} calls, want 2 x "
                             f"{processed} images")
    for i, args in enumerate(calls):
        errs["roialign_padded"].append(compare_padded(
            args, f"targeting captured roialign_padded call {i} "
                  f"(p={args[1].shape[-1]})"))
    times = trainer.target_times
    stages = ("forward", "targets", "roialign", "write")
    per_image = {k: float(np.mean([tm[k] for tm in times])) for k in stages}
    written = int(sum(tm["bytes"] for tm in times))
    timing = {"images_processed": processed, "images_kept": kept,
              "seconds_per_image": per_image, "bytes_written": written,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "wall_s": wall}
    print(f"[{smi}] targeting timing: {json.dumps(timing)}", flush=True)
    phase("targeting", f"{wall:.2f}s, {kept} of {processed} images kept, "
          f"{written / 1e6:.1f} MB written, kernel launches {counts}: #3 "
          f"{launches} = 2 x {processed} images; mean seconds per image "
          f"{per_image}")
    timing["padded"] = padded_shapes(calls[:2], "targeting")
    return timing, root, counts


def head_train_run(here: str, tmp: str, smi: str, root: str):
    """Head-only HEAD_TRAINING (MODE "training") through the port's CLI on
    the targeting artifacts: the targeting config's model, SGD 0.0005 /
    momentum 0.9 (configs/heads/scp_heads_config.json), HEAD_WEIGHTS the
    tracked checkpoint, one epoch. The optimiser covers every leaf as in
    JAX, so weight decay moves the trunk's decayed kernels; its BatchNorm
    parameters and every running statistic must stay bit-equal. Returns
    (timing, best.msgpack path, kernel launches)."""
    from m3d_torch import __main__ as cli
    from m3d_torch.checkpoints import load_params, params_from_jax

    out = os.path.join(tmp, "out_head")
    wdir = os.path.join(out, "weights")
    ckpt = os.path.join(here, CHECKPOINT)
    path = write_config(
        os.path.join(here, TARGET_CONFIG), os.path.join(tmp, "head.json"),
        DATA_DIR=root, OUTPUT_DIR=out, WEIGHT_DIR=wdir, MODE="training",
        OPTIMIZER=HEAD_OPTIMIZER, RPN_WEIGHTS=None, HEAD_WEIGHTS=ckpt,
        EPOCHS=1, FROM_EPOCH=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    trainer = cli.main(["--task", "HEAD_TRAINING", "--config_path", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    timing = train_timing("head_train", trainer, smi)
    (epoch,) = trainer.history
    phase("head_train", f"{wall:.2f}s, {timing['steps']} steps, kernel "
          f"launches {launches}; epoch {json.dumps(epoch)}")
    if not np.isfinite(epoch["val_loss"]):
        raise AssertionError(f"head_train val_loss {epoch['val_loss']}")
    check_ckpt_files("head_train", wdir)
    src = params_from_jax(load_params(ckpt)[0])
    _, moved = saved_vs(src, os.path.join(wdir, "latest.msgpack"))
    groups = leaf_groups(src)
    kept = groups["trunk_bn"] + groups["stats"]
    if set(kept) & set(moved):
        raise AssertionError(f"head_train: leaves JAX leaves unchanged "
                             f"moved: {sorted(set(kept) & set(moved))}")
    heads = [k for k in groups["heads"] if k in moved]
    if not heads:
        raise AssertionError("head_train: no head leaf changed")
    phase("head_train", f"{len(kept)} BatchNorm leaves and running "
          f"statistics bit-equal to the checkpoint; {len(heads)} of "
          f"{len(groups['heads'])} head leaves and {len(moved) - len(heads)}"
          f" trunk leaves (weight decay) changed")
    # The host split's npz part: one batch's artifacts loaded as the
    # HeadGenerator loads them.
    from m3d_torch.data.datasets import ToyHeadDataset

    ds = ToyHeadDataset()
    ds.load_dataset(root, is_train=True)
    ds.prepare()
    t = time.perf_counter()
    for i in range(min(len(ds.image_info), int(trainer.config.BATCH_SIZE))):
        ds.load_data(i)
    npz_ms = (time.perf_counter() - t) * 1e3
    print(f"[{smi}] head_train host split: npz load of one batch "
          f"{npz_ms:.1f} ms", flush=True)
    return dict(timing, wall_s=wall, epoch=epoch, npz_load_ms=npz_ms), \
        os.path.join(wdir, "best.msgpack"), launches


def all_train(data: str) -> None:
    """Put every volume of ``data`` into its train split (the MRCNN
    trainer splits the train split 80/20 itself)."""
    import csv

    rows = []
    for split in ("train", "test"):
        with open(os.path.join(data, "datasets", f"{split}.csv"),
                  newline="") as f:
            got = list(csv.reader(f))
        header, rows = got[0], rows + got[1:]
    for split, part in (("train", rows), ("test", [])):
        with open(os.path.join(data, "datasets", f"{split}.csv"), "w",
                  newline="") as f:
            csv.writer(f).writerows([header] + sorted(part))


def mrcnn_step_split(trainer, batch) -> dict:
    """The MRCNN train step's parts (LEARNING_LAYERS "all"), chained as
    MrcnnTrainer._outputs and make_train_step chain them, with a fresh
    optimiser over the trained model; and the gather ROIAlign alone at the
    step's shapes, forward and backward."""
    from m3d_torch.models import losses as L
    from m3d_torch.models.detection_targets import detection_targets_batch
    from m3d_torch.ops.roialign3d import pyramid_roi_align_auto
    from m3d_torch.train.head import head_losses
    from m3d_torch.train.optim import Optimizer, apply_constraints

    cfg, model = trainer.config, trainer.model
    params = dict(model.named_parameters())
    opt = Optimizer(cfg, params)
    gen = torch.Generator(trainer.device).manual_seed(3)
    active = torch.ones((batch["image"].shape[0], int(cfg.NUM_CLASSES)),
                        device=trainer.device)
    meta = batch["image_meta"].float()
    st = {}

    def rpn(_):
        for p in params.values():
            p.grad = None
        st["rpn"] = model.rpn_outputs(batch["image"], trainer._anchors_dev)
        st["rpn_loss"] = (
            L.rpn_class_loss(batch["rpn_match"],
                             st["rpn"]["rpn_class_logits"])[0]
            + L.rpn_bbox_loss(batch["rpn_bbox"], batch["rpn_match"],
                              st["rpn"]["rpn_bbox"])[0])

    def targets(_):
        st["t"] = detection_targets_batch(
            st["rpn"]["proposals"], batch["gt_class_ids"], batch["gt_boxes"],
            batch["gt_masks"], cfg.BBOX_STD_DEV,
            int(cfg.TRAIN_ROIS_PER_IMAGE), float(cfg.ROI_POSITIVE_RATIO),
            float(cfg.RPN_POSITIVE_IOU), float(cfg.RPN_NEGATIVE_IOU),
            tuple(int(v) for v in cfg.MASK_SHAPE),
            use_mini_mask=bool(cfg.USE_MINI_MASK), generator=gen)

    def align(_):
        feats = list(st["rpn"]["feature_maps"][:4])
        return [pyramid_roi_align_auto(st["t"]["rois"], meta, feats, int(q))
                for q in (cfg.POOL_SIZE, cfg.MASK_POOL_SIZE)]

    def heads(aligned):
        out = model.forward_heads(*aligned)
        t = st["t"]
        return st["rpn_loss"] + head_losses(
            cfg, out, {"target_class_ids": t["class_ids"],
                       "target_bbox": t["deltas"],
                       "target_mask": t["masks"]}, active)[0]

    split = _split_ms([
        ("RPN forward + losses", rpn), ("targets", targets),
        ("ROIAlign forward (gather) x2", align),
        ("heads forward + losses", heads),
        ("backward", lambda loss: loss.backward()),
        ("optimizer + constraints", lambda _: (opt.step(), apply_constraints(
            params)))])
    # The gather alone, on the step's feature maps (with their graph).
    feats = [f.detach().requires_grad_(True)
             for f in st["rpn"]["feature_maps"][:4]]
    rois = st["t"]["rois"]
    gather = {}
    for q in (cfg.POOL_SIZE, cfg.MASK_POOL_SIZE):
        def fwd(q=q):
            return pyramid_roi_align_auto(rois, meta, feats, int(q))
        out = fwd()
        cot = torch.randn_like(out)

        def bwd(out=out, cot=cot):
            torch.autograd.grad(out, feats, cot, retain_graph=True)
        bwd()
        gather[f"p{q}"] = {"rows": int(rois.shape[0] * rois.shape[1]),
                           "forward_ms": cuda_ms(fwd, 5),
                           "backward_ms": cuda_ms(bwd, 5)}
    return split, gather


def mrcnn_train_run(here: str, tmp: str, smi: str, errs: dict):
    """MRCNN_TRAINING through the port's CLI on 10 more 128^3 volumes
    (seeds MRCNN_SEED.., all in the train split: the 80/20 split gives 8 /
    2, four steps of B = 2 and one validation batch), the e2e config's
    model with LEARNING_LAYERS "all", SGD 0.001 / momentum 0.9
    (configs/mrcnn/scp_mrcnn_training.json), RPN_WEIGHTS and HEAD_WEIGHTS
    the tracked checkpoint, one epoch. #3 must run 0 times in the train
    steps (their ROIAligns take the gather, with gradients) and 2 per
    validation step, each launch held against its plain version; trunk,
    FPN, RPN and head leaves must all move. Returns (timing, best.msgpack
    path, the run's launch counts)."""
    from m3d_torch import __main__ as cli
    from m3d_torch.checkpoints import load_params, params_from_jax
    from m3d_torch.data.datasets import ToyDataset
    from m3d_torch.data.generators import MrcnnGenerator, to_device
    from m3d_torch.data.synthetic import generate_experiment, split_dataset
    from m3d_torch.ops import roialign_compact as rc
    from m3d_torch.train import mrcnn as tmrcnn

    data = os.path.join(tmp, "mrcnn_data")
    t = time.perf_counter()
    generate_experiment(MRCNN_IMAGES, SIZE, data, seed=MRCNN_SEED)
    split_dataset(data)
    all_train(data)
    phase("mrcnn_train", f"dataset of {MRCNN_IMAGES} volumes {SIZE}^3 "
          f"written in {time.perf_counter() - t:.2f}s")
    out = os.path.join(tmp, "out_mrcnn")
    wdir = os.path.join(out, "weights")
    ckpt = os.path.join(here, CHECKPOINT)
    path = write_config(
        os.path.join(here, E2E_CONFIG), os.path.join(tmp, "mrcnn.json"),
        DATA_DIR=data, OUTPUT_DIR=out, WEIGHT_DIR=wdir, MODE="training",
        LEARNING_LAYERS="all", OPTIMIZER=MRCNN_OPTIMIZER, RPN_WEIGHTS=ckpt,
        HEAD_WEIGHTS=ckpt, EPOCHS=1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spy = Spy()
    real_steps = tmrcnn.MrcnnTrainer.make_train_step
    in_steps = []   # #3 launches within each train step

    def counted(obj, *args, **kw):
        step = real_steps(obj, *args, **kw)

        def run(batch):
            before = rc.PADDED.launches
            out = step(batch)
            in_steps.append(rc.PADDED.launches - before)
            return out
        return run

    tmrcnn.MrcnnTrainer.make_train_step = counted
    t = time.perf_counter()
    try:
        trainer = cli.main(["--task", "MRCNN_TRAINING", "--config_path",
                            path])
        torch.cuda.synchronize()
    finally:
        spy.restore()
        tmrcnn.MrcnnTrainer.make_train_step = real_steps
    wall = time.perf_counter() - t
    counts = launch_counts()
    launches = counts["roialign_padded"]
    timing = train_timing("mrcnn_train", trainer, smi)
    (epoch,) = trainer.history
    phase("mrcnn_train", f"{wall:.2f}s, {timing['steps']} steps, kernel "
          f"launches {counts}; epoch {json.dumps(epoch)}")
    if not np.isfinite(epoch["val_loss"]):
        raise AssertionError(f"mrcnn_train val_loss {epoch['val_loss']}")
    val_steps = 1   # min(VAL_STEPS 4, one batch of the 2 held-out volumes)
    calls = spy.calls["roialign_padded"]
    if (any(in_steps) or len(in_steps) != timing["steps"]
            or launches != 2 * val_steps or len(calls) != launches):
        raise AssertionError(f"mrcnn_train: #3 launches {in_steps} in the "
                             f"train steps, {launches} in all, {len(calls)} "
                             f"calls; want 0 and 2 x {val_steps}")
    for i, args in enumerate(calls):
        errs["roialign_padded"].append(compare_padded(
            args, f"mrcnn_train captured roialign_padded call {i} "
                  f"(p={args[1].shape[-1]})"))
    check_ckpt_files("mrcnn_train", wdir)
    src = params_from_jax(load_params(ckpt)[0])
    _, moved = saved_vs(src, os.path.join(wdir, "latest.msgpack"))
    groups = leaf_groups(src)
    count = {g: sum(k in moved for k in groups[g])
             for g in ("resnet", "fpn", "rpn", "heads")}
    if not all(count.values()):
        raise AssertionError(f"mrcnn_train: leaves moved by group {count}")
    phase("mrcnn_train", f"leaves moved by group {count}; #3 launches "
          f"{in_steps} in the train steps, {launches} = 2 x {val_steps} "
          f"validation steps")
    ds = ToyDataset()
    ds.load_dataset(data, is_train=True,
                    class_names=tuple(trainer.config.CLASS_NAMES))
    ds.prepare()
    batch = to_device(MrcnnGenerator(ds, trainer.config, mode="training",
                                     augment=False).get_batch([0, 1]),
                      trainer.device)
    split, gather = mrcnn_step_split(trainer, batch)
    phase("mrcnn_train", f"step split ms (CUDA events, mean of 3): {split}")
    phase("mrcnn_train", f"gather ROIAlign at the step's shapes (CUDA "
          f"events): {json.dumps(gather)}")
    return dict(timing, wall_s=wall, epoch=epoch, split=split,
                gather=gather, padded=padded_shapes(calls[:2],
                                                    "mrcnn_train")), \
        os.path.join(wdir, "best.msgpack"), counts


def train_bn_run(here: str, tmp: str, smi: str):
    """TRAIN_BN: RPN_TRAINING for one epoch and MRCNN_TRAINING for one
    step (the training volumes' four train images: a split of three and
    one, no validation batch) from the tracked checkpoint. Finite losses;
    every running statistic the run's BatchNorms see (the trunk's for
    RPN_TRAINING, all for MRCNN_TRAINING) differs in latest.msgpack from
    the checkpoint's. Prints det@0.5_top500 without a floor. Returns
    (timings by run, kernel launches of both runs)."""
    from m3d_torch import __main__ as cli
    from m3d_torch.checkpoints import load_params, params_from_jax

    ckpt = os.path.join(here, CHECKPOINT)
    src = params_from_jax(load_params(ckpt)[0])
    stats = leaf_groups(src)["stats"]
    data = os.path.join(tmp, "train_data")
    with open(os.path.join(here, RPN_TRAIN_CONFIG)) as f:
        from_epoch = int(json.load(f)["FROM_EPOCH"])
    runs = {
        "rpn": ("RPN_TRAINING", RPN_TRAIN_CONFIG,
                dict(RPN_WEIGHTS=ckpt, EPOCHS=from_epoch + 1),
                [k for k in stats if k.startswith("resnet.")]),
        "mrcnn": ("MRCNN_TRAINING", E2E_CONFIG,
                  dict(MODE="training", LEARNING_LAYERS="all",
                       OPTIMIZER=MRCNN_OPTIMIZER, RPN_WEIGHTS=ckpt,
                       HEAD_WEIGHTS=ckpt, EPOCHS=1), stats)}
    result, launches = {}, {}
    for name, (task, config, keys, seen) in runs.items():
        out = os.path.join(tmp, f"out_bn_{name}")
        wdir = os.path.join(out, "weights")
        path = write_config(os.path.join(here, config),
                            os.path.join(tmp, f"bn_{name}.json"),
                            DATA_DIR=data, OUTPUT_DIR=out, WEIGHT_DIR=wdir,
                            TRAIN_BN=True, **keys)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        trainer = cli.main(["--task", task, "--config_path", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for k, n in launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        timing = train_timing(f"train_bn {name}", trainer, smi)
        (epoch,) = trainer.history
        _, moved = saved_vs(src, os.path.join(wdir, "latest.msgpack"))
        still = [k for k in seen if k not in moved]
        if still:
            raise AssertionError(f"train_bn {name}: running statistics "
                                 f"unchanged: {still}")
        phase("train_bn", f"{task} {wall:.2f}s, {timing['steps']} steps, "
              f"all {len(seen)} running statistics its BatchNorms see "
              f"moved; epoch {json.dumps(epoch)}")
        result[name] = dict(timing, wall_s=wall, epoch=epoch)
        if name == "rpn":
            result[name]["witness"] = train_bn_witness(
                trainer, src, os.path.join(wdir, "latest.msgpack"), stats)
    phase("train_bn", f"RPN det@0.5_top500 after one TRAIN_BN epoch "
          f"{result['rpn']['epoch']['det@0.5_top500']} (no floor); kernel "
          f"launches {launches}")
    return result, launches


def train_bn_witness(trainer, src: dict, latest: str, stats: list) -> dict:
    """Where the TRAIN_BN RPN epoch's det@0.5_top500 comes from. The
    tracked checkpoint was trained on running statistics and every one of
    them is still at its initial value (mean 0, variance 1), so batch
    statistics are a different function of its weights. (1) det@0.5_top500
    of the epoch's evaluation (the same test volumes, EVAL_IMAGES) for the
    trained weights with the checkpoint's statistics put back, and for the
    checkpoint's weights with the trained statistics: which of the two
    carries the change. (2) One more TRAIN_BN forward on a training batch:
    each trunk BatchNorm's running statistics must move to m * old + (1 -
    m) * batch, the batch's mean and biased variance taken in float64 from
    the layer's own bf16 input, within BN_UPDATE_TOL of E[x^2] (mean: of
    its square root). Returns the numbers."""
    from m3d_torch.checkpoints import restore_by_name
    from m3d_torch.data.generators import RPNGenerator, to_device
    from m3d_torch.models.backbone import BatchNorm
    from m3d_torch.train.rpn import EVAL_IMAGES
    from m3d_torch.utils.metrics import rpn_evaluation

    at_init = [k for k in stats if not torch.equal(
        src[k], torch.full_like(src[k], 0.0 if k.endswith("mean") else 1.0))]
    model, cfg = trainer.model, trainer.config
    saved, _ = saved_vs(src, latest)
    _, test_ds = trainer.prepare_datasets()
    det = {}
    for label, weights, running in (
            ("trained", saved, saved),
            ("trained weights, checkpoint statistics", saved, src),
            ("checkpoint weights, trained statistics", src, saved)):
        restore_by_name(model, {k: (running if k in stats else weights)[k]
                                for k in src})
        det[label] = rpn_evaluation(
            trainer.make_proposal_fn(), test_ds, cfg,
            max_images=EVAL_IMAGES)["det@0.5_top500"]
    phase("train_bn", f"checkpoint running statistics not at their initial "
          f"value: {len(at_init)} of {len(stats)}; det@0.5_top500 on the "
          f"epoch's test volumes: {json.dumps(det)}")

    restore_by_name(model, saved)
    train_ds, _ = trainer.prepare_datasets()
    batch = to_device(RPNGenerator(train_ds, cfg, mode="training",
                                   shuffle=False, augment=False
                                   ).get_batch([0, 1]), trainer.device)
    want = {}

    def expect(mod, args):
        x = args[0].detach().double()
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        ex2 = (x * x).mean(axes)
        m = mod.momentum
        want[mod] = (m * mod.running_mean.double() + (1 - m) * mean,
                     m * mod.running_var.double()
                     + (1 - m) * x.var(axes, correction=0),
                     (1 - m) * ex2, args[0].dtype)

    bns = [mod for mod in model.resnet.modules() if isinstance(mod, BatchNorm)]
    hooks = [mod.register_forward_pre_hook(expect) for mod in bns]
    try:
        with torch.no_grad():
            model.bn_mode(True)
            model.forward_rpn_train(batch["image"])
            torch.cuda.synchronize()
    finally:
        model.bn_mode(False)
        for h in hooks:
            h.remove()
    err_mean = err_var = 0.0
    for mod in bns:
        mean, var, scale, _ = want[mod]   # scale: (1 - m) E[x^2]
        m = mod.momentum
        d_mean = (mod.running_mean.double() - mean).abs()
        d_var = (mod.running_var.double() - var).abs()
        err_mean = max(err_mean, float((d_mean / ((1 - m) * scale).sqrt()
                                        .clamp_min(1e-30)).max()))
        err_var = max(err_var, float((d_var / scale.clamp_min(1e-30)).max()))
    dtypes = sorted({str(w[3]) for w in want.values()})
    phase("train_bn", f"{len(bns)} trunk BatchNorms, inputs {dtypes}: "
          f"running statistics after one more TRAIN_BN forward against "
          f"float64 batch statistics: mean {err_mean:.3e}, variance "
          f"{err_var:.3e} of the update's scale (tolerance {BN_UPDATE_TOL})")
    if len(want) != len(bns) or max(err_mean, err_var) > BN_UPDATE_TOL:
        raise AssertionError(f"train_bn: BatchNorm update off: mean "
                             f"{err_mean}, variance {err_var}")
    return {"det@0.5_top500": det, "stats_not_at_init": len(at_init),
            "bn_update_err": {"mean": err_mean, "var": err_var}}


def matched_detections(det_ref, valid_ref, det, valid) -> int:
    """Valid detections of ``det`` that overlap a valid detection of
    ``det_ref`` in the same volume at IoU >= 0.5."""
    from m3d_torch.utils.metrics import overlaps_3d_numpy

    n = 0
    for b in range(det.shape[0]):
        a, m = det_ref[b, valid_ref[b], :6], det[b, valid[b], :6]
        if len(a) and len(m):
            n += int((overlaps_3d_numpy(m, a).max(1) >= 0.5).sum())
    return n


def host_split(ds, anchors, cfg, ids) -> dict:
    """Host ms of one training batch's parts, summed over the images
    ``ids``: TIFF decode (native library / numpy reader), the bz2 GT masks,
    RPN targets (native IoU / numpy IoU)."""
    from types import SimpleNamespace

    from m3d_torch import native
    from m3d_torch.data import rpn_targets
    from m3d_torch.utils.metrics import overlaps_3d_numpy
    from m3d_torch.utils.tiffio import _read_numpy

    def ms(fn):
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3

    split = {k: 0.0 for k in ("tiff_native", "tiff_numpy", "gt_masks_bz2",
                              "rpn_targets_native_iou",
                              "rpn_targets_numpy_iou")}
    for i in ids:
        path = ds.image_info[i]["path"]
        split["tiff_native"] += ms(lambda: native.read_tiff_volume(path))[1]
        split["tiff_numpy"] += ms(lambda: _read_numpy(path))[1]
        (boxes, cls, _), t = ms(lambda: ds.load_data(i))
        split["gt_masks_bz2"] += t
        for key, lib in (("rpn_targets_native_iou", native),
                         ("rpn_targets_numpy_iou", SimpleNamespace(
                             iou_matrix_3d=overlaps_3d_numpy))):
            rpn_targets.native = lib
            try:
                split[key] += ms(lambda: rpn_targets.build_rpn_targets(
                    anchors, cls, boxes, cfg,
                    rng=np.random.RandomState(0)))[1]
            finally:
                rpn_targets.native = native
    return {k: round(v, 3) for k, v in split.items()}


def native_run(here: str, tmp: str, smi: str) -> dict:
    """The native host library against its plain versions on this run's
    data: IoU of rpn_synth128's anchors x every training volume's GT
    (max abs difference <= IOU_TOL, equal argmaxes), NMS on NMS_N
    proposal-like boxes (equal kept lists), every volume TIFF written
    (equal arrays), a 128^3 MRC round trip in each mode; then the host
    split of a training batch."""
    import glob

    from m3d_torch import native
    from m3d_torch.anchors import normalized_pyramid_anchors
    from m3d_torch.config import load_config
    from m3d_torch.data.datasets import ToyDataset
    from m3d_torch.data.synthetic import proposal_like_boxes
    from m3d_torch.ops.nms3d import nms_3d_numpy
    from m3d_torch.utils.metrics import overlaps_3d_numpy
    from m3d_torch.utils.mrcio import read_mrc, write_mrc
    from m3d_torch.utils.tiffio import _read_numpy

    lib = native.LIB
    lib.load()
    how = (f"built in {lib.build_seconds:.2f}s" if lib.build_seconds
           else "cached")
    phase("native", f"{os.path.basename(lib.path())}: {how}")
    cfg = load_config(os.path.join(here, RPN_CONFIG))
    anchors = normalized_pyramid_anchors(
        cfg, voxel_z_over_y=float(getattr(cfg, "VOXEL_Z_OVER_Y", 1.0)))
    scale = np.array([SIZE] * 6, np.float32)
    data = os.path.join(tmp, "train_data")
    worst, n_gt, iou_ms = 0.0, 0, [0.0, 0.0]
    for is_train in (True, False):
        ds = ToyDataset()
        ds.load_dataset(data, is_train=is_train,
                        class_names=tuple(cfg.CLASS_NAMES))
        ds.prepare()
        for i in range(len(ds.image_info)):
            boxes, _, _ = ds.load_data(i, masks_needed=False)
            gt = np.clip(boxes.astype(np.float32) / scale, 0, 1)
            t = time.perf_counter()
            got = native.iou_matrix_3d(anchors, gt)
            iou_ms[0] += (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            ref = overlaps_3d_numpy(anchors, gt)
            iou_ms[1] += (time.perf_counter() - t) * 1e3
            err = float(np.abs(got - ref).max())
            if err > IOU_TOL or not (
                    np.array_equal(got.argmax(0), ref.argmax(0))
                    and np.array_equal(got.argmax(1), ref.argmax(1))):
                raise AssertionError(f"native IoU vs numpy: max abs "
                                     f"{err}, argmaxes differ")
            worst, n_gt = max(worst, err), n_gt + gt.shape[0]
    phase("native", f"iou_matrix_3d: {anchors.shape[0]} anchors x {n_gt} "
          f"GT boxes of {TRAIN_IMAGES} volumes, max abs {worst:.3e} "
          f"(<= {IOU_TOL}), row and column argmaxes equal; "
          f"{iou_ms[0]:.1f} ms native, {iou_ms[1]:.1f} ms numpy")

    rng = np.random.RandomState(7)
    boxes = proposal_like_boxes(rng, NMS_N)
    scores = rng.uniform(size=NMS_N).astype(np.float32)
    t = time.perf_counter()
    kept = native.nms_3d_host(boxes, scores, NMS_THR, NMS_K)
    nms_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    want = nms_3d_numpy(boxes, scores, NMS_THR, NMS_K)
    nms_np_ms = (time.perf_counter() - t) * 1e3
    if not np.array_equal(kept, want):
        raise AssertionError(f"native NMS kept {len(kept)}, numpy "
                             f"{len(want)}")
    phase("native", f"nms_3d_host: N={NMS_N}, kept {len(kept)}, equal to "
          f"nms_3d_numpy; {nms_ms:.1f} ms native, {nms_np_ms:.1f} ms numpy")

    tiffs = sorted(glob.glob(os.path.join(tmp, "*", "images", "*.tiff")))
    for path in tiffs:
        got, ref = native.read_tiff_volume(path), _read_numpy(path)
        if got is None or got.dtype != ref.dtype or \
                not np.array_equal(got, ref):
            raise AssertionError(f"native TIFF read differs: {path}")
    phase("native", f"read_tiff_volume: {len(tiffs)} volume TIFFs equal "
          f"to the numpy reader")

    mrc = {}
    for mode, dtype in MRC_MODES.items():
        vol = (rng.randn(SIZE, SIZE, SIZE) * 40).astype(dtype)
        path = os.path.join(tmp, f"v{mode}.mrc")
        t = time.perf_counter()
        write_mrc(path, vol)
        back = read_mrc(path)
        mrc[mode] = round((time.perf_counter() - t) * 1e3, 2)
        os.remove(path)
        if back.dtype != vol.dtype or not np.array_equal(back, vol):
            raise AssertionError(f"MRC mode {mode} round trip differs")
    phase("native", f"MRC {SIZE}^3 round trips equal, ms by mode {mrc}")

    ds = ToyDataset()
    ds.load_dataset(data, is_train=True, class_names=tuple(cfg.CLASS_NAMES))
    ds.prepare()
    train_cfg = load_config(os.path.join(here, RPN_TRAIN_CONFIG))
    split = host_split(ds, anchors, train_cfg,
                       range(int(train_cfg.IMAGES_PER_GPU)))
    print(f"[{smi}] native host split per training batch of "
          f"{train_cfg.IMAGES_PER_GPU}, ms: {json.dumps(split)}", flush=True)
    return {"build_s": lib.build_seconds, "iou_max_abs": worst,
            "host_split_ms": split, "nms_ms": nms_ms,
            "nms_numpy_ms": nms_np_ms, "mrc_ms": mrc}


def autotune_run(here: str, tmp: str, smi: str) -> dict:
    """RPN_TRAINING with AUTO_TUNE_RPN and AUTO_TUNE_APPLY through the
    port's CLI, in this process, one epoch from the tracked checkpoint:
    autotune_patch.json equal to ``autotune_rpn`` recomputed on the same
    training split, the trainer's anchors and RPN head those of the patched
    config, finite losses; det@0.5_top500 printed without a floor (the
    checkpoint was trained for other anchors)."""
    from m3d_torch import __main__ as cli
    from m3d_torch.anchors import normalized_pyramid_anchors
    from m3d_torch.config import load_config
    from m3d_torch.data.datasets import ToyDataset
    from m3d_torch.train.autotune import autotune_rpn

    with open(os.path.join(here, RPN_TRAIN_CONFIG)) as f:
        from_epoch = int(json.load(f)["FROM_EPOCH"])
    out = os.path.join(tmp, "out_autotune")
    wdir = os.path.join(out, "weights")
    data = os.path.join(tmp, "train_data")
    path = write_config(
        os.path.join(here, RPN_TRAIN_CONFIG),
        os.path.join(tmp, "autotune.json"), DATA_DIR=data, OUTPUT_DIR=out,
        WEIGHT_DIR=wdir, RPN_WEIGHTS=os.path.join(here, CHECKPOINT),
        EPOCHS=from_epoch + 1, AUTO_TUNE_RPN=True, AUTO_TUNE_APPLY=True)
    before = load_config(path)
    n_before = normalized_pyramid_anchors(before).shape[0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    trainer = cli.main(["--task", "RPN_TRAINING", "--config_path", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    timing = train_timing("autotune", trainer, smi)
    (epoch,) = trainer.history

    ds = ToyDataset()
    ds.load_dataset(data, is_train=True,
                    class_names=tuple(before.CLASS_NAMES))
    ds.prepare()
    before.AUTO_TUNE_SAVE_PATCH = False
    patch = autotune_rpn(ds.filter_positive(), before, verbose=False)
    with open(os.path.join(wdir, "autotune_patch.json")) as f:
        saved = f.read()
    if not patch or saved != json.dumps(patch, indent=2):
        raise AssertionError(f"autotune: autotune_patch.json {saved} is not "
                             f"the recomputed patch {patch}")
    patched = load_config(path)
    for k, v in patch.items():
        setattr(patched, k, v)
    want = normalized_pyramid_anchors(
        patched, voxel_z_over_y=float(getattr(patched, "VOXEL_Z_OVER_Y", 1.0)))
    raw = trainer.model.state_dict()["rpn.rpn_class_raw.weight"]
    if trainer.anchors.shape != want.shape or \
            not np.array_equal(trainer.anchors, want) or \
            raw.shape[0] != 2 * len(patch["RPN_ANCHOR_RATIOS"]):
        raise AssertionError(f"autotune: trainer anchors "
                             f"{trainer.anchors.shape}, RPN head "
                             f"{tuple(raw.shape)}; patched config's "
                             f"anchors {want.shape}")
    phase("autotune", f"{wall:.2f}s, {timing['steps']} steps, kernel "
          f"launches {launches}; patch {json.dumps(patch)} equal to "
          f"autotune_rpn recomputed; anchors {n_before} -> "
          f"{want.shape[0]}, RPN head {tuple(raw.shape)}; "
          f"det@0.5_top500 {epoch['det@0.5_top500']:.4f} (no floor); "
          f"epoch {json.dumps(epoch)}")
    return dict(timing, wall_s=wall, epoch=epoch, patch=patch,
                anchors=[n_before, int(want.shape[0])], launches=launches)


def h5_manifest_check(here: str, name: str) -> int:
    """``load_keras_h5`` on a committed fixture: every weight of its
    manifest present with the manifest's sum (rtol 1e-5, the BatchNorm
    epsilon folded into the moving variance). Returns the count."""
    from m3d_torch.utils.h5_import import (FLAX_BN_EPS, KERAS_BN_EPS,
                                           load_keras_h5)

    fix = os.path.join(here, "tests", "fixtures")
    params, stats = load_keras_h5(os.path.join(fix, f"{name}.h5"))
    with open(os.path.join(fix, f"{name}.manifest.json")) as f:
        manifest = json.load(f)
    names = {"gamma": "scale", "beta": "bias", "moving_mean": "mean",
             "moving_variance": "var"}
    for key, info in manifest.items():
        layer, leaf = key.split("/")
        tree = stats if leaf.startswith("moving_") else params
        arr = np.asarray(tree[layer][names.get(leaf, leaf)], np.float64)
        want = info["sum"]
        if leaf == "moving_variance":
            want += (KERAS_BN_EPS - FLAX_BN_EPS) * arr.size
        if not np.isclose(arr.sum(), want, rtol=1e-5, atol=0.0) or \
                list(arr.shape) != list(info["shape"]):
            raise AssertionError(f"h5 {name} {key}: sum {arr.sum()} shape "
                                 f"{arr.shape}, manifest {info}")
    return len(manifest)


def h5_run(here: str, tmp: str, smi: str, errs: dict, dev) -> dict:
    """Keras .h5 weights: (a) both committed fixtures read by the port's
    own reader, every manifest weight with its sum; (b) the fixtures' tiny
    model on the card restored from keras231_tiny.h5 (all 92 weights
    landed, none skipped), adaptive_inference on seeded volumes with every
    compact-kernel launch held against its plain version; (c)
    MRCNN_EVALUATION and RPN_EVALUATION through the CLI with
    keras231_tiny.h5 as their weights on a dataset written here: every
    image evaluated, every artifact written (no recall floor: the weights
    are random). Returns the kernel launches of (b) and (c)."""
    from m3d_torch import __main__ as cli
    from m3d_torch.anchors import normalized_pyramid_anchors
    from m3d_torch.checkpoints import restore_weights
    from m3d_torch.config import Config
    from m3d_torch.data.synthetic import generate_experiment, split_dataset
    from m3d_torch.image_meta import default_meta
    from m3d_torch.models.inference import adaptive_inference
    from m3d_torch.models.mask_rcnn import MaskRCNN, init_params

    t = time.perf_counter()
    counts = {name: h5_manifest_check(here, name) for name in H5_FIXTURES}
    if counts != H5_FIXTURES:
        raise AssertionError(f"h5 fixtures: {counts} of {H5_FIXTURES}")
    phase("h5", f"load_keras_h5 (the port's HDF5 reader, whether h5py "
          f"imports or not): manifest weights {counts} with their sums, "
          f"{time.perf_counter() - t:.2f}s")

    weights = os.path.join(here, "tests", "fixtures", "keras231_tiny.h5")
    cfg = Config(**H5_TINY)
    model = MaskRCNN.from_config(cfg, mode="inference", device=dev).eval()
    init_params(model, 0)
    stats = restore_weights(model, weights)
    if stats["loaded"] != H5_FIXTURES["keras231_tiny"] or stats["skipped"] \
            or stats["sliced"]:
        raise AssertionError(f"h5 tiny model restore: {stats}")
    rng = np.random.RandomState(H5_SEED)
    image = torch.as_tensor(rng.uniform(-1, 1, (H5_IMAGES, 64, 64, 8, 1))
                            .astype(np.float32), device=dev)
    meta = torch.as_tensor(np.tile(default_meta(cfg)[None],
                                   (H5_IMAGES, 1)), device=dev)
    anchors = torch.as_tensor(normalized_pyramid_anchors(cfg), device=dev)
    spy = Spy()
    reset_counts()
    try:
        out = adaptive_inference(
            model, image, meta, anchors, device=dev,
            classifier_chunk=H5_CHUNKS["CLASSIFIER_CHUNK"],
            mask_chunk=H5_CHUNKS["MASK_CHUNK"])
        torch.cuda.synchronize()
    finally:
        spy.restore()
    adaptive = launch_counts()
    calls = [a for a in spy.calls["roialign_compact"] if a[0].shape[0]]
    spy_m = Spy()
    reset_counts()
    try:
        out_m = model(image, meta, anchors)
        torch.cuda.synchronize()
    finally:
        spy_m.restore()
    forward = launch_counts()
    if forward["roialign_slab"] < 1 or forward["roialign_fc (kron)"] or \
            forward["roialign_padded"] < 1 or \
            len(spy_m.calls["roialign_slab"]) != forward["roialign_slab"]:
        raise AssertionError(f"h5 tiny model forward at C = 32: kernel "
                             f"launches {forward} (#4 and #3, not #2)")
    if not all(torch.isfinite(out_m[k].float()).all() for k in
               ("detections", "mrcnn_masks", "mrcnn_probs")):
        raise AssertionError("h5 tiny model forward: non-finite outputs")
    for i, args in enumerate(spy_m.calls["roialign_slab"]):
        errs["roialign_slab"].append(compare_slab(
            args, f"h5 tiny model forward, C = 32 classifier rows, call {i}"))
    for i, args in enumerate(spy_m.calls["roialign_padded"]):
        errs["roialign_padded"].append(compare_padded(
            args, f"h5 tiny model forward, mask stage, call {i}"))
    phase("h5", f"MaskRCNN.forward of the C = 32 model: every classifier "
          f"row on #4 + conv3d_fc (no #2), kernel launches {forward}, each "
          f"held against its plain version")
    if adaptive["roialign_compact"] < 1 or \
            len(calls) != adaptive["roialign_compact"]:
        raise AssertionError(f"h5 tiny model: compact kernel launches "
                             f"{adaptive}, {len(calls)} calls with rows")
    if not all(torch.isfinite(out[k].float()).all() for k in
               ("detections", "mrcnn_masks")):
        raise AssertionError("h5 tiny model: non-finite outputs")
    for i, args in enumerate(calls):
        errs["roialign_compact"].append(compare(
            args, f"h5 tiny model captured adaptive inputs, call {i}"))
    phase("h5", f"tiny model from keras231_tiny.h5 restored {stats}; "
          f"adaptive_inference on {H5_IMAGES} seeded 64x64x8 volumes: "
          f"detections/image {out['detections_valid'].sum(1).tolist()}, "
          f"kernel launches {adaptive}, each held against its plain "
          f"version")

    data = os.path.join(tmp, "h5_data")
    generate_experiment(H5_IMAGES, 64, data, seed=H5_SEED, image_depth=8)
    split_dataset(data, test_ratio=1.0)
    evals = {}
    for task in ("MRCNN_EVALUATION", "RPN_EVALUATION"):
        out_dir = os.path.join(tmp, f"out_h5_{task.lower()}")
        path = os.path.join(tmp, f"h5_{task.lower()}.json")
        # MRCNN_EVALUATION monolithic (chunks 0): the C = 32 classifier on
        # #4, each #4 launch held against its plain version.
        chunks = (dict(CLASSIFIER_CHUNK=0, MASK_CHUNK=0)
                  if task == "MRCNN_EVALUATION" else H5_CHUNKS)
        with open(path, "w") as f:
            json.dump(dict(H5_TINY, **chunks, DATA_DIR=data,
                           OUTPUT_DIR=out_dir,
                           WEIGHT_DIR=os.path.join(out_dir, "weights"),
                           RPN_WEIGHTS=weights, HEAD_WEIGHTS=weights,
                           EVALUATION_STEPS=H5_IMAGES), f)
        spy = Spy()
        reset_counts()
        t = time.perf_counter()
        try:
            res = cli.main(["--task", task, "--config_path", path])
            torch.cuda.synchronize()
        finally:
            spy.restore()
        evals[task] = launch_counts()
        if task == "MRCNN_EVALUATION":
            if evals[task]["roialign_slab"] < 1 or \
                    evals[task]["roialign_fc (kron)"]:
                raise AssertionError(f"h5 {task} with chunks 0 at C = 32: "
                                     f"kernel launches {evals[task]}")
            for i, args in enumerate(spy.calls["roialign_slab"]):
                errs["roialign_slab"].append(compare_slab(
                    args, f"h5 {task} chunks 0, C = 32, call {i}"))
            for i, args in enumerate(spy.calls["roialign_padded"]):
                errs["roialign_padded"].append(compare_padded(
                    args, f"h5 {task} chunks 0, mask stage, call {i}"))
            names = [str(i).zfill(6) for i in range(H5_IMAGES)]
            want = [f"{n}.{ext}" for n in names for ext in ("tiff", "csv")]
            want.append("evaluation_summary.json")
            absent = [w for w in want
                      if not os.path.exists(os.path.join(out_dir, w))]
            if len(res["per_image"]) != H5_IMAGES or absent:
                raise AssertionError(f"h5 {task}: {len(res['per_image'])} "
                                     f"images, artifacts missing {absent}")
            shown = {k: res["summary"][k] for k in (
                "det_recall", "det_precision", "instance_dice")}
        else:
            if "det@0.5_top500" not in res:
                raise AssertionError(f"h5 {task}: metrics {res}")
            shown = {k: res[k] for k in ("det@0.5_top500",
                                         "mean_coord_error")}
        phase("h5", f"{task} with keras231_tiny.h5 weights: "
              f"{time.perf_counter() - t:.2f}s, {json.dumps(shown)} (no "
              f"floor: random weights), kernel launches {evals[task]}")
    return {"adaptive": adaptive, "forward": forward, **evals}


def held_to(got: dict, ref: dict, label: str) -> dict:
    """A bundle's outputs (numpy) against in-process inference (tensors):
    detections_valid equal, boxes within SERVE_BOX_TOL, masks within
    KERNEL_TOL * max|ref|, everything finite. Returns the errors."""
    valid = ref["detections_valid"].cpu().numpy()
    if not np.array_equal(got["detections_valid"], valid):
        raise AssertionError(f"{label}: detections_valid differ: "
                             f"{got['detections_valid'].sum(1)} vs "
                             f"{valid.sum(1)}")
    box = np.abs(got["detections"][..., :6] - ref["detections"][..., :6]
                 .float().cpu().numpy()).max()
    mref = ref["mrcnn_masks"].float().cpu().numpy()
    mask = np.abs(got["mrcnn_masks"] - mref).max()
    if not all(np.isfinite(got[k]).all() for k in got):
        raise AssertionError(f"{label}: non-finite outputs")
    if box > SERVE_BOX_TOL or mask > KERNEL_TOL * np.abs(mref).max():
        raise AssertionError(f"{label}: box err {box} (tol {SERVE_BOX_TOL})"
                             f", mask err {mask} (tol {KERNEL_TOL} * "
                             f"{np.abs(mref).max()})")
    return {"box_err": float(box), "mask_err": float(mask)}


def serve_run(smi: str, cfg, model, image, meta_b, anchors, gt_boxes, ref,
              ref_m, dev, errs: dict) -> dict:
    """m3d_torch.serve at the bench configuration: (a) an adaptive bundle
    (default chunks) at B = 4, exported, loaded from its own files and held
    to in-process adaptive inference ``ref`` (recall >= RECALL_FLOOR, #1
    launched by predict); (b) a monolithic bundle (chunks 0: #2, #3, #4)
    held to ``MaskRCNN.forward``'s ``ref_m``; (c) export_bucketed at B = 1
    over SERVE_SHAPES and four segment_volume requests, two per bucket, each
    label volume held to the in-process postprocess of the padded volume,
    whose #1 calls (the bucket shapes at B = 1) are held to the plain
    version, their errors added to ``errs``; (d) one call of each bundle's
    graph and of its in-process twin under ``host_profile``. Returns each
    path's kernel launches, timings and profiles."""
    from m3d_torch import serve
    from m3d_torch.anchors import (bucket_image_shape,
                                   normalized_pyramid_anchors)
    from m3d_torch.image_meta import compose_image_meta
    from m3d_torch.models.inference import adaptive_inference, default_chunks
    from m3d_torch.utils.metrics import detection_recall
    from m3d_torch.utils.unmold import (instances_to_label_volume,
                                        postprocess_detections)

    state = model.state_dict()
    image_np, meta_np = image.cpu().numpy(), meta_b.cpu().numpy()
    res = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="m3d_serve_") as tmp:
        for name, conf, want in (
                ("adaptive", cfg, ("roialign_compact",)),
                ("monolithic", cfg.replace(CLASSIFIER_CHUNK=0, MASK_CHUNK=0),
                 ("roialign_fc (kron)", "roialign_padded",
                  "roialign_slab"))):
            out_dir = os.path.join(tmp, name)
            shared = name == "monolithic"
            t = time.perf_counter()
            manifest = serve.export_bundle(
                conf, state, out_dir, batch=BATCH, device=dev,
                weights_file=(os.path.join("..", "adaptive",
                                           "weights.msgpack")
                              if shared else None))
            export_s = time.perf_counter() - t
            graph_bytes = os.path.getsize(os.path.join(out_dir,
                                                       "graph.pt2"))
            t = time.perf_counter()
            bundle = serve.ServingBundle.load(
                out_dir, variables=state if shared else None, device=dev)
            load_s = time.perf_counter() - t
            reset_counts()
            t = time.perf_counter()
            got = bundle.predict(image_np, meta_np)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t
            launches = launch_counts()
            missing = [k for k in want if launches[k] < 1]
            if missing or (shared and launches["roialign_compact"]) or (
                    not shared and any(launches[k] for k in launches
                                       if k not in want)):
                raise AssertionError(f"serve {name} bundle: kernel launches "
                                     f"{launches}, wanted {want}")
            held = held_to(got, ref_m if shared else ref,
                           f"serve {name} bundle")
            n_gt, n_match, n_det = detection_recall(
                got["detections"], got["detections_valid"], gt_boxes, SIZE)
            recall = n_match / n_gt if n_gt else 0.0
            if recall < RECALL_FLOOR:
                raise AssertionError(f"serve {name} bundle: recall "
                                     f"{recall:.4f} < {RECALL_FLOOR}")
            bundle.run(image, meta_b)
            graph_ms = cuda_ms(lambda: bundle.run(image, meta_b), 3)
            if shared:
                def eager():
                    return model(image, meta_b, anchors)
            else:
                chunks = default_chunks(model)

                def eager():
                    return adaptive_inference(
                        model, image, meta_b, anchors,
                        classifier_chunk=chunks[0], mask_chunk=chunks[1],
                        device=dev)
            inproc_ms = cuda_ms(eager, 3)
            # Where the graph's time over the eager one goes: host reads,
            # host dispatch per op, the device's idle time.
            # A measurement only: a profiler that fails is reported, and
            # fails no check.
            prof = {}
            for key, fn in (("graph", lambda: bundle.run(image, meta_b)),
                            ("in_process", eager)):
                try:
                    prof[key] = host_profile(fn)
                except Exception as exc:  # noqa: BLE001
                    prof[key] = {"error": repr(exc)}
            wall = []
            for _ in range(3):
                t = time.perf_counter()
                bundle.predict(image_np, meta_np)
                wall.append((time.perf_counter() - t) * 1e3)
            res[name] = {"export_s": export_s, "load_s": load_s,
                         "first_predict_s": first_s,
                         "graph_pt2_bytes": graph_bytes,
                         "graph_ms": graph_ms, "in_process_ms": inproc_ms,
                         "predict_wall_ms": wall, "recall": recall,
                         "profile": prof, **held}
            res["launches"][f"serve {name} bundle"] = launches
            phase("serve", f"{name} bundle (chunks {manifest['chunks']}, "
                  f"B={BATCH}): export {export_s:.2f}s, graph.pt2 "
                  f"{graph_bytes} bytes, load {load_s:.2f}s, first predict "
                  f"{first_s:.2f}s; graph {graph_ms:.2f} ms vs in-process "
                  f"{inproc_ms:.2f} ms (CUDA events, mean of 3), predict "
                  f"with host copies {[round(w, 2) for w in wall]} ms; "
                  f"recall {recall:.4f} ({n_match}/{n_gt}, {n_det} "
                  f"detections), box err {held['box_err']:.3e}, mask err "
                  f"{held['mask_err']:.3e}; kernel launches {launches}")
            phase("serve", f"{name} bundle, one call under torch.profiler: "
                  f"{json.dumps(prof)}")
            del bundle, got

        out_dir = os.path.join(tmp, "router")
        t = time.perf_counter()
        rman = serve.export_bucketed(cfg, state, out_dir, SERVE_SHAPES,
                                     batch=1, device=dev)
        export_s = time.perf_counter() - t
        router = serve.ServingRouter.load(out_dir, device=dev)
        chunks = default_chunks(model)
        requests = []
        reset_counts()
        for i in range(4):
            vol = image_np[i % len(image_np), ..., 0]
            if i >= 2:
                vol = vol[tuple(slice(0, n) for n in SERVE_SHAPES[1])]
            t = time.perf_counter()
            seg = router.segment_volume(vol, image_id=i)
            torch.cuda.synchronize()
            requests.append(((time.perf_counter() - t) * 1e3, vol, seg))
        launches = launch_counts()
        if launches["roialign_compact"] < 1:
            raise AssertionError(f"serve router: kernel launches {launches}")
        res["launches"]["serve router (4 requests)"] = launches
        shown = []
        for i, (ms, vol, seg) in enumerate(requests):
            shape = bucket_image_shape(vol.shape)
            padded = np.pad(vol, [(0, b - n) for b, n in zip(shape,
                                                             vol.shape)])
            meta = compose_image_meta(i, (*vol.shape, 1), (*shape, 1),
                                      (0, 0, 0, *vol.shape), 1.0,
                                      [1] * cfg.NUM_CLASSES)
            bucket_anchors = torch.as_tensor(normalized_pyramid_anchors(
                cfg, image_shape=(*shape, 1)), device=dev)
            spy = Spy()
            try:
                ref_out = adaptive_inference(
                    model, padded[None, ..., None], meta[None],
                    bucket_anchors, classifier_chunk=chunks[0],
                    mask_chunk=chunks[1], device=dev)
            finally:
                spy.restore()
            rows = [a for a in spy.calls["roialign_compact"]
                    if a[0].shape[0]]
            if not rows:
                raise AssertionError(f"serve router request {i}: the "
                                     f"in-process twin launched no #1")
            for args in rows:
                errs["roialign_compact"].append(compare(
                    args, f"serve router request {i}, bucket {shape}, "
                    f"B = 1"))
            _, _, scores, masks = postprocess_detections(
                ref_out["detections"][0].float().cpu().numpy(),
                ref_out["mrcnn_masks"][0].float().cpu().numpy(),
                padded_shape=shape, original_shape=vol.shape,
                min_confidence=float(cfg.DETECTION_MIN_CONFIDENCE),
                min_roi_size=float(cfg.MIN_ROI_SIZE),
                nms_threshold=float(cfg.DETECTION_NMS_THRESHOLD),
                max_instances=int(cfg.DETECTION_MAX_INSTANCES))
            labels = instances_to_label_volume(masks, scores)
            differ = float((labels != seg["label_volume"]).mean())
            if seg["label_volume"].shape != vol.shape or \
                    len(scores) != len(seg["scores"]) or \
                    differ > SERVE_LABEL_TOL:
                raise AssertionError(
                    f"serve router request {i}: {len(seg['scores'])} "
                    f"instances vs {len(scores)} in process, "
                    f"{differ:.2e} of the labels differ")
            shown.append({"shape": list(vol.shape), "bucket": list(shape),
                          "ms": ms, "instances": len(seg["scores"]),
                          "labels_differ": differ})
        res["router"] = {"export_s": export_s, "requests": shown}
        phase("serve", f"router over {sorted(rman['buckets'])} (B=1, chunks "
              f"{chunks}): export {export_s:.2f}s; requests "
              f"{json.dumps(shown)} (the first of each bucket loads it); "
              f"kernel launches {launches}")
    print(f"[{smi}] serve: " + json.dumps(
        {k: v for k, v in res.items() if k != "launches"}), flush=True)
    return res


def mrcnn_first_steps(config, dev, mesh, save: str | None = None) -> dict:
    """Two MRCNN_TRAINING steps set up as MrcnnTrainer.train sets them up
    (the 80/20 split, the generator, the optimiser, the targets'
    generator), each rank on its rows of the generator's batches of
    ``mesh``. Saves the parameters after the first step to ``save`` (CPU
    tensors). Returns the first step's loss, both steps' ms (CUDA events;
    the first includes cuDNN's first calls) and the host ms to take each
    batch (every rank assembles the whole batch and keeps its rows)."""
    from m3d_torch.data.datasets import ToyDataset
    from m3d_torch.data.generators import MrcnnGenerator, to_device
    from m3d_torch.models.mask_rcnn import MaskRCNN
    from m3d_torch.parallel.mesh import shard_batch
    from m3d_torch.train.mrcnn import MrcnnTrainer

    trainer = MrcnnTrainer(config, device=dev, mesh=mesh)
    model = MaskRCNN.from_config(config, mode="training", device=dev).eval()
    trainer.model = model
    full = ToyDataset()
    full.load_dataset(config.DATA_DIR, is_train=True,
                      class_names=tuple(config.CLASS_NAMES))
    full.prepare()
    full = full.filter_positive()
    seed = int(getattr(config, "SEED", 0))
    ids = np.random.RandomState(seed).permutation(len(full.image_info))
    train_ds = full.subset(ids[max(1, int(0.2 * len(ids))):])
    it = iter(MrcnnGenerator(train_ds, config, mode="training", seed=seed))
    opt = trainer.prepare_train(model)
    step = trainer.make_train_step(model, opt, torch.Generator(
        dev).manual_seed(seed + 7))
    out = {"step_ms": [], "host_ms": []}
    for i in range(2):
        t = time.perf_counter()   # every rank assembles the whole batch
        batch = to_device(shard_batch(mesh, next(it)), dev)
        out["host_ms"].append((time.perf_counter() - t) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        met = step(batch)
        ev[1].record()
        ev[1].synchronize()
        out["step_ms"].append(ev[0].elapsed_time(ev[1]))
        if i == 0:
            out["loss"] = met["loss"]
            if save:
                torch.save({k: v.detach().cpu() for k, v in
                            model.state_dict().items()}, save)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def parallel_rank(rank: int, spec: dict) -> dict:
    """One of PAR_RANKS gloo ranks sharing cuda:0: the MRCNN step of a
    global batch of PAR_RANKS on a data mesh, spatial_extract_features and
    make_spatial_inference of the bench volumes on a (1, PAR_RANKS) mesh
    (halo bytes counted), and dryrun_step on one; every kernel call held to
    its plain version (Spy), the launches counted over these runs only."""
    from m3d_torch.checkpoints import (load_params, params_from_jax,
                                       restore_by_name)
    from m3d_torch.config import load_config
    from m3d_torch.models.mask_rcnn import MaskRCNN
    from m3d_torch.parallel import mesh as M
    from m3d_torch.parallel import spatial as S
    from m3d_torch.parallel.dryrun import dryrun_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    devices = [dev] * PAR_RANKS
    res = {"rank": rank}
    real_halo, halo_bytes = S.halo, [0]

    def counted_halo(x, axis, lo, hi, fill=0.0):
        halo_bytes[0] += (lo + hi) * x[:, :1].numel() * x.element_size() \
            * axis.size
        return real_halo(x, axis, lo, hi, fill)

    model = MaskRCNN.from_config(bench_config(), mode="inference",
                                 device=dev).eval()
    restore_by_name(model, params_from_jax(load_params(spec["ckpt"])[0]))
    image = torch.as_tensor(spec["image"], device=dev)
    meta = torch.as_tensor(spec["meta"], device=dev)
    anchors = torch.as_tensor(spec["anchors"], device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spy = Spy()
    S.halo = counted_halo
    try:
        res["mrcnn"] = mrcnn_first_steps(
            load_config(spec["mrcnn_dp"]), dev, M.make_mesh(devices=devices),
            spec["mrcnn_save"] if rank == 0 else None)
        m12 = S.make_mesh_2d(1, PAR_RANKS, devices)
        layout = {}
        with torch.no_grad():
            feats = S.spatial_extract_features(model, image, m12,
                                               layout=layout)
            halo_bytes[0] = 0
            res["trunk_ms"] = cuda_ms(
                lambda: S.spatial_extract_features(model, image, m12), 2)
            res["halo_bytes"] = halo_bytes[0] // 2
        res["layout"] = layout
        res["pyramid_sums"] = [float(f.double().sum()) for f in feats]
        if rank == 0:
            torch.save([f.cpu() for f in feats], spec["pyramid_save"])
        del feats
        out = S.make_spatial_inference(model, m12)(image, meta, anchors)
        res["infer"] = {k: v.float().cpu().numpy() for k, v in out.items()
                        if k in ("detections", "detections_valid",
                                 "mrcnn_masks")}
        del out
        res["dryrun"] = dryrun_step(PAR_RANKS, S.make_mesh_2d(
            1, PAR_RANKS, devices), dev)
        torch.cuda.synchronize()
    finally:
        S.halo = real_halo
        spy.restore()
    res["launches"] = launch_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["errs"] = {}
    for key, name, check in EVAL_CHECKS:
        for i, args in enumerate(spy.calls[name]):
            res["errs"].setdefault(key, []).append(check(
                args, f"parallel rank {rank} captured {name} call {i}"))
    return res


def update_gap(got: dict, ref: dict, src: dict) -> dict:
    """How far ``got`` lies from ``ref``, relative to ``ref``'s own update
    from ``src``: ||got - ref|| / ||ref - src|| over the float leaves of
    each group (resnet, fpn, rpn, heads) and of all of them."""
    num: dict = {}
    den: dict = {}
    for k, r in ref.items():
        if not r.is_floating_point() or k not in src:
            continue
        g = {"resnet": "resnet", "fpn": "fpn", "rpn": "rpn"}.get(
            k.split(".")[0], "heads")
        r = r.double().cpu()
        for key in (g, "all"):
            num[key] = num.get(key, 0.0) + float(
                ((got[k].double().cpu() - r) ** 2).sum())
            den[key] = den.get(key, 0.0) + float(
                ((r - src[k].double().cpu()) ** 2).sum())
    return {k: (num[k] / den[k]) ** 0.5 if den[k] else 0.0 for k in num}


def parallel_nccl_run(here: str, tmp: str) -> dict:
    """MRCNN_TRAINING as the mrcnn_train phase ran it (run A), once more in
    this process (run B: the plain path's own spread, from cuDNN's
    nondeterministic backward and the ROI samples it flips), and through
    ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    m3d_torch`` (run C: one rank that joins the NCCL group torchrun sets
    up and takes the distributed path). C's latest.msgpack must lie within
    PAR_EPOCH_TOL of A's update (``update_gap``, all leaves); B's gap is
    printed beside it."""
    from m3d_torch import __main__ as cli
    from m3d_torch.checkpoints import load_params, params_from_jax

    def config(name):
        out = os.path.join(tmp, f"out_{name}")
        return write_config(os.path.join(tmp, "mrcnn.json"),
                            os.path.join(tmp, f"{name}.json"),
                            OUTPUT_DIR=out,
                            WEIGHT_DIR=os.path.join(out, "weights"))

    def latest(name):
        return params_from_jax(load_params(os.path.join(
            tmp, f"out_{name}", "weights", "latest.msgpack"))[0])

    t = time.perf_counter()
    cli.main(["--task", "MRCNN_TRAINING", "--config_path",
              config("mrcnn_again")])
    again_s = time.perf_counter() - t
    t = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "m3d_torch", "--task",
         "MRCNN_TRAINING", "--config_path", config("mrcnn_nccl")], cwd=here,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    if run.returncode:
        raise AssertionError(f"parallel nccl: exit {run.returncode}\n"
                             f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    epoch = [ln for ln in run.stdout.splitlines() if "[MRCNN][epoch" in ln]
    src = params_from_jax(load_params(os.path.join(here, CHECKPOINT))[0])
    ref = params_from_jax(load_params(os.path.join(
        tmp, "out_mrcnn", "weights", "latest.msgpack"))[0])
    gap_c = update_gap(latest("mrcnn_nccl"), ref, src)
    gap_b = update_gap(latest("mrcnn_again"), ref, src)
    phase("parallel", f"NCCL world size 1 (torchrun) MRCNN_TRAINING epoch "
          f"{wall:.2f}s: {epoch}; latest.msgpack's gap to the mrcnn_train "
          f"phase's update {json.dumps(gap_c)} (tol {PAR_EPOCH_TOL}); the "
          f"same in-process run again ({again_s:.2f}s): "
          f"{json.dumps(gap_b)}")
    if gap_c["all"] > PAR_EPOCH_TOL:
        raise AssertionError(f"parallel nccl: update gap {gap_c['all']} > "
                             f"{PAR_EPOCH_TOL}")
    return {"wall_s": wall, "gap": gap_c, "gap_same_path": gap_b}


def parallel_run(here: str, tmp: str, smi: str, cfg, model, image, meta_b,
                 anchors, gt_boxes, ref_m, dev, errs: dict) -> dict:
    """The gloo twin: PAR_RANKS ranks sharing cuda:0 (NCCL refuses two
    ranks on one device; gloo stages CUDA tensors through the host, so the
    ranks' collective times are gloo's host copies, not NVLink's), each
    computation held to one process on the card; then a data_parallel=2
    monolithic bundle over cuda:0 twice. Returns the timings, the ranks'
    launch counts and the bundle's."""
    from m3d_torch import serve
    from m3d_torch.config import load_config
    from m3d_torch.parallel.dryrun import dryrun_step
    from m3d_torch.parallel.mesh import make_mesh, spawn
    from m3d_torch.utils.metrics import detection_recall

    t0 = time.perf_counter()
    src = os.path.join(tmp, "mrcnn.json")
    spec = {"ckpt": os.path.join(here, CHECKPOINT),
            "image": image.cpu().numpy(), "meta": meta_b.cpu().numpy(),
            "anchors": anchors.cpu().numpy(),
            "mrcnn_dp": write_config(src, os.path.join(tmp, "mrcnn_dp.json"),
                                     IMAGES_PER_GPU=1, GPU_COUNT=PAR_RANKS),
            "mrcnn_save": os.path.join(tmp, "par_mrcnn.pt"),
            "pyramid_save": os.path.join(tmp, "par_pyramid.pt")}
    t = time.perf_counter()
    ranks = spawn(parallel_rank, PAR_RANKS, [dev] * PAR_RANKS, "gloo",
                  args=(spec,), run_dir=tmp, timeout=900)
    ranks_s = time.perf_counter() - t
    for r in ranks:
        for key, e in r["errs"].items():
            errs[key].extend(e)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    missing = [k for k in ("roialign_fc (kron)", "roialign_padded",
                           "roialign_slab") if launches[k] < 1]
    if missing:
        raise AssertionError(f"parallel: kernels {missing} not launched in "
                             f"the ranks: {launches}")
    phase("parallel", f"{PAR_RANKS} gloo ranks on cuda:0 in {ranks_s:.2f}s;"
          f" kernel launches {launches}, each held to its plain version")

    # The MRCNN step against one process on the whole batch.
    ref = mrcnn_first_steps(load_config(src), dev, make_mesh(),
                            os.path.join(tmp, "one_mrcnn.pt"))
    got_loss = ranks[0]["mrcnn"]["loss"]
    if {r["mrcnn"]["loss"] for r in ranks} != {got_loss} or abs(
            got_loss - ref["loss"]) > PAR_LOSS_TOL * abs(ref["loss"]):
        raise AssertionError(f"parallel mrcnn step: losses "
                             f"{[r['mrcnn']['loss'] for r in ranks]} vs one "
                             f"process {ref['loss']}")
    from m3d_torch.checkpoints import load_params, params_from_jax

    start = params_from_jax(load_params(os.path.join(here, CHECKPOINT))[0])
    one = torch.load(os.path.join(tmp, "one_mrcnn.pt"))
    gap = update_gap(torch.load(spec["mrcnn_save"]), one, start)
    # The one-process step again: its own spread (cuDNN's backward).
    mrcnn_first_steps(load_config(src), dev, make_mesh(),
                      os.path.join(tmp, "one_mrcnn_again.pt"))
    same = update_gap(torch.load(os.path.join(tmp, "one_mrcnn_again.pt")),
                      one, start)
    if gap["all"] > PAR_STEP_TOL:
        raise AssertionError(f"parallel mrcnn step: update gap {gap}")
    phase("parallel", f"MRCNN step, global batch {PAR_RANKS}: loss "
          f"{got_loss:.6f} vs one process {ref['loss']:.6f}; the "
          f"parameters' gap to one process's update {json.dumps(gap)} "
          f"(tol {PAR_STEP_TOL}), one process again {json.dumps(same)}; "
          f"host ms a batch 1 rank {ref['host_ms']} / {PAR_RANKS} ranks "
          f"{[r['mrcnn']['host_ms'] for r in ranks]}; step "
          f"ms (first, second) 1 rank {ref['step_ms']} / {PAR_RANKS} ranks "
          f"{[r['mrcnn']['step_ms'] for r in ranks]}")

    # The Y-sharded pyramid against extract_features.
    with torch.no_grad():
        want = model.extract_features(image)
        trunk_one_ms = cuda_ms(lambda: model.extract_features(image), 2)
    got = torch.load(spec["pyramid_save"])
    pyr_err = []
    for lvl, (g, w) in enumerate(zip(got, want)):
        if any(r["pyramid_sums"][lvl] != ranks[0]["pyramid_sums"][lvl]
               for r in ranks):
            raise AssertionError(f"parallel: P{lvl + 2} differs between "
                                 f"ranks")
        pyr_err.append(check_close(g.to(dev), w, f"parallel pyramid "
                                   f"P{lvl + 2} (Y over {PAR_RANKS})"))
    phase("parallel", f"spatial trunk: layout {ranks[0]['layout']}, "
          f"{PAR_RANKS} ranks {[r['trunk_ms'] for r in ranks]} ms vs one "
          f"process {trunk_one_ms:.2f} ms; halo bytes gathered per rank "
          f"{ranks[0]['halo_bytes']}")

    # Spatial inference against the monolithic graph.
    inf = ranks[0]["infer"]
    det, valid = inf["detections"], inf["detections_valid"] > 0.5
    det_m = ref_m["detections"].float().cpu().numpy()
    valid_m = ref_m["detections_valid"].cpu().numpy()
    n_gt, n_match, n_det = detection_recall(det, valid, gt_boxes, SIZE)
    same = matched_detections(det_m, valid_m, det, valid)
    recall = n_match / n_gt if n_gt else 0.0
    if recall < RECALL_FLOOR or same < PAR_MATCH * valid_m.sum() or \
            not np.isfinite(inf["mrcnn_masks"]).all():
        raise AssertionError(f"parallel spatial inference: recall {recall}, "
                             f"{same} of {valid_m.sum()} monolithic "
                             f"detections matched")
    phase("parallel", f"spatial inference: recall {recall:.4f}, {n_det} "
          f"detections, {same} matching the monolithic graph's "
          f"{int(valid_m.sum())} at IoU>=0.5")

    # The dryrun step against its one-rank run.
    one = dryrun_step(PAR_RANKS, None, dev)
    dry = ranks[0]["dryrun"]
    if abs(dry["loss"] - one["loss"]) > PAR_LOSS_TOL * abs(one["loss"]):
        raise AssertionError(f"parallel dryrun: loss {dry['loss']} vs one "
                             f"rank {one['loss']}")
    phase("parallel", f"dryrun_multichip({PAR_RANKS}) step on (1, "
          f"{PAR_RANKS}): loss {dry['loss']:.6f} vs one rank "
          f"{one['loss']:.6f}")

    # A data_parallel=2 monolithic bundle, cuda:0 twice.
    state = model.state_dict()
    mono = cfg.replace(CLASSIFIER_CHUNK=0, MASK_CHUNK=0)
    with tempfile.TemporaryDirectory(prefix="m3d_dp_", dir=tmp) as d:
        t = time.perf_counter()
        man = serve.export_bundle(mono, state, d, batch=BATCH, device=dev,
                                  data_parallel=PAR_RANKS,
                                  devices=[dev] * PAR_RANKS)
        export_s = time.perf_counter() - t
        bundle = serve.ServingBundle.load(d, variables=state, device=dev,
                                          devices=[dev] * PAR_RANKS)
        reset_counts()
        got = bundle.predict(image.cpu().numpy(), meta_b.cpu().numpy())
        torch.cuda.synchronize()
        dp_launches = launch_counts()
        graph_ms = cuda_ms(lambda: bundle.run(image, meta_b), 2)
    # Each slice's in-process twin under the Spy: every #2, #3 and #4 call
    # at the slice's B is held to its plain version.
    half = BATCH // PAR_RANKS
    held = []
    for i in range(PAR_RANKS):
        rows = slice(i * half, (i + 1) * half)
        reset_counts()
        spy = Spy()
        try:
            with torch.no_grad():
                want = model(image[rows], meta_b[rows], anchors)
        finally:
            spy.restore()
        for key, name, check in EVAL_CHECKS:
            for j, args in enumerate(spy.calls[name]):
                errs[key].append(check(
                    args, f"data_parallel={PAR_RANKS} bundle slice {i}'s "
                    f"twin (B = {half}) captured {name} call {j}"))
        if not all(spy.calls[n] for n in ("roialign_fc", "roialign_padded",
                                          "roialign_slab")):
            raise AssertionError(f"data_parallel={PAR_RANKS} bundle slice "
                                 f"{i}'s twin did not call #2, #3 and #4")
        held.append(held_to({k: v[rows] for k, v in got.items()}, want,
                            f"data_parallel={PAR_RANKS} bundle, slice {i}"))
    phase("parallel", f"data_parallel={PAR_RANKS} bundle (manifest "
          f"data_parallel {man['data_parallel']}, chunks {man['chunks']}): "
          f"export {export_s:.2f}s, predict {graph_ms:.2f} ms, launches "
          f"{dp_launches}; each slice held to MaskRCNN.forward on it "
          f"{held}")
    wall = time.perf_counter() - t0
    peak = [r["peak_gib"] for r in ranks]
    print(f"[{smi}] parallel: " + json.dumps({
        "mrcnn_step_ms_1_rank": ref["step_ms"],
        "mrcnn_step_ms_per_rank": [r["mrcnn"]["step_ms"] for r in ranks],
        "mrcnn_host_ms_1_rank": ref["host_ms"],
        "mrcnn_host_ms_per_rank": [r["mrcnn"]["host_ms"] for r in ranks],
        "spatial_trunk_ms_per_rank": [r["trunk_ms"] for r in ranks],
        "trunk_ms_1_process": trunk_one_ms,
        "halo_bytes_per_rank": ranks[0]["halo_bytes"],
        "peak_gib_per_rank": peak, "ranks_s": ranks_s,
        "data_parallel_predict_ms": graph_ms, "wall_s": wall}), flush=True)
    return {"launches": launches, "dp_launches": dp_launches,
            "wall_s": wall, "peak_gib": peak, "pyramid_err": pyr_err}


def nms_check(dev) -> None:
    """nms_3d on NMS_N proposal-like boxes (above FIXPOINT_MAX_N, so the
    blockwise branch) against the numpy oracle: the kept indices must be
    equal. Prints both times."""
    from m3d_torch.data.synthetic import proposal_like_boxes
    from m3d_torch.ops.nms3d import FIXPOINT_MAX_N, nms_3d, nms_3d_numpy

    if NMS_N <= FIXPOINT_MAX_N:
        raise AssertionError("the nms check must exceed FIXPOINT_MAX_N")
    rng = np.random.RandomState(7)
    boxes = proposal_like_boxes(rng, NMS_N)
    scores = rng.uniform(size=NMS_N).astype(np.float32)
    tb = torch.from_numpy(boxes[None]).to(dev)
    ts = torch.from_numpy(scores[None]).to(dev)
    nms_3d(tb, ts, NMS_THR, NMS_K)
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx, ok = nms_3d(tb, ts, NMS_THR, NMS_K)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    want = nms_3d_numpy(boxes, scores, NMS_THR, NMS_K)
    oracle_s = time.perf_counter() - t
    kept = idx[0][ok[0]].cpu().numpy()
    if not np.array_equal(kept, want):
        raise AssertionError(f"nms: {len(kept)} kept on the card, oracle "
                             f"{len(want)}; first difference at "
                             f"{int(np.argmax(kept[:len(want)] != want[:len(kept)]))}")
    phase("nms", f"N={NMS_N} (> FIXPOINT_MAX_N={FIXPOINT_MAX_N}: blockwise) "
          f"threshold {NMS_THR} max_output {NMS_K}: kept {len(kept)}, equal "
          f"to the numpy oracle; {card_ms:.2f} ms on the card (host wall, "
          f"host syncs included), oracle {oracle_s:.2f} s on the host")


def host_cpu() -> str:
    """The host CPU's model name (lscpu, else /proc/cpuinfo) and
    architecture."""
    import platform

    names = []
    lscpu = shutil.which("lscpu")
    if lscpu:
        out = subprocess.run([lscpu], capture_output=True, text=True).stdout
        names = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                 if ln.startswith(("Model name", "Vendor ID"))]
    if not names and os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            names = [ln.split(":", 1)[1].strip() for ln in f
                     if ln.startswith(("model name", "Hardware"))][:1]
    return f"{' / '.join(names) or 'model unknown'} ({platform.machine()})"


def load_bench_model(here: str, dev):
    """The bench configuration's MaskRCNN on ``dev`` with the tracked
    checkpoint; fails if a tensor is missing. Returns (cfg, model)."""
    from m3d_torch.checkpoints import (load_params, params_from_jax,
                                       restore_by_name)
    from m3d_torch.models.mask_rcnn import MaskRCNN

    t = time.perf_counter()
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
    return cfg, model


def wall_ms(fn, reps: int, devices) -> float:
    """Mean host-wall ms of ``fn()`` over ``reps`` runs, every device in
    ``devices`` synchronised before and after (CUDA events on one card
    would miss the others' work)."""
    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    sync()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t) * 1e3 / reps


def dp_cards_main(n: int) -> int:
    """``--dp-cards N`` (module docstring)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke --dp-cards {n}: needs {n} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor

    from m3d_torch import serve
    from m3d_torch.anchors import normalized_pyramid_anchors
    from m3d_torch.data.synthetic import make_volumes
    from m3d_torch.image_meta import default_meta
    from m3d_torch.ops import roialign_compact as rc
    from m3d_torch.ops import roialign_fc as rf
    from m3d_torch.ops import roialign_slab as rs
    from m3d_torch.ops.cuda_build import build_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    devs = [torch.device("cuda", i) for i in range(n)]
    dev = devs[0]
    build_all((rc.LIB, rf.LIB, rs.LIB))
    here = os.path.dirname(os.path.abspath(__file__))
    cfg, model = load_bench_model(here, dev)
    image, _ = make_volumes(BATCH, SIZE)
    image = torch.as_tensor(image, device=dev)
    meta_b = torch.as_tensor(np.tile(default_meta(cfg)[None], (BATCH, 1)),
                             device=dev)
    anchors = torch.as_tensor(normalized_pyramid_anchors(cfg), device=dev)
    state = model.state_dict()
    mono = cfg.replace(CLASSIFIER_CHUNK=0, MASK_CHUNK=0)
    res = {}
    with tempfile.TemporaryDirectory(prefix="m3d_dpc_") as d:
        serve.export_bundle(mono, state, d, batch=BATCH, device=dev)
        one = serve.ServingBundle.load(d, variables=state, device=dev)
    one.run(image, meta_b)   # warm-up
    res["one_card_ms"] = wall_ms(lambda: one.run(image, meta_b), 5, [dev])
    del one
    with tempfile.TemporaryDirectory(prefix="m3d_dpc_") as d:
        t = time.perf_counter()
        serve.export_bundle(mono, state, d, batch=BATCH, device=dev,
                            data_parallel=n, devices=devs)
        res["export_s"] = time.perf_counter() - t
        t = time.perf_counter()
        bundle = serve.ServingBundle.load(d, variables=state, device=dev,
                                          devices=devs)
        res["load_s"] = time.perf_counter() - t
    got = bundle.predict(image.cpu().numpy(), meta_b.cpu().numpy())
    rows = BATCH // n
    held = []
    for i in range(n):
        s_ = slice(i * rows, (i + 1) * rows)
        with torch.no_grad():
            want = model(image[s_], meta_b[s_], anchors)
        held.append(held_to({k: v[s_] for k, v in got.items()}, want,
                            f"data_parallel={n} bundle, slice {i} on "
                            f"{devs[i]}"))
    phase("dp_cards", f"data_parallel={n} bundle over {n} cards: each slice "
          f"held to MaskRCNN.forward on it {held}")
    res["in_turn_ms"] = wall_ms(lambda: bundle.run(image, meta_b), 5, devs)
    xs = [(image[i * rows:(i + 1) * rows].to(c),
           meta_b[i * rows:(i + 1) * rows].to(c)) for i, c in enumerate(devs)]

    def slice_call(i):
        with torch.no_grad():
            return bundle._calls[i](bundle._states[i], *xs[i])

    with ThreadPoolExecutor(n) as pool:   # the same graphs, a thread each
        res["threads_ms"] = wall_ms(
            lambda: list(pool.map(slice_call, range(n))), 5, devs)
    res["one_slice_ms"] = wall_ms(lambda: slice_call(n - 1), 5, devs)
    res["peak_gib_per_card"] = [torch.cuda.max_memory_allocated(c) / 2**30
                                for c in devs]
    print(f"[{smi[0]}] dp_cards: " + json.dumps(res), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True)
    gxx = gxx.stdout.splitlines()[0] if gxx.returncode == 0 else "absent"
    phase("env", f"g++ {gxx}; host CPU {host_cpu()}, {os.cpu_count()} cores "
          f"({len(os.sched_getaffinity(0))} usable)")
    host_modules = {}
    for mod in ("PIL", "matplotlib", "scipy", "h5py"):
        try:
            __import__(mod)
            host_modules[mod] = "imports"
        except ImportError as e:
            host_modules[mod] = f"absent ({e})"
    phase("env", f"host modules {host_modules}")

    from m3d_torch.anchors import normalized_pyramid_anchors
    from m3d_torch.data.synthetic import make_volumes
    from m3d_torch.image_meta import default_meta
    from m3d_torch.models.inference import adaptive_inference, default_chunks
    from m3d_torch.ops import roialign3d
    from m3d_torch.ops import roialign_compact as rc
    from m3d_torch.ops import roialign_fc as rf
    from m3d_torch.ops import roialign_slab as rs
    from m3d_torch.ops.cuda_build import build_all
    from m3d_torch.utils.metrics import detection_recall

    # build ------------------------------------------------------------
    from m3d_torch import native

    t = time.perf_counter()
    libs = (rc.LIB, rf.LIB, rs.LIB, native.LIB)
    build_all(libs)
    for lib in libs:
        ptxas = " | ".join(ln.strip() for ln in lib.build_log.splitlines()
                           if "registers" in ln or "spill" in ln)
        how = (f"built in {lib.build_seconds:.2f}s" if lib.build_seconds
               else "cached")
        phase("build", f"{lib.name}: {how} {ptxas}")
    phase("build", f"{time.perf_counter() - t:.2f}s for all four (three "
          f"kernel libraries, the native host library)")

    # load -------------------------------------------------------------
    here = os.path.dirname(os.path.abspath(__file__))
    cfg, model = load_bench_model(here, dev)

    # kernel: random batches at the bench shapes -------------------------
    meta_b = torch.as_tensor(np.tile(default_meta(cfg)[None], (BATCH, 1)),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    m, p = cfg.MASK_POOL_SIZE, cfg.POOL_SIZE
    shapes = cfg.backbone_shapes()[:4]
    fms = [torch.randn(BATCH, *map(int, s), cfg.TOP_DOWN_PYRAMID_SIZE,
                       generator=gen, device=dev).to(torch.bfloat16)
           for s in shapes]
    n_rows = BATCH * cfg.DETECTION_MAX_INSTANCES
    errs = {k: [] for k in REPLACES}
    for total in (0, 1, 37, n_rows):
        args = random_compact_batch(fms, n_rows, total, m, gen)
        errs["roialign_compact"].append(
            compare(args, f"compact random total={total}"))
    levels, _, _, pos, _ = random_compact_batch(fms, n_rows, n_rows, m, gen)
    errs["roialign_padded"].append(compare_padded(
        (levels, pos, fms, cfg.DETECTION_MAX_INSTANCES), "padded random"))
    n_cls = BATCH * cfg.POST_NMS_ROIS_INFERENCE
    conv1 = model.classifier.mrcnn_class_conv1
    wk = rf.conv1_weight_fk(conv1.weight, torch.bfloat16)
    for bounds in ((0, 0), (0, 1), (0, n_cls), (700, 600)):
        args = random_slab_batch(fms, n_cls, p, gen, (99, 99, 99), bounds)
        errs["roialign_slab"].append(
            compare_slab(args, f"slab random bounds={bounds}"))
        args = random_slab_batch(fms, n_cls, p, gen, (16, 16, 24), bounds)
        errs["roialign_fc (kron)"].append(compare_fc(
            args[:7] + [wk, args[7]], f"fc random bounds={bounds}"))
    # The slab kernel's general path: dense random weights (more than two
    # taps a sample), for every row and for every third row.
    for rows in (None, slice(0, None, 3)):
        args = random_slab_batch(fms, n_cls, p, gen, (99, 99, 99),
                                 (0, n_cls))
        args[3:6] = [dense_random(w, gen, rows) for w in args[3:6]]
        what = "every row" if rows is None else "every third row"
        errs["roialign_slab"].append(compare_slab(
            args, f"slab dense random weights on {what} (general path)"))
        phase("kernel", f"slab dense random weights on {what}: "
              f"{cuda_ms(lambda: rs.roialign_slab(*args), 2):.3f} ms")
    errs["roialign_slab"].append(tiered_check(fms, meta_b, p, gen))
    del fms, args

    # nms: the blockwise branch at the hela configs' candidate count ----
    nms_check(dev)

    # adaptive ---------------------------------------------------------
    image, gt_boxes = make_volumes(BATCH, SIZE)
    anchors = torch.as_tensor(normalized_pyramid_anchors(cfg), device=dev)
    image = torch.as_tensor(image, device=dev)
    cls_chunk, mask_chunk = default_chunks(model)

    def run():
        return adaptive_inference(model, image, meta_b, anchors,
                                  classifier_chunk=cls_chunk,
                                  mask_chunk=mask_chunk)

    spy = Spy()
    chunks_seen = []
    model.classify_rois_flat = lambda *a: (
        chunks_seen.append(a), type(model).classify_rois_flat(model, *a))[1]
    t = time.perf_counter()
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    launches = {"roialign_compact": rc.KERNEL.launches}
    spy.restore()
    del model.classify_rois_flat
    captured = spy.calls["roialign_compact"]
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
    n_launch = launches["roialign_compact"]
    if n_launch != 2 or len(captured) != n_launch:   # classifier, mask
        raise AssertionError(f"adaptive kernel launches={n_launch}")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall {recall:.4f} < {RECALL_FLOOR}")

    # captured: the adaptive path's own kernel inputs --------------------
    errs["roialign_compact"].append(compare(
        captured[0], "captured classifier-stage inputs"))
    args = captured[-1]
    errs["roialign_compact"].append(compare(args,
                                            "captured mask-stage inputs"))

    # monolithic ---------------------------------------------------------
    spy = Spy()
    t = time.perf_counter()
    reset_counts()
    out_m = model(image, meta_b, anchors)
    torch.cuda.synchronize()
    for key, lc in (("roialign_fc (kron)", rf.KERNEL),
                    ("roialign_padded", rc.PADDED),
                    ("roialign_slab", rs.KERNEL)):
        launches[key] = lc.launches
    # Kernel 5 has no caller on the main path: its TPU entry's function is
    # the kron entry's, served by the same launch, counted once above.
    launches["roialign_fc (separable)"] = 0
    spy.restore()
    first_m = time.perf_counter() - t
    det_m = out_m["detections"].float().cpu().numpy()
    valid_m = out_m["detections_valid"].cpu().numpy()
    masks_m = out_m["mrcnn_masks"]
    n_gt, n_match_m, n_det_m = detection_recall(det_m, valid_m, gt_boxes,
                                                SIZE)
    recall_m = n_match_m / n_gt if n_gt else 0.0
    same = matched_detections(det, valid, det_m, valid_m)
    phase("monolithic", f"first call {first_m:.2f}s gt_objects={n_gt} "
          f"detections={n_det_m} matched={n_match_m} "
          f"recall={recall_m:.4f} "
          f"detections/image={valid_m.sum(1).tolist()} "
          f"matching an adaptive detection at IoU>=0.5: {same} of "
          f"{n_det_m} (adaptive had {n_det}) kernel launches={launches}")
    if tuple(masks_m.shape) != want or not torch.isfinite(masks_m).all() \
            or not np.isfinite(det_m).all() \
            or not torch.isfinite(out_m["mrcnn_probs"]).all():
        raise AssertionError(f"bad monolithic outputs: masks "
                             f"{tuple(masks_m.shape)}")
    if float(masks_m.min()) < 0 or float(masks_m.max()) > 1:
        raise AssertionError("monolithic mask probabilities outside [0, 1]")
    for key, name in (("roialign_fc (kron)", "roialign_fc"),
                      ("roialign_padded", "roialign_padded"),
                      ("roialign_slab", "roialign_slab")):
        if launches[key] < 1 or len(spy.calls[name]) != launches[key]:
            raise AssertionError(f"monolithic {key} launches="
                                 f"{launches[key]}")
    if recall_m < RECALL_FLOOR:
        raise AssertionError(f"monolithic recall {recall_m:.4f} < "
                             f"{RECALL_FLOOR}")

    # captured: the monolithic path's own kernel inputs ------------------
    args_fc = spy.calls["roialign_fc"][0]
    args_pad = spy.calls["roialign_padded"][0]
    args_slab_main = spy.calls["roialign_slab"][0]
    errs["roialign_fc (kron)"].append(compare_fc(
        args_fc, "captured classifier inputs (fused)"))
    errs["roialign_slab"].append(compare_slab(
        args_slab_main, "captured classifier inputs (fallback rows)"))
    errs["roialign_padded"].append(compare_padded(
        args_pad, "captured mask-stage inputs (padded)"))
    # Forced fallback: a small fc_slab_cap sends most rows through the
    # slab kernel, and the split must give the default split's result.
    with torch.no_grad():
        feats = model.extract_features(image.float())
        _, probs, deltas = model.rpn_forward(list(feats))
        props, _ = model.propose(probs, deltas, anchors)
        feats = list(feats[:4])
        default = roialign3d.pyramid_roi_align_fc(
            props, meta_b, feats, p, conv1.weight, kernel="kron")
        spy = Spy()
        forced = roialign3d.pyramid_roi_align_fc(
            props, meta_b, feats, p, conv1.weight, fc_slab_cap=FORCED_CAP,
            kernel="separable")
        spy.restore()
    args_slab = spy.calls["roialign_slab"][0]
    args_fc_forced = spy.calls["roialign_fc"][0]
    n_fit = int(args_fc_forced[-1][1])
    if int(args_slab[-1][1]) < 1:
        raise AssertionError("forced fallback: no row took the slab kernel")
    errs["roialign_slab"].append(compare_slab(
        args_slab, f"forced fallback {FORCED_CAP} (slab rows)"))
    errs["roialign_fc (separable)"].append(compare_fc(
        args_fc_forced, f"forced fallback {FORCED_CAP} (fused rows)"))
    check_close(forced, default, f"forced fallback split (n_fit={n_fit} of "
                f"{forced.shape[0] * forced.shape[1]}) vs default split")
    # The adaptive classifier's first chunk, as the fused entry would take
    # it: slab inputs with bounds (0, n_fit), as _roi_align_fc_flat_core
    # makes them. Its launches here are checks, not the main path's.
    boxes_c, batch_c, meta_c, feats_c = chunks_seen[0]
    boxes_c, batch_c = boxes_c[:cls_chunk], batch_c[:cls_chunk]
    spy = Spy()
    with torch.no_grad():
        roialign3d.pyramid_roi_align_fc_flat(boxes_c, batch_c, meta_c,
                                             feats_c, p, conv1.weight)
    spy.restore()
    args_fc_chunk = spy.calls["roialign_fc"][0]
    errs[CHUNK_FC].append(compare_fc(
        args_fc_chunk, f"adaptive classifier chunk ({boxes_c.shape[0]} rows)"))
    launches[CHUNK_FC] = 0

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
    mono = lambda: model(image, meta_b, anchors)  # noqa: E731
    mono()
    step_m = cuda_ms(mono, reps)
    vols_m = BATCH / (step_m / 1e3)
    stages = stage_ms(model, image, meta_b, anchors, (cls_chunk, mask_chunk))
    stages_m = monolithic_stage_ms(model, image, meta_b, anchors)
    phase("time", f"adaptive {vols:.4f} vol/s ({step_ms:.2f} ms per batch of "
          f"{BATCH}, CUDA events; host wall {[round(w, 4) for w in wall]} s); "
          f"stages ms {stages}")
    phase("time", f"monolithic {vols_m:.4f} vol/s ({step_m:.2f} ms per "
          f"batch of {BATCH}, CUDA events); stages ms {stages_m}")

    # The classifier stage's parts besides the fused kernel: the slab
    # kernel on the path's own fallback rows, and the fallback conv3d_fc,
    # which runs over every row as in JAX.
    from m3d_torch.ops.conv3d import conv3d_fc

    slab_main_ms = cuda_ms(lambda: rs.roialign_slab(*args_slab_main), 20)
    slab_main_bound = slab_bound(args_slab_main)
    slab_main_lib = grid_sample_call(slab_rows_in_bounds(args_slab_main))
    slab_main_lib()
    slab_main_lib_ms = cuda_ms(slab_main_lib, 10)
    pooled = rs.roialign_slab(*args_slab_main)
    fb_ms = cuda_ms(lambda: conv3d_fc(pooled, conv1.weight,
                                      out_dtype=torch.float32), 5)
    del pooled
    phase("time", f"monolithic classifier parts: slab kernel on the path's "
          f"{int(args_slab_main[-1][1])} fallback rows {slab_main_ms:.4f} ms "
          f"(bound {slab_main_bound[0]:.4f} ms, {slab_main_bound[2]}; "
          f"library {slab_main_lib_ms:.4f} ms); "
          f"fallback conv3d_fc over all {args_slab_main[0].shape[0]} rows "
          f"(float32) {fb_ms:.4f} ms")

    every_row = torch.tensor(boxes_c.shape[0], dtype=torch.int32, device=dev)

    def compact_conv1():
        pooled = roialign3d.pyramid_roi_align_compact(
            boxes_c, batch_c, every_row, meta_c, feats_c, p)
        return model.classifier.conv1_as_matmul(pooled)

    with torch.no_grad():
        compact_conv1()
        chunk_ms = cuda_ms(compact_conv1, 10)
    phase("time", f"adaptive classifier chunk ({boxes_c.shape[0]} rows, "
          f"{int(args_fc_chunk[-1][1])} fit the fused slab): compact kernel "
          f"+ conv1 (the adaptive path's route) {chunk_ms:.4f} ms; the fused "
          f"kernel on the same rows is '{CHUNK_FC}' below")

    levels, bat, total, pos, fms_main = args
    pad_levels, pad_pos, pad_fms, pad_n = args_pad
    n_pad = pad_pos.shape[0]
    pad_bat = torch.div(torch.arange(n_pad, device=dev, dtype=torch.int32),
                        pad_n, rounding_mode="floor")
    pad_total = torch.tensor(n_pad, dtype=torch.int32, device=dev)
    pad_as_compact = (pad_levels, pad_bat, pad_total, pad_pos, pad_fms)
    timed = {
        # name: (kernel, plain, library, bound (ms, by), kernel reps)
        "roialign_compact": (
            lambda: rc.roialign_compact(*args),
            lambda: rc.roialign_compact_plain(levels, bat, total, pos,
                                              fms_main),
            grid_sample_call(args), kernel_bound_ms(args), 50),
        "roialign_fc (kron)": (
            lambda: rf.roialign_fc(*args_fc),
            lambda: rf.roialign_fc_plain(*args_fc),
            fc_library_call(args_fc), slab_bound(args_fc, fc=True), 20),
        "roialign_padded": (
            lambda: rc.roialign_padded(*args_pad),
            lambda: rc.roialign_compact_plain(*pad_as_compact),
            grid_sample_call(pad_as_compact),
            kernel_bound_ms(pad_as_compact), 50),
        "roialign_slab": (
            lambda: rs.roialign_slab(*args_slab),
            lambda: rs.roialign_slab_plain(*args_slab),
            grid_sample_call(slab_rows_in_bounds(args_slab)),
            slab_bound(args_slab), 20),
        # kernel 5 on its own call's inputs: the forced-fallback split,
        # run with kernel="separable"
        "roialign_fc (separable)": (
            lambda: rf.roialign_fc(*args_fc_forced),
            lambda: rf.roialign_fc_plain(*args_fc_forced),
            fc_library_call(args_fc_forced),
            slab_bound(args_fc_forced, fc=True), 20),
        CHUNK_FC: (
            lambda: rf.roialign_fc(*args_fc_chunk),
            lambda: rf.roialign_fc_plain(*args_fc_chunk),
            fc_library_call(args_fc_chunk),
            slab_bound(args_fc_chunk, fc=True), 20),
    }
    sources = {"roialign_compact": "m3d_torch/csrc/roialign_compact.cu",
               "roialign_fc (kron)": "m3d_torch/csrc/roialign_fc.cu",
               "roialign_padded": "m3d_torch/csrc/roialign_compact.cu",
               "roialign_slab": "m3d_torch/csrc/roialign_slab.cu",
               "roialign_fc (separable)": "m3d_torch/csrc/roialign_fc.cu",
               CHUNK_FC: "m3d_torch/csrc/roialign_fc.cu"}
    kernels = []
    for name, (kern, plain, library, (bound_ms, bound_by, unit), kreps) in \
            timed.items():
        kern()
        plain()
        library()
        kernel_ms = cuda_ms(kern, kreps)
        plain_ms = cuda_ms(plain, 2)
        library_ms = cuda_ms(library, 10)
        kernel_ms_2 = cuda_ms(kern, kreps)
        phase("time", f"{name}: kernel {kernel_ms:.4f} / {kernel_ms_2:.4f} "
              f"ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {unit}), launches "
              f"{launches[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(errs[name]), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
        if name == "roialign_fc (separable)":
            kernels[-1]["same_launch_as"] = "roialign_fc (kron)"
        if name == "roialign_slab":  # timed above on the forced fallback
            kernels[-1]["main_path"] = {
                "rows": int(args_slab_main[-1][1]), "ms": slab_main_ms,
                "bound_ms": slab_main_bound[0],
                "library_ms": slab_main_lib_ms}
        if name == CHUNK_FC:
            kernels[-1]["timing_only"] = (
                "roialign_fc on the adaptive classifier's first chunk; the "
                "adaptive path runs the compact kernel there")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{smi}] peak memory {peak:.2f} GiB", flush=True)

    # serve: bundles exported, loaded and served on the card -------------
    serve_res = serve_run(smi, cfg, model, image, meta_b, anchors, gt_boxes,
                          out, out_m, dev, errs)

    # eval / rpn_eval: the evaluation tasks through the port's CLI --------
    from m3d_torch.data.synthetic import generate_experiment, split_dataset

    with tempfile.TemporaryDirectory(prefix="m3d_eval_") as tmp:
        t = time.perf_counter()
        generate_experiment(EVAL_IMAGES, SIZE, os.path.join(tmp, "data"),
                            seed=EVAL_SEED)
        split_dataset(os.path.join(tmp, "data"), test_ratio=1.0)
        phase("eval", f"dataset of {EVAL_IMAGES} volumes {SIZE}^3 written "
              f"in {time.perf_counter() - t:.2f}s")
        eval_launch, eval_sum = eval_run(here, tmp, "adaptive", smi, errs)
        mono_launch, mono_sum = eval_run(here, tmp, "monolithic", smi, errs,
                                         CLASSIFIER_CHUNK=0, MASK_CHUNK=0)
        rpn_launch = rpn_eval_run(here, tmp, smi)

        # rpn_train / e2e_train / train_eval / e2e_fit: the training tasks
        t = time.perf_counter()
        generate_experiment(TRAIN_IMAGES, SIZE,
                            os.path.join(tmp, "train_data"), seed=TRAIN_SEED)
        split_dataset(os.path.join(tmp, "train_data"),
                      test_ratio=TRAIN_TEST_RATIO)
        phase("rpn_train", f"dataset of {TRAIN_IMAGES} volumes {SIZE}^3 "
              f"written in {time.perf_counter() - t:.2f}s")
        native_res = native_run(here, tmp, smi)
        rpn_train = rpn_train_run(here, tmp, smi)
        autotune = autotune_run(here, tmp, smi)
        e2e_train, best, e2e_launch = e2e_train_run(here, tmp, smi, errs)
        train_eval_launch, _ = eval_run(
            here, tmp, "train_eval", smi, errs, HEAD_WEIGHTS=best)
        e2e_fit = e2e_fit_run(here, tmp, smi)

        # targeting / head_train / mrcnn_train / train_bn: the rest of the
        # training surface
        target, root, target_launch = targeting_run(here, tmp, smi, errs)
        head, head_best, head_launch = head_train_run(here, tmp, smi, root)
        head_eval_launch, _ = eval_run(here, tmp, "head_eval", smi, errs,
                                       HEAD_WEIGHTS=head_best)
        mrcnn, mrcnn_best, mrcnn_launch = mrcnn_train_run(here, tmp, smi,
                                                          errs)
        mrcnn_eval_launch, _ = eval_run(here, tmp, "mrcnn_eval", smi, errs,
                                        HEAD_WEIGHTS=mrcnn_best)
        # parallel: NCCL at world size 1, then two gloo ranks on cuda:0
        nccl = parallel_nccl_run(here, tmp)
        par = parallel_run(here, tmp, smi, cfg, model, image, meta_b,
                           anchors, gt_boxes, out_m, dev, errs)
        train_bn, bn_launch = train_bn_run(here, tmp, smi)
        h5_launch = h5_run(here, tmp, smi, errs, dev)
        print(f"[{smi}] training steps: " + json.dumps({
            "rpn_train": {k: rpn_train[k] for k in (
                "step_ms_median_after_first", "host_ms_median_after_first",
                "peak_gib", "wall_s")},
            "e2e_train": {k: e2e_train[k] for k in (
                "step_ms_median_after_first", "host_ms_median_after_first",
                "peak_gib", "wall_s")},
            "e2e_fit": {k: e2e_fit[k] for k in (
                "step_ms_median_after_first", "peak_gib")},
            "targeting": {k: target[k] for k in (
                "seconds_per_image", "bytes_written", "peak_gib", "wall_s")},
            **{name: {k: run[k] for k in (
                "step_ms_median_after_first", "host_ms_median_after_first",
                "device_idle_share", "peak_gib", "wall_s")} for name, run in (
                ("autotune", autotune),
                ("head_train", head), ("mrcnn_train", mrcnn),
                ("train_bn rpn", train_bn["rpn"]),
                ("train_bn mrcnn", train_bn["mrcnn"]))},
            "rpn_split_ms": rpn_train["split"],
            "e2e_split_ms": e2e_fit["split"],
            "parallel": {"nccl_wall_s": nccl["wall_s"],
                         "gloo_wall_s": par["wall_s"],
                         "peak_gib_per_rank": par["peak_gib"]},
            "mrcnn_split_ms": mrcnn["split"],
            "mrcnn_gather_ms": mrcnn["gather"],
            "native_host_split_ms": native_res["host_split_ms"],
            "head_npz_load_ms": head["npz_load_ms"]}), flush=True)
    # The two graphs compute the same function: equal detection counts,
    # pixel metrics and dice within EVAL_METRIC_TOL (bf16 order only).
    for key in ("det_tp", "det_fp", "det_fn"):
        if eval_sum[key] != mono_sum[key]:
            raise AssertionError(f"eval runs disagree on {key}: "
                                 f"{eval_sum[key]} vs {mono_sum[key]}")
    for key in ("pixel_precision", "pixel_recall", "pixel_f1", "pixel_iou",
                "instance_dice"):
        if abs(eval_sum[key] - mono_sum[key]) > EVAL_METRIC_TOL:
            raise AssertionError(f"eval runs disagree on {key}: "
                                 f"{eval_sum[key]} vs {mono_sum[key]}")
    phase("eval", f"both runs agree: det_tp/fp/fn equal, pixel metrics and "
          f"instance_dice within {EVAL_METRIC_TOL}")
    for key, n in (("adaptive", eval_launch["roialign_compact"]),
                   ("monolithic", mono_launch["roialign_fc (kron)"]),
                   ("monolithic", mono_launch["roialign_padded"]),
                   ("head_eval", head_eval_launch["roialign_compact"]),
                   ("mrcnn_eval", mrcnn_eval_launch["roialign_compact"])):
        if n < 1:
            raise AssertionError(f"eval {key}: a kernel of its path was not "
                                 f"launched: {eval_launch} {mono_launch}")
    for k in kernels:
        name = k["name"]
        k["max_abs_err"] = max(errs[name])  # the later phases' checks too
        k["eval_launches"] = {
            "eval": eval_launch.get(name, 0),
            "eval (CLASSIFIER_CHUNK 0, MASK_CHUNK 0)": mono_launch.get(
                name, 0),
            "rpn_eval": rpn_launch.get(name, 0),
            "e2e_train": e2e_launch.get(name, 0),
            "train_eval": train_eval_launch.get(name, 0),
            "targeting": target_launch.get(name, 0),
            "head_train": head_launch.get(name, 0),
            "head_eval": head_eval_launch.get(name, 0),
            "mrcnn_train": mrcnn_launch.get(name, 0),
            "mrcnn_eval": mrcnn_eval_launch.get(name, 0),
            "train_bn": bn_launch.get(name, 0),
            "parallel": par["launches"].get(name, 0),
            "parallel data_parallel bundle": par["dp_launches"].get(name, 0),
            "autotune": autotune["launches"].get(name, 0),
            **{f"h5 {key}": n.get(name, 0) for key, n in h5_launch.items()},
            **{key: n.get(name, 0)
               for key, n in serve_res["launches"].items()}}
        if name == "roialign_padded":   # its calls on the training paths
            k["e2e_train_shapes"] = e2e_train["padded"]
            k["targeting_shapes"] = target["padded"]
            k["mrcnn_validation_shapes"] = mrcnn["padded"]
            k["mrcnn_train_step_gather"] = mrcnn["gather"]

    print(json.dumps({"kernels": kernels}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-cards"]:
        sys.exit(dp_cards_main(int(sys.argv[2])))
    sys.exit(main())
