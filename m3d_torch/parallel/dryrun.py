"""One full Mask R-CNN training step over a ``(data, space)`` mesh (port of
``dryrun_multichip`` in __graft_entry__.py).

    python -m m3d_torch.parallel.dryrun N [--device {cuda,cpu}]

The batch is split over ``data`` (one image per data row) and each volume's
Y axis over ``space`` (``n_space`` = 2 when N is even): the trunk runs
through ``spatial_extract_features`` (halo rows at the shard edges, the
pyramid gathered once), then the RPN losses, detection targets, both
ROIAligns, the heads, their losses and the optimiser, at JAX's dryrun
config (64 x 64 x 4 volumes, ResNet-50 with a 32-wide FPN, small ROI
counts). Weights come from ``init_params`` (seed 0) and the batch from
``RandomState(0)``, as JAX's (which fills its weights from its own host
draws: the losses of the two packages differ, each package's sharded step
equals its one-device step). ``dryrun_step(n)`` runs the same step on
the same batch in this process, the reference the sharded run is held
to.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from m3d_torch.config import Config


def dryrun_config() -> Config:
    """__graft_entry__.py:134-149."""
    return Config(
        IMAGE_SIZE=64, IMAGE_DEPTH=4,
        BACKBONE_STRIDES=[(4, 4, 1), (8, 8, 1), (16, 16, 1), (32, 32, 1),
                          (64, 64, 1)],
        RPN_ANCHOR_SCALES=(8, 12, 16, 24, 32),
        RPN_ANCHOR_RATIOS=[0.5, 1.0],
        PRE_NMS_LIMIT=128, POST_NMS_ROIS_TRAINING=16,
        POST_NMS_ROIS_INFERENCE=16,
        DETECTION_MAX_INSTANCES=4,
        TRAIN_ROIS_PER_IMAGE=8,
        TOP_DOWN_PYRAMID_SIZE=32,
        FPN_CLASSIF_FC_LAYERS_SIZE=32, HEAD_CONV_CHANNEL=16,
        POOL_SIZE=7, MASK_POOL_SIZE=7, MASK_SHAPE=[14, 14, 14],
        MAX_GT_INSTANCES=4,
        RPN_TRAIN_ANCHORS_PER_IMAGE=32,
    )


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(n_data, n_space): Y over two ranks when n is even."""
    n_space = 2 if n_devices % 2 == 0 else 1
    return n_devices // n_space, n_space


def dryrun_batch(cfg, anchors, batch: int) -> dict:
    """__graft_entry__.py:196-214: the step's numpy batch."""
    from m3d_torch.image_meta import default_meta

    g = int(cfg.MAX_GT_INSTANCES)
    rng = np.random.RandomState(0)
    return {
        "image": rng.randn(batch, 64, 64, 4, 1).astype(np.float32),
        "image_meta": np.tile(np.asarray(default_meta(cfg))[None],
                              (batch, 1)).astype(np.float32),
        "gt_class_ids": np.ones((batch, g), np.int32),
        "gt_boxes": np.tile(np.asarray([[0.2, 0.2, 0.2, 0.6, 0.6, 0.8]],
                                       np.float32), (batch, g, 1)),
        "gt_masks": np.ones((batch, 64, 64, 4, g), np.float32),
        "rpn_match": rng.choice([-1, 0, 1], size=(batch, anchors.shape[0])
                                ).astype(np.int32),
        "rpn_bbox": rng.randn(batch, int(cfg.RPN_TRAIN_ANCHORS_PER_IMAGE),
                              6).astype(np.float32),
    }


def dryrun_step(n_devices: int, mesh=None, device="cuda") -> dict:
    """The step of an ``n_devices`` mesh on this rank of ``mesh`` (None:
    the whole step in this process): ``MrcnnTrainer``'s loss with the
    Y-sharded trunk in place of the model's. Returns {"loss",
    "param_norm"} (the parameters' norm after the step) and the seconds it
    took."""
    from m3d_torch.models.mask_rcnn import MaskRCNN, init_params
    from m3d_torch.parallel.mesh import scale_loss, shard_batch, sync_grads
    from m3d_torch.parallel.spatial import (make_mesh_2d,
                                            spatial_extract_features)
    from m3d_torch.train.mrcnn import MrcnnTrainer
    from m3d_torch.train.optim import Optimizer

    t0 = time.perf_counter()
    device = torch.device(device)
    cfg = dryrun_config()
    n_data, _ = mesh_shape(n_devices)
    if mesh is None:
        mesh = make_mesh_2d(1, 1)
    trainer = MrcnnTrainer(cfg, device, mesh)
    model = MaskRCNN.from_config(cfg, mode="training", device=device).eval()
    init_params(model, 0)
    opt = Optimizer(cfg, dict(model.named_parameters()))
    batch = {k: torch.as_tensor(v, device=device) for k, v in shard_batch(
        mesh, dryrun_batch(cfg, trainer.anchors, n_data)).items()}
    loss, _ = trainer._outputs(
        model, batch, torch.Generator(device).manual_seed(1), True,
        trunk=lambda image: spatial_extract_features(model, image, mesh))
    scale_loss(mesh, loss).backward()
    sync_grads(mesh, model.parameters())
    opt.step()
    with torch.no_grad():
        norm = torch.sqrt(sum((p.double() ** 2).sum()
                              for p in model.parameters()))
    return {"loss": float(loss.detach()), "param_norm": float(norm),
            "seconds": time.perf_counter() - t0}


def _rank_step(rank: int, n_devices: int, devices):
    from m3d_torch.parallel.spatial import make_mesh_2d

    n_data, n_space = mesh_shape(n_devices)
    mesh = make_mesh_2d(n_data, n_space, devices)
    return dryrun_step(n_devices, mesh, devices[rank])


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One training step over an ``n_devices`` ``(data, space)`` mesh, one
    rank a device (default: cuda:0 .. cuda:n-1). Prints and returns rank
    0's {"loss", "param_norm", "seconds"}."""
    from m3d_torch.parallel.mesh import spawn

    if devices is None:
        devices = [torch.device("cuda", r) for r in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    res = spawn(_rank_step, n_devices, devices, args=(n_devices, devices))[0]
    print(f"[dryrun_multichip] n_devices={n_devices} (mesh "
          f"{mesh_shape(n_devices)}) loss={res['loss']:.6f}", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m m3d_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    devices = None
    if args.device == "cpu":
        devices = ["cpu"] * args.n_devices
    return dryrun_multichip(args.n_devices, devices)


if __name__ == "__main__":
    main()
