"""RPN training, evaluation and head-target generation (port of
``RPNTrainer`` in m3d/train/rpn.py).

The model is built as JAX builds it, with ``mode="training"`` (so
POST_NMS_ROIS_TRAINING sets the proposal count). BatchNorm runs on batch
statistics in the train step under TRAIN_BN, and on its running statistics
everywhere else.

``train``: loss = 1.0 rpn_class + 1.5 rpn_bbox (the reference's fixed
weights, overridable by LOSS_WEIGHTS' ``rpn_*_loss_override``), the
optimiser over every parameter (the heads' only through weight decay, as
in JAX), then per epoch ``rpn_evaluation`` on the test split, which gates
``BestAndLatest`` (maximise the summed detection score), ReduceLROnPlateau,
EarlyStopping and a telemetry snapshot.

GPU_COUNT > 1 (``mesh``, m3d_torch/parallel/mesh.py): each rank takes its
rows of every generator batch, the losses read the outputs of the whole
batch (gathered over ``data``), the gradients are summed over the ranks,
and BatchNorm's batch statistics under TRAIN_BN are the whole batch's; so
every rank makes one process's update. Rank 0 alone evaluates (its
numbers are broadcast, so every rank takes the same gate decisions),
writes checkpoints and telemetry, and runs AUTO_TUNE_RPN.

``head_target_generation`` (TARGET_GENERATION): per image of each split,
the RPN's proposals (no gradient), ``detection_targets_batch`` with
uniforms from a ``torch.Generator`` seeded from SEED, and both ROIAligns
through ``pyramid_roi_align_auto`` (the padded kernel on the card); the
artifacts go to ``head_targets/{train,test}/NNNNNN_{key}.npz`` with JAX's
containers and the manifests to ``head_targets/datasets/{split}.csv``.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time

import numpy as np
import torch

from m3d_torch.anchors import normalized_pyramid_anchors
from m3d_torch.checkpoints import (BestAndLatest, params_to_jax,
                                   restore_weights)
from m3d_torch.data.datasets import ToyDataset
from m3d_torch.data.generators import (RPNGenerator, prefetch_to_device,
                                       to_device)
from m3d_torch.models import losses as L
from m3d_torch.models.detection_targets import detection_targets_batch
from m3d_torch.models.mask_rcnn import MaskRCNN, init_params
from m3d_torch.ops.roialign3d import pyramid_roi_align_auto
from m3d_torch.parallel.mesh import (broadcast_object, make_mesh,
                                     replicate, scale_loss, shard_batch,
                                     sync_grads)
from m3d_torch.train.optim import (EarlyStopping, ReduceLROnPlateau,
                                   Optimizer, get_learning_rate,
                                   set_learning_rate)
from m3d_torch.train.profiling import EpochProfiler, StepClock
from m3d_torch.train.telemetry import Telemetry
from m3d_torch.utils.metrics import rpn_evaluation


EVAL_IMAGES = 8   # test volumes of each epoch's rpn_evaluation, as in JAX


def read_metrics(metrics: dict) -> dict:
    """Scalar tensors -> floats, in one transfer to the host."""
    vals = torch.stack([v.detach().float().reshape(()) for v in
                        metrics.values()]).cpu().tolist()
    return dict(zip(metrics, vals))


class RPNTrainer:
    def __init__(self, config, device="cuda", mesh=None):
        self.config = config
        self._mesh = mesh
        h, w = int(config.IMAGE_SHAPE[0]), int(config.IMAGE_SHAPE[1])
        if h % 64 or w % 64:
            raise ValueError("IMAGE_SHAPE height & width must be multiples of 64")
        self.device = torch.device(device)
        self.model = MaskRCNN.from_config(config, mode="training",
                                          device=self.device).eval()
        self.anchors = normalized_pyramid_anchors(
            config, voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0))
        )
        self.telemetry = Telemetry(config)
        self.clock = StepClock(self.device)
        self.target_times: list[dict] = []

    @property
    def mesh(self):
        """The data-parallel mesh (``make_mesh(config)``), made at first
        use: the evaluation and targeting tasks never shard."""
        if self._mesh is None:
            self._mesh = make_mesh(self.config)
        return self._mesh

    def prepare_datasets(self):
        cfg = self.config
        train = ToyDataset()
        train.load_dataset(cfg.DATA_DIR, is_train=True,
                           class_names=tuple(cfg.CLASS_NAMES))
        train.prepare()
        train = train.filter_positive()
        test = ToyDataset()
        test.load_dataset(cfg.DATA_DIR, is_train=False,
                          class_names=tuple(cfg.CLASS_NAMES))
        test.prepare()
        test = test.filter_positive()
        return train, test

    def init_variables(self):
        """Seeded weights (SEED), then RPN_WEIGHTS restored by name.
        Returns the model."""
        init_params(self.model, int(getattr(self.config, "SEED", 0)))
        weights = getattr(self.config, "RPN_WEIGHTS", None)
        if weights:
            stats = restore_weights(self.model, weights)
            print(f"[RPNTrainer] restored {weights}: {stats}")
        return self.model

    def make_train_step(self, opt):
        """batch (tensors on the device) -> metrics (floats): one forward
        (BatchNorm on batch statistics under TRAIN_BN, which updates the
        running ones), backward and optimiser step."""
        model, lw, mesh = self.model, self.config.LOSS_WEIGHTS, self.mesh
        w_class = float(lw.get("rpn_class_loss_override", 1.0))
        w_bbox = float(lw.get("rpn_bbox_loss_override", 1.5))
        whole = mesh.axis("data").all_gather   # this rank's rows -> batch

        def train_step(batch):
            for p in model.parameters():
                p.grad = None
            model.bn_mode(True, mesh.axis("data"))
            out = model.forward_rpn_train(batch["image"])
            match = whole(batch["rpn_match"])
            lc, mc = L.rpn_class_loss(match, whole(out["rpn_class_logits"]))
            lb, mb = L.rpn_bbox_loss(whole(batch["rpn_bbox"]), match,
                                     whole(out["rpn_bbox"]))
            loss = w_class * lc + w_bbox * lb
            scale_loss(mesh, loss).backward()
            sync_grads(mesh, model.parameters())
            opt.step()
            return read_metrics({**mc, **mb, "loss": loss})

        return train_step

    def make_proposal_fn(self):
        """image [1, H, W, D, C] (numpy) -> (proposals [P, 6] normalized,
        valid [P]) as host numpy arrays."""
        model = self.model
        anchors = torch.as_tensor(self.anchors, device=self.device)

        def predict(image):
            model.bn_mode(False)
            out = model.forward_rpn(
                torch.as_tensor(image, device=self.device), anchors)
            return (out["proposals"][0].float().cpu().numpy(),
                    out["proposals_valid"][0].cpu().numpy())

        return predict

    def train(self):
        """One pass of the generator per epoch (len(gen) steps), the epoch
        evaluation on up to EVAL_IMAGES test volumes. Returns (model,
        history of epoch metrics).

        AUTO_TUNE_RPN first runs ``autotune_rpn`` on the training split
        (printing the patch and writing WEIGHT_DIR/autotune_patch.json);
        with AUTO_TUNE_APPLY the patch is set on the config and the model
        (whose RPN head width follows the ratio count) and the anchors are
        rebuilt before the generator, so RPN_WEIGHTS leaves whose shape
        changed are sliced or skipped, as in JAX."""
        cfg, mesh = self.config, self.mesh
        train_ds, test_ds = self.prepare_datasets()
        if getattr(cfg, "AUTO_TUNE_RPN", False):
            from m3d_torch.train.autotune import autotune_rpn

            patch = broadcast_object(mesh, autotune_rpn(train_ds, cfg)
                                     if mesh.is_main else None)
            if patch and getattr(cfg, "AUTO_TUNE_APPLY", False):
                for k, v in patch.items():
                    setattr(cfg, k, v)
                self.model = MaskRCNN.from_config(
                    cfg, mode="training", device=self.device).eval()
                self.anchors = normalized_pyramid_anchors(
                    cfg,
                    voxel_z_over_y=float(getattr(cfg, "VOXEL_Z_OVER_Y", 1.0)),
                )
                print(f"[AutoTuneRPN] applied patch; anchors rebuilt "
                      f"({self.anchors.shape[0]} anchors)")
        gen = RPNGenerator(train_ds, cfg, mode="training",
                           seed=int(getattr(cfg, "SEED", 0)),
                           telemetry=self.telemetry)
        model = replicate(mesh, self.init_variables())
        params = dict(model.named_parameters())
        opt = Optimizer(cfg, params)
        train_step = self.make_train_step(opt)

        save_dir = cfg.WEIGHT_DIR or os.path.join(cfg.OUTPUT_DIR, "weights")
        ckpt = BestAndLatest(save_dir, mode="max") if mesh.is_main else None
        reduce_lr = ReduceLROnPlateau(mode="max")
        early = EarlyStopping(patience=15, mode="max")
        steps = len(gen)
        it = prefetch_to_device((shard_batch(mesh, b) for b in iter(gen)),
                                self.device,
                                int(getattr(cfg, "PREFETCH_BUFFERS", 2)))
        profiler = EpochProfiler(cfg)
        history = []
        lr = get_learning_rate(opt)
        for epoch in range(int(cfg.FROM_EPOCH), int(cfg.EPOCHS)):
            t0 = time.time()
            profiler.maybe_start(epoch)
            agg: dict[str, list] = {}
            for _ in range(steps):
                metrics = self.clock.run(train_step, self.clock.take(it))
                for k, v in metrics.items():
                    agg.setdefault(k, []).append(v)
            profiler.maybe_stop(epoch)
            epoch_metrics = {k: float(np.mean(v)) for k, v in agg.items()}

            # Proposal quality on the test split; telemetry gets the
            # proposal / GT geometry.
            epoch_metrics.update(broadcast_object(mesh, rpn_evaluation(
                self.make_proposal_fn(), test_ds, cfg, max_images=EVAL_IMAGES,
                telemetry=self.telemetry) if mesh.is_main else None))
            score = epoch_metrics["detection_score"]
            if ckpt is not None:
                ckpt.update(epoch, params_to_jax(model.state_dict()), score,
                            metadata={"kind": "rpn", "epoch": epoch})
            new_lr = reduce_lr.update(score, lr)
            if new_lr != lr:
                lr = new_lr
                set_learning_rate(opt, lr)
            epoch_metrics["lr"] = lr
            if mesh.is_main:
                self.telemetry.snapshot_and_reset(epoch, save_dir,
                                                  extra=epoch_metrics)
            else:
                self.telemetry.reset()
            print(f"[RPN][epoch {epoch}] loss={epoch_metrics['loss']:.4f} "
                  f"det_score={score:.1f} lr={lr:.2e} "
                  f"({time.time() - t0:.1f}s)")
            history.append(epoch_metrics)
            if early.update(score):
                print("[RPN] early stopping")
                break
        return model, history

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _stage(self, times: dict, name: str):
        """Add the seconds of the block to ``times[name]``; on a card the
        device work queued in it is waited for."""
        t = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[name] = times.get(name, 0.0) + time.perf_counter() - t

    def head_target_generation(self, inject_gt=False):
        """Generate and save head-training targets (core/models.py:
        3530-3796). Returns (out_root, {split: manifest path}).

        The output root is DATA_DIR/head_targets when MODE is "targeting",
        else OUTPUT_DIR/head_targets. TARGET_RATIO < 1 targets only the
        leading fraction of each split; images with fewer than
        MIN_POSITIVE_TARGETS positives are skipped. The target sampler
        draws from a ``torch.Generator`` on the device seeded from SEED.
        ``inject_gt=True`` puts the GT boxes in front of the proposals
        (keeping their count), as JAX's option does. ``target_times`` gets
        one dict per targeted image: seconds by stage (forward, targets,
        roialign, write) and the bytes written."""
        cfg = self.config
        model = self.init_variables()
        model.bn_mode(False)
        anchors = torch.as_tensor(self.anchors, device=self.device)
        mask_shape = tuple(int(v) for v in cfg.MASK_SHAPE)
        generator = torch.Generator(self.device).manual_seed(
            int(getattr(cfg, "SEED", 0)))
        out_dir = cfg.DATA_DIR if cfg.MODE == "targeting" else cfg.OUTPUT_DIR
        out_root = os.path.join(out_dir, "head_targets")
        manifests = {}
        self.target_times = []
        for split, is_train in (("train", True), ("test", False)):
            ds = ToyDataset()
            ds.load_dataset(cfg.DATA_DIR, is_train=is_train,
                            class_names=tuple(cfg.CLASS_NAMES))
            ds.prepare()
            ds = ds.filter_positive()
            gen = RPNGenerator(ds, cfg, mode="targeting", shuffle=False)
            n = len(ds.image_info)
            ratio = float(getattr(cfg, "TARGET_RATIO", 1.0))
            if ratio < 1.0:
                total = n
                n = max(1, int(round(ratio * n)))
                print(f"[targeting] {split}: targeting {n}/{total} images "
                      f"(TARGET_RATIO={ratio}); {total - n} skipped")
            split_dir = os.path.join(out_root, split)
            os.makedirs(split_dir, exist_ok=True)
            rows = []
            for image_id in range(n):
                times: dict = {}
                batch = to_device(gen.get_batch([image_id]), self.device)
                with torch.no_grad():
                    with self._stage(times, "forward"):
                        out = model.forward_rpn(batch["image"], anchors)
                        proposals = out["proposals"]
                        if inject_gt:
                            proposals = torch.cat(
                                [batch["gt_boxes"].float(), proposals],
                                dim=1)[:, :proposals.shape[1]]
                    with self._stage(times, "targets"):
                        targets = detection_targets_batch(
                            proposals, batch["gt_class_ids"],
                            batch["gt_boxes"], batch["gt_masks"],
                            cfg.BBOX_STD_DEV, int(cfg.TRAIN_ROIS_PER_IMAGE),
                            float(cfg.ROI_POSITIVE_RATIO),
                            float(cfg.RPN_POSITIVE_IOU),
                            float(cfg.RPN_NEGATIVE_IOU), mask_shape,
                            use_mini_mask=bool(cfg.USE_MINI_MASK),
                            generator=generator)
                    with self._stage(times, "roialign"):
                        feats = list(out["feature_maps"][:4])
                        meta = batch["image_meta"].float()
                        ra, ma = (pyramid_roi_align_auto(
                            targets["rois"], meta, feats, int(q))
                            for q in (cfg.POOL_SIZE, cfg.MASK_POOL_SIZE))
                tci = targets["class_ids"][0].cpu().numpy()
                n_pos = int((tci > 0).sum())
                if n_pos < int(cfg.MIN_POSITIVE_TARGETS):
                    print(f"[targeting][{split}#{image_id}] skipped "
                          f"({n_pos} positives)")
                    continue
                with self._stage(times, "write"):
                    paths = _save_target_npz(
                        split_dir, str(image_id).zfill(6),
                        rois=targets["rois"][0].float().cpu().numpy(),
                        rois_aligned=ra[0].to(torch.float16).cpu().numpy(),
                        mask_aligned=ma[0].to(torch.float16).cpu().numpy(),
                        target_class_ids=tci.astype(np.int32),
                        target_bbox=targets["deltas"][0].float().cpu()
                        .numpy(),
                        target_mask=targets["masks"][0].float().cpu()
                        .numpy())
                times["bytes"] = sum(os.path.getsize(p)
                                     for p in paths.values())
                self.target_times.append(times)
                rows.append(paths)
            man_dir = os.path.join(out_root, "datasets")
            os.makedirs(man_dir, exist_ok=True)
            man_path = os.path.join(man_dir, f"{split}.csv")
            with open(man_path, "w", newline="") as f:
                wr = csv.writer(f)
                wr.writerow(TARGET_KEYS)
                for r in rows:
                    wr.writerow([r[k] for k in TARGET_KEYS])
            manifests[split] = man_path
            print(f"[targeting] {split}: {len(rows)} images -> {man_path}")
        return out_root, manifests


TARGET_KEYS = ("rois", "rois_aligned", "mask_aligned", "target_class_ids",
               "target_bbox", "target_mask")


def _save_target_npz(split_dir, name, **arrays):
    """Write one image's artifacts as JAX does: the masks bit-packed
    (np.packbits of mask > 0.5, with a ``shape`` array beside them) through
    ``savez_compressed``, every other array uncompressed under ``arr`` (the
    float16 aligned features, ~90 MB an image at 128^3, barely compress).
    Returns {key: path}."""
    paths = {}
    for key, arr in arrays.items():
        path = os.path.join(split_dir, f"{name}_{key}.npz")
        if key == "target_mask":
            packed = np.packbits((arr > 0.5).astype(np.uint8))
            np.savez_compressed(path, mask=packed,
                                shape=np.asarray(arr.shape))
        else:
            np.savez(path, arr=arr)
        paths[key] = path
    return paths
