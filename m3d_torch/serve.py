"""Serving bundles (port of m3d/serve.py): export -> load -> predict.

    python -m m3d_torch.serve --config_path CONFIG --weights W --out DIR
                              [--batch 1] [--device {cuda,cpu}]

A serving host loads a bundle and calls the traced inference graph without
the model-building code, the config plumbing or a trace step. The graph is
``torch.export``'s ``ExportedProgram`` of ``_inference_fn``'s ``infer``,
written with ``torch.export.save``. Its inputs are the model's state dict
(parameters and BatchNorm statistics: weights stay ARGUMENTS, as in JAX, so
the graph is small and weights swap without re-export), ``image [B, H, W,
D, C]`` and ``image_meta [B, META]``; the anchors are a constant baked into
it. The ROIAlign kernels are ``torch.library`` ops (``m3d_torch::
roialign_*``), so the graph calls them by name: importing this module
registers them. A bundle is a directory:

    graph.pt2        the ExportedProgram
    weights.msgpack  the weights, flax msgpack (``checkpoints.save_params``:
                     the format JAX's ``load_params`` also reads)
    manifest.json    config snapshot, input shapes, chunk sizes, platforms,
                     torch version

A graph is traced on one device type and runs there: ``platforms`` is
``["cuda"]``, or ``["cpu"]`` when the caller asks for the CPU (the kernels'
plain versions). Export and load run on the card unless the caller asks
for the CPU; with no card they raise. The traced graph reads every live
count on the device where the eager one reads it on the host
(a ``cond`` per ROI chunk, ``while_loop`` NMS), so its outputs equal
in-process inference bit for bit on the CPU.

``data_parallel`` n > 1 (JAX's sharded export): the batch is split over n
devices, each running the graph on its slice with its own copy of the
weights (devices that repeat share one), and the outputs are concatenated
in order: JAX's mesh sharding of the batch axis with the weights
replicated. Each device gets its own copy of the graph (moved from the card
it was traced on). Unlike JAX's sharded call, the slices run one after
another from the calling thread (the graph is bound by its host dispatch;
``python3 chip_smoke.py --dp-cards N`` times it). The graph is traced at
batch / n and is monolithic unless the config names chunk sizes
(``chunks_from_config(auto=False)``, as JAX's). The manifest records n; a
batch that n does not divide, and fewer devices than n, raise, naming both
numbers.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Any

import numpy as np
import torch

from m3d_torch.anchors import bucket_image_shape, normalized_pyramid_anchors
from m3d_torch.checkpoints import (load_params, params_from_jax,
                                   params_to_jax, save_params)
from m3d_torch.config import Config
from m3d_torch.image_meta import compose_image_meta
from m3d_torch.models.inference import adaptive_inference, chunks_from_config
from m3d_torch.models.mask_rcnn import MaskRCNN
from m3d_torch.ops import roialign_compact, roialign_fc, roialign_slab  # noqa: F401  (registers the ops)
from m3d_torch.utils.unmold import (instances_to_label_volume,
                                    postprocess_detections)

__all__ = ["export_bundle", "export_bucketed", "ServingBundle",
           "ServingRouter", "main"]

BUNDLE_FORMAT = "m3d-torch-serving-bundle-v1"
ROUTER_FORMAT = "m3d-torch-serving-router-v1"
OUTPUT_KEYS = ["detections", "detections_valid", "mrcnn_masks", "mrcnn_probs",
               "mrcnn_bbox", "proposals", "proposals_valid"]


def _device(device) -> torch.device:
    """The device asked for; the card unless the caller names the CPU, and
    an error (never a quiet fall back to the CPU) where there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving on cuda: torch.cuda.is_available() is "
                           "False; pass device='cpu' to serve on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no serving route for device {dev}")
    return dev


def _devices(n: int, device, devices=None) -> list[torch.device]:
    """The ``n`` devices of a data-parallel bundle: ``devices`` when given,
    else cuda:0 .. cuda:n-1 (or the CPU n times); fewer than n raise."""
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cuda":
            have = torch.cuda.device_count()
            devices = [torch.device("cuda", i) for i in range(min(n, have))]
        else:
            devices = [dev] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"bundle was exported data_parallel={n}; only "
                         f"{len(devices)} devices available")
    return devices[:n]


def _inference_fn(config, monolithic_default: bool = False,
                  image_shape=None, device="cuda"):
    """Build (infer, chunks): infer(state, image, image_meta) -> dict.

    ``state`` is the model's state dict; the model itself lives on the meta
    device and ``torch.func.functional_call`` runs it on ``state``, so no
    weight is held here. ``monolithic_default``: no default chunk sizes
    (data-parallel exports), explicit CLASSIFIER_CHUNK / MASK_CHUNK keys
    still win. ``image_shape``: (H, W, D) override of the config's nominal
    shape (bucketed exports); the anchors are computed for it and become a
    constant of the graph."""
    with torch.device("meta"):
        model = MaskRCNN.from_config(config, mode="inference",
                                     device="meta").eval()
    shape = None if image_shape is None else (*image_shape[:3],
                                              config.IMAGE_SHAPE[3])
    anchors = torch.as_tensor(normalized_pyramid_anchors(
        config, image_shape=shape,
        voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0))),
        device=device)
    cls_chunk, mask_chunk = chunks_from_config(config, model,
                                               auto=not monolithic_default)
    runner = _Runner(model, anchors, cls_chunk, mask_chunk)

    def infer(state, image, image_meta):
        return torch.func.functional_call(
            runner, {f"model.{k}": v for k, v in state.items()},
            (image, image_meta), strict=True)

    return infer, (cls_chunk, mask_chunk)


class _Runner(torch.nn.Module):
    """adaptive_inference of ``model`` as a module, for functional_call."""

    def __init__(self, model, anchors, cls_chunk, mask_chunk):
        super().__init__()
        self.model = model
        self.anchors = anchors
        self.chunks = (cls_chunk, mask_chunk)

    def forward(self, image, image_meta):
        return adaptive_inference(
            self.model, image, image_meta, self.anchors,
            classifier_chunk=self.chunks[0], mask_chunk=self.chunks[1],
            device=image.device)


class _Graph(torch.nn.Module):
    """The exported module: no parameters of its own, so the weights are
    inputs of the graph and no copy of them lands in graph.pt2."""

    def __init__(self, infer):
        super().__init__()
        self._infer = [infer]  # a list: not a submodule

    def forward(self, state, image, image_meta):
        return self._infer[0](state, image, image_meta)


def export_program(module: torch.nn.Module, args: tuple):
    """``torch.export.export`` as the bundles use it: without gradients, and
    with every shape static. ``torch.cond`` and ``while_loop`` trace their
    branches with dynamo, which would mark shapes dynamic once one branch
    function is traced at two shapes (the classifier's chunks, then the
    mask head's)."""
    import torch._dynamo

    with torch.no_grad(), torch._dynamo.config.patch(
            automatic_dynamic_shapes=False):
        return torch.export.export(module, args)


def export_bundle(config, variables, out_dir: str, batch: int = 1,
                  device="cuda", data_parallel: int | None = None,
                  image_shape=None, weights_file: str | None = None,
                  devices=None) -> dict[str, Any]:
    """Export a serving bundle for ``config`` and ``variables`` (the model's
    state dict, as ``MaskRCNN.state_dict()`` or ``params_from_jax`` give
    it). Returns the manifest dict.

    ``device``: where the graph is traced and will run (the card unless
    the caller asks for the CPU). ``data_parallel`` n: the bundle splits
    each batch over n devices (``devices``, default the first n of
    ``device``'s type); ``batch`` must divide by n and n devices must
    exist. ``weights_file``: bundle-relative path of an already-written
    weights file to reference instead of writing one (export_bucketed
    shares one copy across buckets).
    """
    n = int(data_parallel or 1)
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by data_parallel {n}")
    dev = _device(device)
    if n > 1:
        _devices(n, dev, devices)
    infer, (cls_chunk, mask_chunk) = _inference_fn(
        config, monolithic_default=n > 1, image_shape=image_shape,
        device=dev)
    if image_shape is None:
        H, W, D, C = (int(v) for v in config.IMAGE_SHAPE)
    else:
        H, W, D = (int(v) for v in image_shape[:3])
        C = int(config.IMAGE_SHAPE[3])
    state = _state_on(variables, dev)
    ncls = int(config.NUM_CLASSES)
    meta = compose_image_meta(0, (H, W, D, C), (H, W, D, C),
                              (0, 0, 0, H, W, D), 1.0, [1] * ncls)
    rows = batch // n   # the graph runs on one device's slice
    example = (state, torch.zeros((rows, H, W, D, C), device=dev),
               torch.as_tensor(np.tile(meta[None], (rows, 1)), device=dev))
    program = export_program(_Graph(infer), example)
    program.example_inputs = None  # the weights: never into graph.pt2
    del state, example

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, "graph.pt2"))
    if weights_file is None:
        weights_file = "weights.msgpack"
        save_params(os.path.join(out_dir, weights_file),
                    params_to_jax(variables), metadata={"kind": "serving"})
    manifest = {
        "format": BUNDLE_FORMAT,
        "config": config.to_dict(),
        "batch": batch,
        "image_shape": [H, W, D, C],
        "meta_size": int(config.IMAGE_META_SIZE),
        "platforms": [dev.type],
        "chunks": {"classifier": cls_chunk, "mask": mask_chunk},
        "weights_file": weights_file,
        "data_parallel": n,
        "torch_version": torch.__version__,
        "output_keys": OUTPUT_KEYS,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _state_on(variables, dev) -> dict[str, torch.Tensor]:
    """The state dict as the graph takes it: float32 tensors on ``dev``,
    keys sorted (the graph's input tree fixes their order)."""
    return {k: torch.as_tensor(variables[k], dtype=torch.float32).to(dev)
            for k in sorted(variables)}


def _program_on(program, dev):
    """A copy of ``program`` (traced on one card) whose constants and
    device arguments are on ``dev``: a data-parallel bundle's graph for
    the slices on ``dev`` (on the CPU, a plain copy)."""
    from torch.export.passes import move_to_device_pass

    cards = {f"cuda:{i}": str(dev) for i in range(torch.cuda.device_count())}
    return move_to_device_pass(copy.deepcopy(program), cards)


def _read_weights(path: str) -> dict[str, torch.Tensor]:
    tree, _ = load_params(path)
    return params_from_jax(tree)


class ServingBundle:
    """Loaded serving bundle: ``predict(image[, image_meta])`` -> dict of
    numpy arrays. The graph runs through ``ExportedProgram.module()``;
    weights are moved to the device once, at load: to each of the
    ``data_parallel`` devices (one copy of the weights and of the graph
    per distinct device)."""

    def __init__(self, program, variables, manifest: dict, device,
                 devices=None):
        self.manifest = manifest
        self.device = torch.device(device)
        self.program = program
        self._call = program.module()
        n = int(manifest.get("data_parallel", 1))
        self.devices = (_devices(n, self.device, devices) if n > 1
                        else [self.device])
        names = [str(d) for d in self.devices]
        states, calls = {}, {}
        for d, name in zip(self.devices, names):
            if name not in states:
                states[name] = _state_on(variables, d)
                calls[name] = (_program_on(program, d).module() if n > 1
                               else self._call)
        self._states = [states[name] for name in names]
        self._calls = [calls[name] for name in names]
        self._state = self._states[0]

    @classmethod
    def load(cls, path: str, variables=None, device="cuda",
             devices=None) -> "ServingBundle":
        """``variables``: a pre-loaded state dict to use instead of reading
        the bundle's weights file (ServingRouter shares one copy across its
        sub-bundles). ``device``: where the graph runs; it must be a device
        type the manifest lists. ``devices``: a ``data_parallel`` n bundle's
        n devices (default: the first n of ``device``'s type; fewer
        raise)."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != BUNDLE_FORMAT:
            raise ValueError(f"not a serving bundle: {path}")
        dev = torch.device(device)
        if dev.type not in manifest["platforms"]:
            raise ValueError(f"bundle {path} was traced for "
                             f"{manifest['platforms']}, not {dev.type}; "
                             f"re-export it with device={dev.type!r}")
        dev = _device(dev)
        program = torch.export.load(os.path.join(path, "graph.pt2"))
        if variables is None:
            wf = manifest.get("weights_file") or "weights.msgpack"
            variables = _read_weights(os.path.normpath(os.path.join(path,
                                                                    wf)))
        return cls(program, variables, manifest, dev, devices)

    def default_meta(self) -> np.ndarray:
        """Meta batch for unpadded volumes of the bundle's exported shape
        (which may be a bucket override of the config's nominal shape)."""
        H, W, D, C = (int(v) for v in self.manifest["image_shape"])
        ncls = int(self.manifest["config"]["NUM_CLASSES"])
        meta = compose_image_meta(0, (H, W, D, C), (H, W, D, C),
                                  (0, 0, 0, H, W, D), 1.0, [1] * ncls)
        return np.tile(meta[None], (int(self.manifest["batch"]), 1))

    def run(self, image: torch.Tensor, image_meta: torch.Tensor) -> dict:
        """The graph on tensors on the bundle's (first) device; returns the
        output tensors there (``predict`` without the host copies). A
        data-parallel bundle runs slice i of the batch on device i and
        concatenates the slices' outputs in order. The slices run one
        after another from this thread: the graph is bound by its host
        dispatch, and a host thread a slice was slower (on four H100s
        617.9-628.9 ms a batch of 4 against 181.1-250.9 in turn)."""
        n = len(self.devices)
        if n == 1:
            with torch.no_grad():
                return self._call(self._state, image, image_meta)
        rows = image.shape[0] // n

        def one(i):
            d, lo = self.devices[i], i * rows
            with torch.no_grad():
                return self._calls[i](self._states[i],
                                      image[lo:lo + rows].to(d),
                                      image_meta[lo:lo + rows].to(d))

        outs = [one(i) for i in range(n)]
        return {k: torch.cat([o[k].to(self.device) for o in outs])
                for k in outs[0]}

    def predict(self, image, image_meta=None) -> dict[str, np.ndarray]:
        image = np.asarray(image, np.float32)
        want = tuple(self.manifest["image_shape"])
        if tuple(image.shape[1:]) != want or \
                image.shape[0] != self.manifest["batch"]:
            raise ValueError(
                f"bundle expects [{self.manifest['batch']}, {want}] images, "
                f"got {image.shape} — exports are shape-frozen; re-export "
                f"for other shapes")
        if image_meta is None:
            image_meta = self.default_meta()
        out = self.run(torch.as_tensor(image, device=self.device),
                       torch.as_tensor(np.asarray(image_meta, np.float32),
                                       device=self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}


def export_bucketed(config, variables, out_dir: str, volume_shapes,
                    batch: int = 1, **export_kw) -> dict[str, Any]:
    """Export one sub-bundle per compile bucket for variable-size serving.

    ``volume_shapes``: raw (H, W, D) volume shapes the service will see.
    Each rounds up to its compile bucket (``bucket_image_shape``) and
    duplicates collapse, so N heterogeneous stacks cost only as many
    exports as there are distinct buckets. Writes ``router.json``, one
    weights file shared by every bucket and one bundle directory per
    bucket; returns the router manifest. Extra kwargs go to export_bundle
    (device, data_parallel, devices).
    """
    buckets = sorted({bucket_image_shape(s) for s in volume_shapes})
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, "weights.msgpack"),
                params_to_jax(variables), metadata={"kind": "serving"})
    entries = {}
    for (h, w, d) in buckets:
        key = f"{h}x{w}x{d}"
        sub = os.path.join(out_dir, f"bucket_{key}")
        export_bundle(config, variables, sub, batch=batch,
                      image_shape=(h, w, d),
                      weights_file=os.path.join("..", "weights.msgpack"),
                      **export_kw)
        entries[key] = os.path.basename(sub)
    router = {
        "format": ROUTER_FORMAT,
        "buckets": entries,
        "batch": batch,
        "num_classes": int(config.NUM_CLASSES),
    }
    with open(os.path.join(out_dir, "router.json"), "w") as f:
        json.dump(router, f, indent=1)
    return router


class ServingRouter:
    """Variable-size serving: route raw volumes to their bucket's bundle.

    ``predict_volume(volume)`` takes ONE raw [H, W, D] or [H, W, D, C]
    volume (already normalized like the training data), zero-pads it up to
    its compile bucket, composes image_meta whose window carries the true
    extent, and runs the bucket's bundle. Sub-bundles load lazily, are
    cached and share one weights copy.
    """

    def __init__(self, path: str, router: dict, device="cuda",
                 devices=None):
        self._path = path
        self.router = router
        self.device = device
        self.devices = devices
        self._bundles: dict[str, ServingBundle] = {}
        self._variables = None

    @classmethod
    def load(cls, path: str, device="cuda", devices=None) -> "ServingRouter":
        """``devices``: as ``ServingBundle.load``'s, for data-parallel
        sub-bundles."""
        with open(os.path.join(path, "router.json")) as f:
            router = json.load(f)
        if router.get("format") != ROUTER_FORMAT:
            raise ValueError(f"not a serving router: {path}")
        return cls(path, router, device, devices)

    def _bundle(self, key: str) -> ServingBundle:
        if key not in self._bundles:
            sub = self.router["buckets"].get(key)
            if sub is None:
                raise ValueError(
                    f"no bundle for bucket {key}; available: "
                    f"{sorted(self.router['buckets'])} — re-run "
                    f"export_bucketed with this shape included")
            if self._variables is None:
                self._variables = _state_on(_read_weights(
                    os.path.join(self._path, "weights.msgpack")),
                    torch.device(self.device))
            self._bundles[key] = ServingBundle.load(
                os.path.join(self._path, sub), variables=self._variables,
                device=self.device, devices=self.devices)
        return self._bundles[key]

    def predict_volume(self, volume, image_id: int = 0):
        """Returns (outputs dict, meta row); the meta carries the true-extent
        window for unmolding. A batch > 1 bundle is filled by tiling the
        volume, and all but slot 0 of its compute is discarded."""
        volume = np.asarray(volume, np.float32)
        if volume.ndim == 3:
            volume = volume[..., None]
        if volume.ndim != 4:
            raise ValueError(f"expected [H,W,D] or [H,W,D,C] volume, "
                             f"got {volume.shape}")
        H, W, D, C = volume.shape
        bh, bw, bd = bucket_image_shape((H, W, D))
        if (bh, bw, bd) != (H, W, D):
            volume = np.pad(
                volume, [(0, bh - H), (0, bw - W), (0, bd - D), (0, 0)])
        bundle = self._bundle(f"{bh}x{bw}x{bd}")
        batch = int(bundle.manifest["batch"])
        meta = compose_image_meta(
            image_id, (H, W, D, C), (bh, bw, bd, C), (0, 0, 0, H, W, D),
            1.0, [1] * int(self.router["num_classes"]))
        out = bundle.predict(
            np.tile(volume[None], (batch, 1, 1, 1, 1)),
            np.tile(meta[None], (batch, 1)))
        return {k: v[:1] for k, v in out.items()}, meta

    def segment_volume(self, volume, image_id: int = 0):
        """Route + predict, then the evaluation loop's unmold / filter
        cascade (``postprocess_detections``) and label-volume painting, with
        the thresholds of the bundle's config snapshot.

        Returns a dict: label_volume [H,W,D] uint16, boxes_px [K,6],
        class_ids [K], scores [K], masks [H,W,D,K] bool.
        """
        out, meta = self.predict_volume(volume, image_id=image_id)
        cfg = Config(**self._bundle(
            f"{int(meta[5])}x{int(meta[6])}x{int(meta[7])}"
        ).manifest["config"])
        boxes_px, class_ids, scores, masks = postprocess_detections(
            out["detections"][0], out["mrcnn_masks"][0],
            padded_shape=meta[5:8], original_shape=meta[1:4],
            min_confidence=float(cfg.DETECTION_MIN_CONFIDENCE),
            min_roi_size=float(cfg.MIN_ROI_SIZE),
            nms_threshold=float(cfg.DETECTION_NMS_THRESHOLD),
            max_instances=int(cfg.DETECTION_MAX_INSTANCES),
        )
        return {
            "label_volume": instances_to_label_volume(masks, scores),
            "boxes_px": boxes_px,
            "class_ids": class_ids,
            "scores": scores,
            "masks": masks,
        }


def main(argv=None) -> dict:
    """Export a checkpoint (flax msgpack or Keras .h5) as a serving bundle
    (the port's scripts/export_serving.py). Returns the manifest."""
    ap = argparse.ArgumentParser(prog="python -m m3d_torch.serve",
                                 description=main.__doc__)
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--weights", required=True, help=".msgpack or Keras .h5")
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the graph is traced and runs (default: the "
                         "card)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="split each batch over n cards (--batch must "
                         "divide by n)")
    args = ap.parse_args(argv)
    _device(args.device)

    from m3d_torch.checkpoints import restore_weights
    from m3d_torch.config import load_config
    from m3d_torch.models.mask_rcnn import init_params

    config = load_config(args.config_path)
    model = MaskRCNN.from_config(config, mode="inference", device="cpu")
    init_params(model, 0)
    stats = restore_weights(model, args.weights)
    print(f"restored weights: {stats}")
    manifest = export_bundle(config, model.state_dict(), args.out,
                             batch=args.batch, device=args.device,
                             data_parallel=args.data_parallel)
    print(f"bundle written to {args.out} (chunks={manifest['chunks']}, "
          f"platforms={manifest['platforms']})")
    return manifest


if __name__ == "__main__":
    main()
