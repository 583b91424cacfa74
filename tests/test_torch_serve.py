"""Serving bundles of the port (m3d_torch/serve.py) at JAX's tiny serving
config (tests/test_serving.py:25-45), float32 on the CPU, with weights from
JAX's init carried over by ``params_from_jax``.

One module fixture makes the three exports: a chunked bundle (B = 2,
CLASSIFIER_CHUNK 16, MASK_CHUNK 4: ``torch.cond`` per chunk, the compact
ROIAlign op) and a router over two buckets (B = 1, monolithic: the padded
and slab ops, the classifier's fallback route at C = 32), whose 64x64x8
sub-bundle is the monolithic bundle. A bundle's ``predict`` equals
in-process inference bit for bit, and JAX's jitted ``m3d.serve.
_inference_fn`` within test_torch_inference.py's tolerances. The traced
forms of the fixpoint NMS, the blockwise NMS and ``chunked_roi_stage``
equal their eager forms bit for bit; every kernel op passes
``torch.library.opcheck`` on its CPU implementation.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from m3d.anchors import normalized_pyramid_anchors
from m3d.image_meta import compose_image_meta, default_meta
from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
from m3d.models.mask_rcnn import init_params as j_init_params
from m3d.serve import _inference_fn as j_inference_fn
from m3d.train.checkpoints import load_params as j_load_params
from m3d_torch import serve
from m3d_torch.checkpoints import params_from_jax, restore_by_name
from m3d_torch.config import Config as TConfig
from m3d_torch.data.synthetic import proposal_like_boxes
from m3d_torch.models import inference as T_inf
from m3d_torch.models.mask_rcnn import MaskRCNN
from m3d_torch.ops import nms3d as TN
from m3d_torch.ops import roialign3d as TR
from m3d_torch.ops import roialign_compact as TC
from m3d_torch.ops import roialign_fc as TF
from m3d_torch.ops import roialign_slab as TS
from m3d_torch.ops.conv3d import conv3d_fc
from m3d_torch.utils.unmold import (instances_to_label_volume,
                                    postprocess_detections)
from test_serving import tiny_config
from test_torch_monolithic import _assert_outputs_match

T = torch.from_numpy
CHUNKS = dict(CLASSIFIER_CHUNK=16, MASK_CHUNK=4)
RAW = (48, 40, 12)  # a raw volume of the second bucket, 64x64x16


def _launches():
    return (TC.KERNEL.launches, TC.PADDED.launches, TF.KERNEL.launches,
            TS.KERNEL.launches)


def _ops_in(program):
    """Names of the m3d_torch ops a loaded graph calls, its subgraphs'
    included."""
    names = set()
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            names |= {str(n.target) for n in gm.graph.nodes
                      if str(n.target).startswith("m3d_torch.")}
    return names


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jcfg = tiny_config()
    jcfg_c = tiny_config()
    for k, v in CHUNKS.items():
        setattr(jcfg_c, k, v)
    tcfg, tcfg_c = TConfig(**jcfg.to_dict()), TConfig(**jcfg_c.to_dict())
    jm = JMaskRCNN.from_config(jcfg, mode="inference")
    variables = jax.device_get(jax.jit(
        lambda key: j_init_params(jm, key))(jax.random.PRNGKey(0)))
    state = params_from_jax(variables)
    tm = MaskRCNN.from_config(tcfg, device="cpu").eval()
    stats = restore_by_name(tm, state)
    assert stats["missing"] == 0 and stats["skipped"] == 0, stats

    root = tmp_path_factory.mktemp("serve")
    chunked_dir = str(root / "chunked")
    router_dir = str(root / "router")
    manifest = serve.export_bundle(tcfg_c, state, chunked_dir, batch=2,
                                   device="cpu")
    router_manifest = serve.export_bucketed(
        tcfg, state, router_dir, volume_shapes=[(64, 64, 8), RAW,
                                                (64, 60, 7)],
        batch=1, device="cpu")
    image = np.random.RandomState(3).randn(2, 64, 64, 8, 1).astype(
        np.float32)
    meta = np.tile(default_meta(jcfg)[None], (2, 1))
    return dict(
        jcfg=jcfg, jcfg_c=jcfg_c, tcfg=tcfg, variables=variables,
        state=state, tm=tm, image=image, meta=meta,
        anchors=normalized_pyramid_anchors(jcfg),
        chunked_dir=chunked_dir, manifest=manifest, router_dir=router_dir,
        router_manifest=router_manifest,
        chunked=serve.ServingBundle.load(chunked_dir, device="cpu"),
        mono=serve.ServingBundle.load(
            os.path.join(router_dir, "bucket_64x64x8"), device="cpu"),
        router=serve.ServingRouter.load(router_dir, device="cpu"))


def _bundle_case(served, which):
    """(bundle, image, meta, chunks) of the chunked (B = 2) or monolithic
    (B = 1) bundle."""
    if which == "chunked":
        return served["chunked"], served["image"], served["meta"], (16, 4)
    return served["mono"], served["image"][:1], served["meta"][:1], \
        (None, None)


def test_manifests_and_artifacts(served):
    """JAX's manifest keys with the port's format, version and platform;
    one weights file per router, in the flax format JAX reads back; no
    weight inside graph.pt2; the kernel ops in the graphs."""
    m = served["manifest"]
    assert m["format"] == "m3d-torch-serving-bundle-v1"
    assert m["platforms"] == ["cpu"] and m["batch"] == 2
    assert m["image_shape"] == [64, 64, 8, 1]
    assert m["chunks"] == {"classifier": 16, "mask": 4}
    assert m["torch_version"] == torch.__version__
    assert m["data_parallel"] == 1 and "jax_version" not in m
    assert m["output_keys"] == serve.OUTPUT_KEYS
    r = served["router_manifest"]
    assert r["format"] == "m3d-torch-serving-router-v1"
    assert sorted(r["buckets"]) == ["64x64x16", "64x64x8"]
    sub = os.path.join(served["router_dir"], "bucket_64x64x16")
    assert not os.path.exists(os.path.join(sub, "weights.msgpack"))
    with open(os.path.join(sub, "manifest.json")) as f:
        sm = json.load(f)
    assert sm["weights_file"] == os.path.join("..", "weights.msgpack")
    assert sm["chunks"] == {"classifier": None, "mask": None}

    tree, _ = j_load_params(os.path.join(served["chunked_dir"],
                                         "weights.msgpack"))
    want = jax.tree_util.tree_leaves_with_path(served["variables"])
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)

    weight_bytes = sum(v.numel() * 4 for v in served["state"].values())
    graph = os.path.join(served["chunked_dir"], "graph.pt2")
    assert os.path.getsize(graph) < weight_bytes / 10
    program = served["chunked"].program
    assert program.state_dict == {} and program.example_inputs is None
    ops = _ops_in(program)
    assert "m3d_torch.roialign_compact.default" in ops
    assert "m3d_torch.roialign_fc.default" not in ops
    # C = 32: the classifier's rows all take the fallback route (§3 b).
    assert _ops_in(served["mono"].program) == {
        "m3d_torch.roialign_slab.default",
        "m3d_torch.roialign_padded.default"}


@pytest.mark.parametrize("which", ["chunked", "monolithic"])
def test_predict_equals_in_process_bit_for_bit(served, which):
    bundle, image, meta, (cls, mask) = _bundle_case(served, which)
    before = _launches()
    got = bundle.predict(image)
    assert _launches() == before              # CPU: the plain versions
    tm, anchors = served["tm"], served["anchors"]
    if which == "chunked":
        ref = T_inf.adaptive_inference(tm, image, meta, anchors,
                                       classifier_chunk=cls, mask_chunk=mask,
                                       device="cpu")
    else:
        ref = tm(T(image), T(meta), T(anchors))
    assert set(got) == set(ref) == set(serve.OUTPUT_KEYS)
    for k in serve.OUTPUT_KEYS:
        assert got[k].dtype == ref[k].numpy().dtype, k
        np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=k)
    assert got["detections_valid"].sum() > 0


@pytest.mark.parametrize("which", ["chunked", "monolithic"])
def test_predict_matches_jax_inference_fn(served, which):
    """The bundle against JAX's jitted serving graph on the same inputs:
    test_torch_inference.py's 1e-4 with its far-border exemption."""
    bundle, image, meta, _ = _bundle_case(served, which)
    cfg = served["jcfg_c"] if which == "chunked" else served["jcfg"]
    infer, chunks = j_inference_fn(cfg)
    assert chunks == tuple(bundle.manifest["chunks"].values())
    ref = jax.device_get(jax.jit(infer)(served["variables"], image, meta))
    got = bundle.predict(image, meta)
    _assert_outputs_match(ref, {k: T(v) for k, v in got.items()})


class _Traced(torch.nn.Module):
    """The traced forms under test, in one graph: the fixpoint NMS on a
    chain that settles and on one past the round cap, the blockwise NMS on
    N above one block with a dead block, and ``chunked_roi_stage`` and
    ``launched_roi_stage`` with the live count an input."""

    def forward(self, chain, chain_scores, boxes, scores, valid, rois, total):
        settled = TN.nms_3d_fixpoint(chain[:, :40], chain_scores[:, :40],
                                     CHAIN_THR, 40)
        capped = TN.nms_3d_fixpoint(chain, chain_scores, CHAIN_THR, 100,
                                    max_rounds=64)
        blocks = TN.nms_3d_blockwise(boxes, scores, 0.3, 64, valid=valid,
                                     block_size=128)
        shapes = (((2,), torch.float32), ((3,), torch.int32))
        stage = T_inf.chunked_roi_stage_traced(_stage, rois, total, 8, shapes)
        launched = T_inf.launched_roi_stage_traced(_stage, rois, total, 8,
                                                   shapes)
        return settled, capped, blocks, stage, launched


def _stage(x):
    return (x[..., :2] * 2.0 + 1.0, (x[..., 2:5] * 10).to(torch.int32))


CHAIN_THR = 0.4  # boxes i, i + 1 of _chain: IoU 0.6; i, i + 2: 1 / 3


def _chain(n):
    """Boxes i and i + 1 suppress each other at CHAIN_THR, no others do;
    scores fall along the chain, so the greedy keeps every other box and
    the fixpoint needs about n / 2 rounds."""
    lo = np.arange(n, dtype=np.float32)[:, None] * np.array(
        [0.25, 0.0, 0.0], np.float32)
    boxes = np.concatenate([lo, lo + 1.0], 1)[None]
    scores = np.linspace(1.0, 0.5, n, dtype=np.float32)[None]
    return T(boxes), T(scores)


def test_traced_forms_equal_eager_bit_for_bit():
    rng = np.random.RandomState(21)
    chain, chain_scores = _chain(100)
    n = 300
    boxes = T(np.stack([proposal_like_boxes(rng, n) for _ in range(2)]))
    scores = T(rng.uniform(size=(2, n)).astype(np.float32))
    valid = T(np.arange(n)[None] < np.array([[120], [250]]))
    rois = T(rng.randn(2, 29, 6).astype(np.float32))
    mod = _Traced()
    args = (chain, chain_scores, boxes, scores, valid, rois,
            torch.tensor(29, dtype=torch.int32))
    program = serve.export_program(mod, args).module()
    settled, capped, blocks, *_ = mod(*args)
    greedy = TN.nms_3d_numpy(chain[0].numpy(), chain_scores[0].numpy(),
                             CHAIN_THR, 100)
    np.testing.assert_array_equal(settled[0][settled[1]].numpy(),
                                  greedy[:20])
    assert capped[1].sum() > len(greedy) == 50     # the round cap bites
    for total in (0, 1, 8, 29):
        args = args[:-1] + (torch.tensor(total, dtype=torch.int32),)
        got = program(*args)
        want = (settled, capped, blocks,
                T_inf.chunked_roi_stage(_stage, rois, total, 8),
                T_inf.launched_roi_stage(_stage, rois, total, 8))
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                assert torch.equal(a, b), total


def _op_cases():
    rng = np.random.RandomState(5)
    feats = [T(rng.randn(2, s, s, d, 8).astype(np.float32))
             for s, d in ((16, 8), (8, 8), (4, 4), (2, 2))]
    n, p = 12, 7
    levels = T((np.arange(n) % 4).astype(np.int32))
    bat = T(np.sort(rng.randint(0, 2, n)).astype(np.int32))
    pos = T(rng.uniform(-0.5, 3.5, (n, 3, p)).astype(np.float32))
    origins = T(rng.randint(0, 2, (n, 3)).astype(np.int32))
    wy, wx, wz = (T(rng.uniform(0, 0.5, (n, p, s)).astype(np.float32))
                  for s in (4, 4, 8))
    bounds = torch.tensor([2, 7], dtype=torch.int32)
    wk = T(rng.randn(5, p ** 3 * 8).astype(np.float32))
    total = torch.tensor(9, dtype=torch.int32)
    return {
        "roialign_compact": (levels, bat, total, pos, feats),
        "roialign_padded": (levels, pos, feats, 6),
        "roialign_slab": (levels, bat, origins, wy, wx, wz, feats, bounds),
        "roialign_fc": (levels, bat, origins, wy, wx, wz, feats, wk, bounds),
    }


@pytest.mark.parametrize("name", ["roialign_compact", "roialign_padded",
                                  "roialign_slab", "roialign_fc"])
def test_kernel_ops_pass_opcheck(name):
    op = getattr(torch.ops.m3d_torch, name).default
    torch.library.opcheck(op, _op_cases()[name])


def test_segment_volume_matches_jax_outputs_postprocessed(served):
    """A raw volume that is no bucket shape: the router pads it to 64x64x16
    and carries its extent in the meta window; its segmentation equals the
    port's postprocess on JAX's outputs for the padded volume."""
    vol = np.random.RandomState(11).randn(*RAW).astype(np.float32)
    seg = served["router"].segment_volume(vol)
    assert seg["label_volume"].shape == RAW
    assert seg["label_volume"].dtype == np.uint16

    jcfg = served["jcfg"]
    infer, _ = j_inference_fn(jcfg, image_shape=(64, 64, 16))
    padded = np.pad(vol, [(0, 16), (0, 24), (0, 4)])[None, ..., None]
    meta = compose_image_meta(0, (*RAW, 1), (64, 64, 16, 1),
                              (0, 0, 0, *RAW), 1.0, [1] * 2)
    ref = jax.device_get(jax.jit(infer)(served["variables"], padded,
                                        meta[None]))
    boxes, class_ids, scores, masks = postprocess_detections(
        np.asarray(ref["detections"][0]), np.asarray(ref["mrcnn_masks"][0]),
        padded_shape=(64, 64, 16), original_shape=RAW,
        min_confidence=float(jcfg.DETECTION_MIN_CONFIDENCE),
        min_roi_size=float(jcfg.MIN_ROI_SIZE),
        nms_threshold=float(jcfg.DETECTION_NMS_THRESHOLD),
        max_instances=int(jcfg.DETECTION_MAX_INSTANCES))
    assert len(scores) > 0
    np.testing.assert_array_equal(seg["boxes_px"], boxes)
    np.testing.assert_array_equal(seg["class_ids"], class_ids)
    np.testing.assert_allclose(seg["scores"], scores, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(seg["masks"], masks)
    np.testing.assert_array_equal(seg["label_volume"],
                                  instances_to_label_volume(masks, scores))


def test_errors_are_raised(served, tmp_path):
    bundle, router = served["chunked"], served["router"]
    with pytest.raises(ValueError, match="shape-frozen"):
        bundle.predict(served["image"][:1])
    with pytest.raises(ValueError, match="shape-frozen"):
        bundle.predict(np.zeros((2, 64, 64, 16, 1), np.float32))
    with pytest.raises(ValueError, match="no bundle for bucket"):
        router.predict_volume(np.zeros((128, 128, 8), np.float32))
    # A CPU graph refuses the card; a card graph refuses the CPU, and on a
    # machine with no card it raises instead of running on the CPU.
    with pytest.raises(ValueError, match="traced for"):
        serve.ServingBundle.load(served["chunked_dir"], device="cuda")
    card = str(tmp_path / "card")
    shutil.copytree(served["chunked_dir"], card)
    with open(os.path.join(card, "manifest.json")) as f:
        m = json.load(f)
    with open(os.path.join(card, "manifest.json"), "w") as f:
        json.dump(dict(m, platforms=["cuda"]), f)
    with pytest.raises(ValueError, match="traced for"):
        serve.ServingBundle.load(card, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            serve.ServingBundle.load(card)
    # data_parallel 2 over the CPU twice: each slice of the batch is the
    # data_parallel 1 monolithic bundle's answer on it, bit for bit; JAX's
    # errors stay errors.
    dp_dir = str(tmp_path / "dp")
    man = serve.export_bundle(served["tcfg"], served["state"], dp_dir,
                              batch=2, device="cpu", data_parallel=2)
    assert man["data_parallel"] == 2 and man["batch"] == 2
    assert man["chunks"] == {"classifier": None, "mask": None}
    dp = serve.ServingBundle.load(dp_dir, device="cpu",
                                  devices=["cpu", "cpu"])
    got = dp.predict(served["image"])
    for i in range(2):
        want = served["mono"].predict(served["image"][i:i + 1])
        for k, v in want.items():
            np.testing.assert_array_equal(got[k][i:i + 1], v, k)
    with pytest.raises(ValueError, match="batch 3 not divisible by "
                       "data_parallel 2"):
        serve.export_bundle(served["tcfg"], served["state"],
                            str(tmp_path / "dp3"), batch=3, device="cpu",
                            data_parallel=2)
    with pytest.raises(ValueError, match="exported data_parallel=2; only 1 "
                       "devices available"):
        serve.ServingBundle.load(dp_dir, device="cpu", devices=["cpu"])
    assert not os.path.exists(tmp_path / "dp3")
    with open(os.path.join(card, "manifest.json"), "w") as f:
        json.dump(dict(m, format="m3d-serving-bundle-v1"), f)  # JAX's
    with pytest.raises(ValueError, match="not a serving bundle"):
        serve.ServingBundle.load(card, device="cpu")


@pytest.mark.parametrize("auto", [True, False])
def test_chunks_from_config_matches_jax(auto):
    """``chunks_from_config(config, model, auto)`` equals JAX's for the
    bench-like defaults (both stages chunked), the tiny serving config
    (neither), explicit keys and explicit 0; ``auto=False`` (data-parallel
    exports) drops only the defaults."""
    from m3d.config import Config
    from m3d.models.inference import chunks_from_config as j_chunks

    cases = [dict(POST_NMS_ROIS_INFERENCE=1500, DETECTION_MAX_INSTANCES=50),
             tiny_config().to_dict(),
             dict(POST_NMS_ROIS_INFERENCE=1500, DETECTION_MAX_INSTANCES=50,
                  CLASSIFIER_CHUNK=96),
             dict(POST_NMS_ROIS_INFERENCE=600, CLASSIFIER_CHUNK=0,
                  MASK_CHUNK=8)]
    seen = set()
    for kw in cases:
        jcfg, tcfg = Config(**kw), TConfig(**kw)
        want = j_chunks(jcfg, JMaskRCNN.from_config(jcfg, mode="inference"),
                        auto=auto)
        got = T_inf.chunks_from_config(tcfg, MaskRCNN.from_config(
            tcfg, mode="inference", device="meta"), auto=auto)
        assert got == want, kw
        seen.add(got)
    assert len(seen) >= 3, seen


def test_classifier_route_at_c32_sends_no_row_to_the_fused_op(monkeypatch):
    """§3 b: the fused kernel takes C % 64 == 0 and F % 8 == 0 only, so at
    C = 32 every row takes the fallback route (the slab op at the
    exact-coverage slab, then conv3d_fc), on every device, and the fused
    op is never called; the result is the gather + conv3d_fc function."""
    rng = np.random.RandomState(4)
    feats = [T(rng.randn(2, s, s, d, 32).astype(np.float32))
             for s, d in ((16, 8), (8, 8), (4, 4), (2, 2))]
    lo = rng.uniform(0, 0.6, (2, 10, 3))
    boxes = T(np.concatenate([lo, lo + rng.uniform(0.05, 0.35, (2, 10, 3))],
                             -1).astype(np.float32))
    meta = T(np.tile(default_meta(tiny_config())[None], (2, 1)))
    weight = T(rng.randn(16, 32, 7, 7, 7).astype(np.float32) * 0.01)
    assert not TF.fc_kernel_takes(32, 16) and TF.fc_kernel_takes(64, 16)
    assert TR.fused_classifier_ok(7, feats)
    seen = []
    real_slab = TR.roialign_slab

    def no_fc(*a):
        raise AssertionError("a row reached roialign_fc at C = 32")

    def spy_slab(*a):
        seen.append(a[-1].tolist())
        return real_slab(*a)

    monkeypatch.setattr(TR, "roialign_fc", no_fc)
    monkeypatch.setattr(TR, "roialign_slab", spy_slab)
    got = TR.pyramid_roi_align_fc(boxes, meta, feats, 7, weight)
    assert seen == [[0, 20]]
    pooled = TR.pyramid_roi_align(boxes, meta, feats, 7)
    ref = conv3d_fc(pooled.reshape(20, 7, 7, 7, 32), weight,
                    out_dtype=torch.float32).reshape(2, 10, 16)
    scale = ref.abs().max()
    np.testing.assert_allclose((got / scale).numpy(), (ref / scale).numpy(),
                               rtol=0, atol=2e-5)
