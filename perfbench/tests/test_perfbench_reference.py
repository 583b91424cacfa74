"""The float32 reference against the port's plain CPU path (the kernels'
plain versions, float32 compute) at a tiny size of each configuration:
the same weights and volumes give the same proposals, classifier outputs,
detections and masks."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import REPO, TINY_MODEL


def tiny_config(base: str) -> dict:
    with open(os.path.join(REPO, "perfbench", "configs", f"{base}.json")) as f:
        model = json.load(f)["model"]
    keep = {k: model[k] for k in ("VOXEL_Z_OVER_Y",)}
    model.update(TINY_MODEL, COMPUTE_DTYPE="float32", **keep)
    if base.startswith("bench128"):
        model.update(IMAGE_DEPTH=64, BACKBONE_STRIDES=[
            [4, 4, 4], [8, 8, 8], [16, 16, 16], [32, 32, 32], [64, 64, 64]])
    return {"weights": {"kind": "seed"}, "model": model}


@pytest.mark.parametrize("base", ["bench128-r50", "rats256x12-r50"])
@pytest.mark.parametrize("entry", ["adaptive", "monolithic"])
def test_reference_matches_the_port(base, entry):
    from perfbench import volumes
    from perfbench.harness import load_module
    from perfbench.infer import image_meta, reference_state
    from perfbench.reference.anchors import anchors
    from perfbench.reference.maskrcnn import Reference, float32_math

    torch.manual_seed(0)
    torch.set_num_threads(1)
    cfg = tiny_config(base)
    m = cfg["model"]
    traffic = {"batch": 2, "chunks": "default"}
    mod = load_module(os.path.join(REPO, "perfbench", "entries",
                                   f"{entry}.py"), f"test_entry_{entry}")
    prog = mod.Entry(cfg, traffic, 99, "cpu", REPO)
    shape = (m["IMAGE_SIZE"], m["IMAGE_SIZE"], m["IMAGE_DEPTH"])
    images = volumes.make_pool(shape, [4, 6], 1, 4, 5, 99, "cpu",
                               float(m["VOXEL_Z_OVER_Y"]))
    out = prog(images)
    with float32_math(), torch.no_grad():
        ref = Reference(m)
        ref.load_state_dict(reference_state(cfg, 99, "cpu", REPO))
        anc = torch.as_tensor(anchors(m))
        assert torch.equal(anc, prog.anchors)
        want = ref.infer(images, torch.as_tensor(image_meta(m, 2)), anc)
    pv = want["proposals_valid"]
    assert torch.equal(out["proposals_valid"], pv)
    torch.testing.assert_close(out["proposals"], want["proposals"],
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(out["mrcnn_probs"][pv], want["mrcnn_probs"][pv],
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(out["mrcnn_bbox"][pv], want["mrcnn_bbox"][pv],
                               atol=1e-3, rtol=1e-4)
    dv = want["detections_valid"]
    assert dv.any()
    assert torch.equal(out["detections_valid"], dv)
    torch.testing.assert_close(out["detections"], want["detections"],
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(out["mrcnn_masks"][dv],
                               want["mrcnn_masks"][dv], atol=1e-4, rtol=0)


@pytest.mark.parametrize("base", ["bench128-r50", "rats256x12-r50"])
def test_reference_names_are_the_port_s(base):
    """One state dict loads into both: the names and shapes agree at the
    configuration's own widths."""
    from m3d_torch.config import Config
    from m3d_torch.models.mask_rcnn import MaskRCNN
    from perfbench.reference.maskrcnn import Reference

    with open(os.path.join(REPO, "perfbench", "configs", f"{base}.json")) as f:
        m = json.load(f)["model"]
    with torch.device("meta"):
        ref = {k: tuple(v.shape) for k, v in Reference(m).state_dict().items()}
    port = MaskRCNN.from_config(Config(**m), device="meta")
    assert ref == {k: tuple(v.shape) for k, v in port.state_dict().items()}
