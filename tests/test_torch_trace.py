"""m3d_torch/trace.py: the spans and counters of the inference path, on the
CPU at a tiny float32 config (seeded constructor weights; the classifier's
logits drawn so that detections depend on them). Off, tracing changes no
output and records nothing; on, one adaptive and one monolithic call give
the span tree, row counters equal to what the outputs show, NMS
rounds equal to a chain's length, one counted read per host read, and the
same exported graph."""

import contextlib
import math
from collections import Counter

import numpy as np
import pytest
import torch

from m3d_torch import serve, trace
from m3d_torch.anchors import normalized_pyramid_anchors
from m3d_torch.config import Config
from m3d_torch.image_meta import default_meta
from m3d_torch.models import inference as I
from m3d_torch.models.detection import refine_detections_batch
from m3d_torch.models.mask_rcnn import MaskRCNN
from m3d_torch.models.proposal import generate_proposals
from m3d_torch.ops import nms3d as TN

TINY = dict(
    IMAGE_SIZE=64, IMAGE_DEPTH=8, NUM_CLASSES=2,
    BACKBONE_STRIDES=[(4, 4, 1), (8, 8, 1), (16, 16, 1), (32, 32, 1),
                      (64, 64, 1)],
    RPN_ANCHOR_SCALES=(8, 16, 24, 32, 48), RPN_ANCHOR_RATIOS=[0.5, 1.0],
    PRE_NMS_LIMIT=512, POST_NMS_ROIS_INFERENCE=96, RPN_NMS_THRESHOLD=0.1,
    DETECTION_MAX_INSTANCES=8, DETECTION_MIN_CONFIDENCE=0.8,
    FPN_CLASSIF_FC_LAYERS_SIZE=64, HEAD_CONV_CHANNEL=32,
    TOP_DOWN_PYRAMID_SIZE=32, COMPUTE_DTYPE="float32")
CHUNKS = (24, 3)

ADAPTIVE_TREE = {
    ("infer", None), ("trunk", "infer"), ("proposals", "infer"),
    ("nms", "proposals"), ("classifier", "infer"),
    ("classifier.pack", "classifier"), ("classifier.align", "classifier"),
    ("classifier.head", "classifier"), ("detection", "infer"),
    ("nms", "detection"), ("mask", "infer"), ("mask.align", "mask"),
    ("mask.head", "mask")}
MONO_TREE = ADAPTIVE_TREE - {("classifier.pack", "classifier")}


class _Ranges:
    """Stands in for ``torch.autograd.profiler.record_function``: records
    the names of the ranges opened."""

    def __init__(self):
        self.names = []

    def __call__(self, name):
        self.names.append(name)
        return contextlib.nullcontext()


@pytest.fixture(scope="module")
def tiny():
    """The model, inputs, and each call's outputs with tracing off and on,
    as if a profiler were active: the records of the traced calls and the
    names of the profiler ranges each opened."""
    torch.manual_seed(0)
    cfg = Config(**TINY)
    model = MaskRCNN.from_config(cfg, device="cpu").eval()
    with torch.no_grad():
        model.classifier.mrcnn_class_logits.weight.normal_(0.0, 50.0)
    image = torch.from_numpy(
        np.random.RandomState(3).randn(2, 64, 64, 8, 1).astype(np.float32))
    meta = torch.from_numpy(np.tile(default_meta(cfg)[None], (2, 1)))
    anchors = torch.from_numpy(normalized_pyramid_anchors(cfg))
    calls = {
        "adaptive": lambda: I.adaptive_inference(
            model, image, meta, anchors, classifier_chunk=CHUNKS[0],
            mask_chunk=CHUNKS[1], device="cpu"),
        "mono": lambda: model(image, meta, anchors)}
    out = {}
    assert not trace._on
    for name, call in calls.items():
        o = out[name] = {}
        for on in (False, True):
            ranges = _Ranges()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch.autograd, "_profiler_enabled", lambda: True)
                mp.setattr(torch.autograd.profiler, "record_function",
                           ranges)
                if on:
                    trace.enable()
                try:
                    o["on" if on else "off"] = call()
                    if on:
                        o["records"] = trace.take()
                finally:
                    trace.disable()
            o["on_ranges" if on else "off_ranges"] = ranges.names
    return dict(model=model, image=image, meta=meta, anchors=anchors,
                calls=calls, out=out)


@pytest.mark.parametrize("which", ["adaptive", "mono"])
def test_tracing_changes_no_output_and_off_records_nothing(tiny, which):
    o = tiny["out"][which]
    for k, v in o["off"].items():
        assert torch.equal(v, o["on"][k]), k
    assert trace.take() == {"calls": [], "dropped": 0}
    assert o["off_ranges"] == []
    assert {"m3d.infer", "m3d.classifier", "m3d.read.nms.fixpoint"} <= \
        set(o["on_ranges"])
    assert all(n.startswith("m3d.") for n in o["on_ranges"])


@pytest.mark.parametrize("which,tree", [("adaptive", ADAPTIVE_TREE),
                                        ("mono", MONO_TREE)])
def test_span_tree(tiny, which, tree):
    calls = tiny["out"][which]["records"]["calls"]
    assert [c["name"] for c in calls] == ["infer"]
    spans = calls[0]["spans"]
    assert {(s["name"], s["parent"]) for s in spans} == tree
    assert spans[-1]["name"] == "infer"
    for s in spans:
        assert s["host_ms"] >= s["wait_ms"] >= 0
        assert s["device_ms"] is None                   # no card here
    assert Counter(s["name"] for s in spans)["proposals"] == 2


@pytest.mark.parametrize("which", ["adaptive", "mono"])
def test_chunk_and_row_counters(tiny, which):
    o = tiny["out"][which]
    t = trace.totals(o["records"]["calls"][0])
    for stage, valid, slots, chunk in (
            ("classifier", "proposals_valid", TINY["POST_NMS_ROIS_INFERENCE"],
             CHUNKS[0]),
            ("mask", "detections_valid", TINY["DETECTION_MAX_INSTANCES"],
             CHUNKS[1])):
        c = t[stage]["counters"]
        live = int(o["on"][valid].sum())
        assert 0 < live < 2 * slots, (stage, live)
        assert c["rows.live"] == live
        heads = sum(s["name"] == f"{stage}.head"
                    for s in o["records"]["calls"][0]["spans"])
        if which == "mono":
            assert c["rows.computed"] == 2 * slots
            assert heads == 1
            continue
        launched = math.ceil(live / chunk)
        assert launched < math.ceil(2 * slots / chunk)
        assert c["rows.computed"] == launched * chunk
        # The classifier's launched rows take one head pass, the mask
        # stage's chunks one each.
        assert heads == (1 if stage == "classifier" else launched)


def test_nms_rounds_on_a_suppression_chain():
    """Box i suppresses box i + 1 and no other: the fixpoint settles one
    more box a round, so a chain of n boxes takes n rounds, each one host
    read, each read a range in the profiler's trace."""
    for n in (1, 7, 30):
        lo = np.arange(n, dtype=np.float32)[:, None] * np.float32(
            [0.25, 0.0, 0.0])
        boxes = torch.from_numpy(np.concatenate([lo, lo + 1.0], 1)[None])
        scores = torch.from_numpy(np.linspace(1.0, 0.5, n,
                                              dtype=np.float32)[None])
        trace.enable()
        try:
            with torch.profiler.profile() as prof:
                with trace.span("detection"):
                    _, valid = TN.nms_3d(boxes, scores, 0.4, n)
            (call,) = trace.take()["calls"]
        finally:
            trace.disable()
        ranges = Counter(e.name for e in prof.events())
        assert ranges["m3d.detection"] == ranges["m3d.nms"] == 1
        assert ranges["m3d.read.nms.fixpoint"] == n
        c = trace.totals(call)["detection"]["counters"]
        assert int(valid.sum()) == (n + 1) // 2
        assert c["nms.rounds"] == c["host_reads.nms.fixpoint"] == n


def test_every_host_read_is_counted(tiny, monkeypatch):
    """Each ``Tensor.item`` the adaptive call makes is one counted read,
    and the tables are counted at their sites: one level table for each
    stage's ROIAlign (the classifier's launched rows take one compact
    ROIAlign, which reads no offset table), one for each box decoding."""
    items = Counter()
    real = torch.Tensor.item

    def item(self):
        items["n"] += 1
        return real(self)

    monkeypatch.setattr(torch.Tensor, "item", item)
    trace.enable()
    try:
        tiny["calls"]["adaptive"]()
        (call,) = trace.take()["calls"]
    finally:
        trace.disable()
    c = Counter()
    for t in trace.totals(call).values():
        c.update(t["counters"])
    tables = sum(v for k, v in c.items()
                 if k.startswith("host_reads.table."))
    assert c["host_reads"] - tables == items["n"] > 0
    assert c["host_reads.live.classifier"] == c["host_reads.live.mask"] == 1
    assert c["host_reads.nms.fixpoint"] == c["nms.rounds"]
    assert trace.totals(call)["classifier"]["counters"][
        "rows.computed"] > CHUNKS[0]                 # more than one chunk
    assert c["host_reads.table.gather_flat_sanitized"] == 0
    assert c["host_reads.table._level_positions"] == 2
    assert c["host_reads.table.generate_proposals"] == 1
    assert c["host_reads.table.refine_detections_batch"] == 1


class _Decode(torch.nn.Module):
    """Proposals and detections from given RPN and head outputs: the NMS,
    both tables and the detection span in one exported graph."""

    def forward(self, probs, deltas, anchors, cls_probs, cls_deltas, meta):
        props, _ = generate_proposals(probs, deltas, anchors,
                                      (0.1, 0.1, 0.1, 0.2, 0.2, 0.2), 16,
                                      0.5, 64, 8)
        return refine_detections_batch(props, cls_probs, cls_deltas, meta,
                                       (0.1, 0.1, 0.1, 0.2, 0.2, 0.2), 0.3,
                                       0.3, 8)


def test_export_is_the_same_with_tracing_on(tiny):
    rng = np.random.RandomState(5)
    anchors = tiny["anchors"][:200]
    probs = torch.from_numpy(rng.dirichlet((1, 1), (1, 200)).astype(
        np.float32))
    args = (probs, torch.from_numpy(rng.randn(1, 200, 6).astype(np.float32)),
            anchors, torch.from_numpy(rng.dirichlet((1, 1), (1, 16)).astype(
                np.float32)),
            torch.from_numpy(0.1 * rng.randn(1, 16, 2, 6).astype(np.float32)),
            tiny["meta"][:1])
    graphs = []
    for on in (False, True):
        if on:
            trace.enable()
        try:
            program = serve.export_program(_Decode(), args)
            assert trace.take()["calls"] == []
        finally:
            trace.disable()
        graphs.append((program.graph_module.print_readable(False),
                       program.module()(*args)))
    assert graphs[0][0] == graphs[1][0]
    for a, b in zip(graphs[0][1], graphs[1][1]):
        assert torch.equal(a, b)


def test_store_bound_nesting_and_kernel_launches(monkeypatch):
    """Calls past the bound are dropped and counted; a span inside one of
    its name records nothing; a span's counters are only what ``count``
    added (kernel launches stay the wrappers' ``LaunchCount``); a tensor
    counter is summed in ``take()``; a timer times with tracing on or
    off."""
    from m3d_torch.ops import roialign_compact

    k = roialign_compact.KERNEL
    monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(trace, "MAX_CALLS", 2)
    timer: dict = {}
    trace.enable()
    try:
        for _ in range(3):
            with trace.span("infer"):
                with trace.span("mask"):
                    with trace.span("mask"):        # counted once
                        k.launches += 2
                    trace.count("rows.live", torch.tensor([1, 0, 1]))
                    trace.count("rows.live", torch.tensor(3))
                    trace.count("rows.live")
        got = trace.take()
        with trace.span("load", into=timer):
            pass
        (load,) = trace.take()["calls"]
    finally:
        trace.disable()
    assert got["dropped"] == 1 and len(got["calls"]) == 2
    first, second = got["calls"]
    assert second["id"] == first["id"] + 1 and load["name"] == "load"
    mask = trace.totals(first)["mask"]
    assert mask["spans"] == 1
    assert mask["counters"] == {"rows.live": 6}
    assert k.launches == 6
    assert set(timer) == {"load"} and timer["load"] >= 0
    before = timer["load"]
    with trace.span("load", into=timer):       # a timer with tracing off
        pass
    assert timer["load"] >= before and trace.take()["calls"] == []
