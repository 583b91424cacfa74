"""m3d_torch's evaluation slice against m3d's: unmolding and the filter
cascade, the label volume, the metrics, head introspection and class-dim
slicing of checkpoints, the per-image evaluation and its summary (exact),
then the whole MRCNN_EVALUATION and RPN_EVALUATION slices at the tiny
config of tests/test_torch_models.py (float32 on the CPU both sides, with
the tolerances stated), and the ``python -m m3d_torch`` CLI.
"""

import contextlib
import csv
import io
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from m3d.config import Config
from m3d.data import datasets as J_ds
from m3d.data.generators import MrcnnGenerator as JGenerator
from m3d.models import inference as J_inf
from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
from m3d.models.mask_rcnn import init_params as j_init_params
from m3d.train import checkpoints as J_ckpt
from m3d.train.mrcnn import MrcnnTrainer as JTrainer
from m3d.utils import metrics as J_met
from m3d.utils import tiffio as J_tiff
from m3d.utils import unmold as J_un
from m3d_torch import __main__ as cli
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.config import Config as TConfig
from m3d_torch.data import datasets as T_ds
from m3d_torch.models.mask_rcnn import MaskRCNN
from m3d_torch.train.mrcnn import MrcnnTrainer
from m3d_torch.train.rpn import RPNTrainer
from m3d_torch.utils import metrics as T_met
from m3d_torch.utils import tiffio as T_tiff
from m3d_torch.utils import unmold as T_un
from m3d_torch.utils.h5read import UnsupportedHdf5
from test_torch_models import TINY, randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (64, 64, 8)


def _detections(rng, n=12, live=10, dup=True):
    """[n, 8] normalized detections, class 1, the last n - live rows zero;
    row 3 a near copy of row 2 with a lower score (for the host NMS)."""
    lo = rng.uniform(0.0, 0.7, (n, 3))
    hi = np.minimum(lo + rng.uniform(0.15, 0.4, (n, 3)), 1.0)
    det = np.concatenate([lo, hi, np.ones((n, 1)),
                          rng.uniform(0.05, 1.0, (n, 1))], 1)
    if dup:
        det[3, :6] = det[2, :6] + 0.002
        det[3, 7] = det[2, 7] * 0.9
    det[live:] = 0.0
    return det.astype(np.float32)


def _masks(rng, n, m=8, k=2, logits=False):
    if logits:
        return (rng.randn(n, m, m, m, k) * 4).astype(np.float32)
    return rng.uniform(0, 1, (n, m, m, m, k)).astype(np.float32)


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("original", [None, (60, 60, 6)])
def test_postprocess_detections_matches_jax(logits, original):
    rng = np.random.RandomState(21 + logits)
    det = _detections(rng)
    masks = _masks(rng, det.shape[0], logits=logits)
    kw = dict(min_confidence=0.1, min_roi_size=20, nms_threshold=0.5,
              max_instances=6)
    ref = J_un.postprocess_detections(det, masks, SHAPE, original, **kw)
    got = T_un.postprocess_detections(det, masks, SHAPE, original, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    kept = got[2]
    assert 0 < len(kept) < (det[:, 7] >= 0.1).sum()   # the cascade cut
    assert det[3, 7] not in kept                        # duplicate removed
    if original:
        assert got[3].shape[:3] == original


def test_instances_to_label_volume_matches_jax():
    rng = np.random.RandomState(4)
    masks = rng.uniform(0, 1, SHAPE + (6,)) > 0.7     # overlapping
    scores = rng.uniform(0, 1, 6).astype(np.float32)
    tied = np.array([0.5, 0.9, 0.5, 0.1, 0.9, 0.5], np.float32)
    for s in (scores, tied):
        got = T_un.instances_to_label_volume(masks, s)
        ref = J_un.instances_to_label_volume(masks, s)
        assert got.dtype == ref.dtype == np.uint16
        np.testing.assert_array_equal(got, ref)


def test_mask_metrics_match_jax():
    rng = np.random.RandomState(5)
    gt = (rng.uniform(0, 1, (16, 16, 4, 5)) > 0.6).astype(np.float32)
    pred = gt[..., [0, 2, 4, 1]].copy()
    pred[..., 1] = rng.uniform(0, 1, (16, 16, 4)) > 0.5   # a poor one
    gt_boxes = rng.randint(0, 8, (5, 6))
    pred_boxes = rng.randint(0, 8, (4, 6))
    gt_cls = np.array([1, 1, 2, 1, 1])
    pred_cls = np.array([1, 2, 1, 1])
    scores = np.array([0.9, 0.4, 0.7, 0.4])              # a tie
    np.testing.assert_array_equal(T_met.compute_overlaps_masks(pred, gt),
                                  J_met.compute_overlaps_masks(pred, gt))
    assert T_met.compute_overlaps_masks(pred[..., :0], gt).shape == (0, 5)
    args = (gt_boxes, gt_cls, gt, pred_boxes, pred_cls, scores, pred)
    for thr in (0.3, 0.5, 0.9):
        got = T_met.compute_matches(*args, iou_threshold=thr,
                                    score_threshold=0.1)
        ref = J_met.compute_matches(*args, iou_threshold=thr,
                                    score_threshold=0.1)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        assert T_met.compute_ap(*args, iou_threshold=thr) == \
            J_met.compute_ap(*args, iou_threshold=thr)
    empty = (gt_boxes, gt_cls, gt, pred_boxes[:0], pred_cls[:0], scores[:0],
             pred[..., :0])
    assert T_met.compute_ap(*empty) == J_met.compute_ap(*empty)


def test_detection_score_matches_jax():
    rng = np.random.RandomState(6)
    gt = np.concatenate([rng.uniform(0, 30, (5, 3)),
                         rng.uniform(35, 60, (5, 3))], 1).astype(np.float32)
    for n in (0, 3, 5, 40):
        props = gt[rng.randint(0, 5, n)] + rng.normal(0, 2, (n, 6))
        props = props.astype(np.float32)
        for thr in (0.3, 0.5):
            assert T_met.compute_detection_score(props, gt, thr) == \
                J_met.compute_detection_score(props, gt, thr)
    assert T_met.compute_detection_score(gt, gt[:0], 0.5) == 0.0


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two 64 x 64 x 8 volumes from the port's generator, one per split."""
    from m3d_torch.data import synthetic as T_syn

    d = str(tmp_path_factory.mktemp("eval_data"))
    T_syn.generate_experiment(2, 64, d, seed=11, image_depth=8)
    T_syn.split_dataset(d, test_ratio=0.5)
    return d


def _datasets(data_dir, is_train=False):
    out = []
    for mod in (J_ds, T_ds):
        ds = mod.ToyDataset()
        ds.load_dataset(data_dir, is_train=is_train, class_names=("object",))
        ds.prepare()
        out.append(ds)
    return out


@pytest.mark.parametrize("topk_explicit", [False, True])
def test_rpn_evaluation_matches_jax(data_dir, topk_explicit):
    """One fixed predict_fn: GT boxes jittered, random boxes, some invalid.
    An explicit EVAL_TOPK_RPN widens the top-K grid; the default does not."""
    extra = dict(EVAL_TOPK_RPN=7, EVAL_TOPK_GRID=[5, 50]) if topk_explicit \
        else dict(EVAL_TOPK_GRID=[5, 50])
    cfg = dict(TINY, **extra)
    results = []
    for met, ds, conf in zip((J_met, T_met),
                             _datasets(data_dir, is_train=True),
                             (Config(**cfg), TConfig(**cfg))):
        rng = np.random.RandomState(8)

        def predict(image, rng=rng, ds=ds):
            gt, _, _ = ds.load_data(0, masks_needed=False)
            scale = np.array(SHAPE * 2, np.float32)
            near = gt[rng.randint(0, len(gt), 30)] / scale + rng.normal(
                0, 0.02, (30, 6))
            far = rng.uniform(0, 1, (30, 6))
            props = np.concatenate([near, far]).astype(np.float32)
            return props, rng.uniform(0, 1, 60) > 0.2

        results.append(met.rpn_evaluation(predict, ds, conf, max_images=3))
    ref, got = results
    assert got == ref
    assert ("det@0.5_top7" in got) == topk_explicit
    assert got["mean_coord_error"] > 0 and got["det@0.3_top50"] > 0


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """Randomised JAX variables of the tiny model, saved by JAX's
    save_params, and the JAX model."""
    cfg = Config(**TINY)
    jm = JMaskRCNN.from_config(cfg, mode="inference")
    v = randomize(j_init_params(jm, jax.random.PRNGKey(0)), 13)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.msgpack")
    J_ckpt.save_params(path, v, {"epoch": 1})
    return path, jm, v


def test_head_introspection_matches_jax(tiny_ckpt, tmp_path):
    path = tiny_ckpt[0]
    assert T_ckpt.infer_head_params(path) == J_ckpt.infer_head_params(path)
    assert T_ckpt.infer_head_params(path)["FPN_CLASSIF_FC_LAYERS_SIZE"] == 64
    wide = dict(TINY, FPN_CLASSIF_FC_LAYERS_SIZE=1024, HEAD_CONV_CHANNEL=256)
    missing = str(tmp_path / "absent.msgpack")
    h5 = str(tmp_path / "x.h5")
    open(h5, "wb").close()
    jc, tc = Config(**wide), TConfig(**wide)
    got = T_ckpt.autoconfigure_heads(tc, [None, missing, h5, path])
    assert got == J_ckpt.autoconfigure_heads(jc, [None, missing, path])
    assert jc.to_dict() == tc.to_dict()
    assert tc.FPN_CLASSIF_FC_LAYERS_SIZE == 64 and tc.HEAD_CONV_CHANNEL == 32
    with pytest.raises(UnsupportedHdf5, match="not an HDF5 file"):
        T_ckpt.infer_head_params(h5)


def test_class_slice_restore_matches_jax(tmp_path):
    """A 3-class checkpoint restored into a 2-class model: the class axes
    are sliced as JAX slices them, and counted as ``sliced``."""
    big = JMaskRCNN.from_config(Config(**dict(TINY, NUM_CLASSES=3)))
    small = JMaskRCNN.from_config(Config(**TINY))
    src = randomize(j_init_params(big, jax.random.PRNGKey(1), channels=1), 3)
    dst = j_init_params(small, jax.random.PRNGKey(2))
    merged, jstats = J_ckpt.restore_by_name(dst, src)
    path = str(tmp_path / "big.msgpack")
    J_ckpt.save_params(path, src)
    model = MaskRCNN.from_config(TConfig(**TINY), device="cpu")
    tree, _ = T_ckpt.load_params(path)
    stats = T_ckpt.restore_by_name(model, T_ckpt.params_from_jax(tree))
    assert stats["sliced"] == jstats["sliced"] > 0
    assert stats["skipped"] == jstats["skipped"] == 0
    want = T_ckpt.params_from_jax(jax.device_get(merged))
    got = model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def _stub(cfg):
    return types.SimpleNamespace(config=cfg,
                                 _write_overlay=JTrainer._write_overlay)


def test_evaluate_one_and_summary_match_jax(data_dir, tmp_path):
    """One shared ``out`` dict through both packages' per-image evaluation
    and summary: the same result, CSV, label volume and summary JSON."""
    kw = dict(TINY, DATA_DIR=data_dir, MIN_ROI_SIZE=20,
              DETECTION_NMS_THRESHOLD=0.5, CLASS_NAMES=["object"])
    rng = np.random.RandomState(31)
    det = _detections(rng, n=8, live=8)
    det[:2, :6] = [[0.2, 0.2, 0.1, 0.6, 0.6, 0.9]] * 2   # overlap GT-ish
    out = {"detections": det[None],
           "mrcnn_masks": _masks(rng, 8, m=28, logits=True)[None]}
    jds, tds = _datasets(data_dir)
    meta = JGenerator(jds, Config(**kw), mode="inference",
                      shuffle=False).get_input_prediction(0)["image_meta"][0]
    res, texts = [], []
    for side in ("jax", "port"):
        od = str(tmp_path / side)
        os.makedirs(os.path.join(od, "overlays"))
        if side == "jax":
            cfg = Config(**kw)
            r = JTrainer._evaluate_one(_stub(cfg), jds, 0, out, od,
                                       os.path.join(od, "overlays"), True,
                                       image_meta=meta)
            s = JTrainer._summarize(_stub(cfg), [r], r["scores"], od)
        else:
            trainer = MrcnnTrainer(TConfig(**kw), device="cpu")
            r = trainer._evaluate_one(tds, 0, out, od,
                                      os.path.join(od, "overlays"),
                                      image_meta=meta)
            s = trainer._summarize([r], r["scores"], od)
            assert set(trainer._now) == {"unmold", "load", "metrics",
                                         "artifacts"}
        res.append((r, s))
        with open(os.path.join(od, "000000.csv")) as f, \
                open(os.path.join(od, "evaluation_summary.json")) as g:
            texts.append((f.read(), g.read(),
                          T_tiff.imread_volume(os.path.join(od, "000000.tiff")),
                          sorted(os.listdir(os.path.join(od, "overlays")))))
    assert res[1] == res[0]
    (csv_j, sum_j, lab_j, ov_j), (csv_t, sum_t, lab_t, ov_t) = texts
    assert csv_t == csv_j and sum_t == sum_j and ov_t == ov_j
    np.testing.assert_array_equal(lab_t, lab_j)
    np.testing.assert_array_equal(
        J_tiff.imread_volume(str(tmp_path / "port" / "000000.tiff")), lab_j)
    assert lab_t.shape == (8, 64, 64) and lab_t.dtype == np.uint16
    r = res[1][0]
    assert r["n_detections"] > 0 and r["n_gt"] > 0
    assert len(list(csv.reader(csv_t.splitlines()))) == r["n_detections"] + 1


def _slice_configs(data_dir, path, out, **extra):
    kw = dict(TINY, DATA_DIR=data_dir, OUTPUT_DIR=out,
              WEIGHT_DIR=os.path.join(out, "weights"), CLASS_NAMES=["object"],
              RPN_WEIGHTS=path, HEAD_WEIGHTS=path, POST_NMS_ROIS_TRAINING=64,
              MIN_ROI_SIZE=8, **extra)
    return Config(**kw), TConfig(**kw)


@pytest.mark.parametrize("chunks", [{}, dict(CLASSIFIER_CHUNK=16,
                                             MASK_CHUNK=3)])
def test_mrcnn_evaluation_slice_matches_jax(data_dir, tiny_ckpt, tmp_path,
                                            chunks):
    """The whole MRCNN_EVALUATION slice on one image: the port's
    ``evaluate`` against JAX's adaptive_inference + ``_evaluate_one``.
    Detection counts and det_tp/fp/fn equal; pixel metrics and
    instance_dice within 1e-3; at most 0.1 % of label voxels differ."""
    path, jm, v = tiny_ckpt
    jcfg, tcfg = _slice_configs(data_dir, path, str(tmp_path / "port"),
                                **chunks)
    summary, per_image = MrcnnTrainer(tcfg, device="cpu").evaluate(
        max_images=1)
    assert len(per_image) == 1 and summary["det_recall"] >= 0.0

    jds, _ = _datasets(data_dir)
    inputs = JGenerator(jds, jcfg, mode="inference",
                        shuffle=False).get_input_prediction(0)
    cls_chunk, mask_chunk = J_inf.chunks_from_config(jcfg, jm)
    out = jax.device_get(jax.jit(lambda vv, img: J_inf.adaptive_inference(
        jm, vv, img, inputs["image_meta"], inputs["anchors"],
        classifier_chunk=cls_chunk, mask_chunk=mask_chunk))(
            v, inputs["image"]))
    jod = str(tmp_path / "jax")
    os.makedirs(os.path.join(jod, "overlays"))
    ref = JTrainer._evaluate_one(_stub(jcfg), jds, 0, out, jod,
                                 os.path.join(jod, "overlays"), True,
                                 image_meta=inputs["image_meta"][0])
    got = per_image[0]
    assert got["n_detections"] == ref["n_detections"] > 0
    for k in ("n_gt", "det_tp", "det_fp", "det_fn"):
        assert got[k] == ref[k], k
    for k in ("pixel_precision", "pixel_recall", "pixel_f1", "pixel_iou",
              "instance_dice"):
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-4)
    lab_t = T_tiff.imread_volume(str(tmp_path / "port" / "000000.tiff"))
    lab_j = J_tiff.imread_volume(os.path.join(jod, "000000.tiff"))
    assert lab_t.shape == lab_j.shape
    assert (lab_t != lab_j).mean() <= 1e-3


def test_rpn_evaluation_slice_matches_jax(data_dir, tiny_ckpt, tmp_path):
    """RPN_EVALUATION: the port's RPNTrainer against JAX's
    make_proposal_fn path on the same checkpoint file, metrics within
    1e-6."""
    from m3d.train.rpn import RPNTrainer as JRPNTrainer

    path = tiny_ckpt[0]
    jcfg, tcfg = _slice_configs(data_dir, path, str(tmp_path / "out"),
                                EVAL_TOPK_GRID=[20, 64])
    jt = JRPNTrainer(jcfg, mode="training")
    jpredict = jt.make_proposal_fn(jt.init_variables())
    _, jtest = jt.prepare_datasets()
    ref = J_met.rpn_evaluation(jpredict, jtest, jcfg, max_images=2)
    tt = RPNTrainer(tcfg, device="cpu")
    tt.init_variables()
    tpredict = tt.make_proposal_fn()
    _, ttest = tt.prepare_datasets()
    got = T_met.rpn_evaluation(tpredict, ttest, tcfg, max_images=2)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    image = ttest.load_image(0)[None]
    (gp, gv), (rp, rv) = tpredict(image), jpredict(image)
    np.testing.assert_array_equal(gv, np.asarray(rv))
    assert gv.sum() > 0
    np.testing.assert_allclose(gp, np.asarray(rp), atol=1e-5)


def _write_tiny_config(data_dir, path, out):
    cfg = dict(TINY, DATA_DIR=data_dir, OUTPUT_DIR=out,
               CLASS_NAMES=["object"], RPN_WEIGHTS=path, HEAD_WEIGHTS=path,
               MIN_ROI_SIZE=8, EVALUATION_STEPS=1)
    cfg_path = os.path.join(os.path.dirname(out), "tiny.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return cfg_path


def _run_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "m3d_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_mrcnn_evaluation_writes_artifacts(data_dir, tiny_ckpt,
                                               tmp_path):
    out = str(tmp_path / "out")
    cfg_path = _write_tiny_config(data_dir, tiny_ckpt[0], out)
    res = _run_cli("--task", "MRCNN_EVALUATION", "--config_path", cfg_path,
                   "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "[evaluate] summary:" in res.stdout
    assert sorted(os.listdir(out)) == ["000000.csv", "000000.tiff",
                                       "evaluation_summary.json", "overlays"]
    assert os.listdir(os.path.join(out, "overlays")) == \
        ["000000_masks_overlay.png"]
    with open(os.path.join(out, "evaluation_summary.json")) as f:
        summary = json.load(f)
    for k in ("pixel_f1", "instance_dice", "det_recall", "det_precision"):
        assert k in summary
    assert T_tiff.imread_volume(os.path.join(out, "000000.tiff")).shape == \
        (8, 64, 64)


def test_cli_without_a_card_writes_nothing(data_dir, tiny_ckpt, tmp_path):
    """With no card and no --device cpu the CLI exits non-zero, says why,
    and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    out = str(tmp_path / "out")
    cfg_path = _write_tiny_config(data_dir, tiny_ckpt[0], out)
    for task in ("MRCNN_EVALUATION", "RPN_EVALUATION"):
        res = _run_cli("--task", task, "--config_path", cfg_path)
        assert res.returncode != 0
        assert "--device cpu" in res.stderr
    assert not os.path.exists(out)


def test_cli_rpn_evaluation_and_summary(data_dir, tiny_ckpt, tmp_path):
    out = str(tmp_path / "out")
    cfg_path = _write_tiny_config(data_dir, tiny_ckpt[0], out)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert cli.main(["--task", "MRCNN_EVALUATION", "--config_path",
                         cfg_path, "--device", "cpu", "--summary"]) is None
    assert "FPN_CLASSIF_FC_LAYERS_SIZE" in printed.getvalue()
    assert not os.path.exists(out)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        metrics = cli.main(["--task", "RPN_EVALUATION", "--config_path",
                            cfg_path, "--device", "cpu"])
    assert "det@0.5_top500" in metrics and "mean_coord_error" in metrics
    text = printed.getvalue()
    assert json.loads(text[text.index("\n{") + 1:]) == metrics
