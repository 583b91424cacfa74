"""m3d_torch host modules against their m3d originals: config, anchors,
image meta, synthetic volumes, recall matching, and the flax msgpack
reader / parameter conversion. Exact equality unless a tolerance is stated.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import serialization

import bench
from m3d.anchors import normalized_pyramid_anchors
from m3d.config import Config
from m3d.data.datasets import normalize_volume
from m3d.data.synthetic import create_volume
from m3d.image_meta import default_meta, parse_image_meta
from m3d_torch import anchors as t_anchors
from m3d_torch import checkpoints as t_ckpt
from m3d_torch import config as t_config
from m3d_torch import image_meta as t_meta
from m3d_torch.data import synthetic as t_syn
from m3d_torch.utils import metrics as t_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = [
    {},
    dict(IMAGE_SIZE=128, IMAGE_DEPTH=128,
         BACKBONE_STRIDES=[(4, 4, 4), (8, 8, 8), (16, 16, 16), (32, 32, 32),
                           (64, 64, 64)],
         RPN_ANCHOR_SCALES=(16, 24, 32, 48, 64),
         RPN_ANCHOR_RATIOS=[0.75, 1.0, 1.33], PRE_NMS_LIMIT=6000,
         POST_NMS_ROIS_INFERENCE=500, DETECTION_MAX_INSTANCES=50,
         FPN_CLASSIF_FC_LAYERS_SIZE=512),
    dict(IMAGE_SIZE=64, IMAGE_DEPTH=8, RPN_ANCHOR_SCALES=(8, 16, 24, 32, 48),
         RPN_ANCHOR_RATIOS=[0.5, 1.0], VOXEL_Z_OVER_Y=2.0),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_matches_jax(kw):
    ref, got = Config(**kw).to_dict(), t_config.Config(**kw).to_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=object),
                                      np.asarray(ref[k], dtype=object), k)
    np.testing.assert_array_equal(t_config.Config(**kw).backbone_shapes(),
                                  Config(**kw).backbone_shapes())


@pytest.mark.parametrize("kw", CONFIGS)
def test_anchors_match_jax(kw):
    voxel = kw.get("VOXEL_Z_OVER_Y")
    ref = normalized_pyramid_anchors(Config(**kw), voxel_z_over_y=voxel)
    got = t_anchors.normalized_pyramid_anchors(t_config.Config(**kw),
                                               voxel_z_over_y=voxel)
    np.testing.assert_array_equal(got, ref)


def test_image_meta_matches_jax():
    cfg = Config(IMAGE_SIZE=64, IMAGE_DEPTH=8, NUM_CLASSES=3)
    ref = default_meta(cfg, image_id=5)
    got = t_meta.default_meta(t_config.Config(IMAGE_SIZE=64, IMAGE_DEPTH=8,
                                              NUM_CLASSES=3), image_id=5)
    np.testing.assert_array_equal(got, ref)
    batch = np.stack([ref, ref * 2])
    ref_p = parse_image_meta(batch)
    got_p = t_meta.parse_image_meta(torch.from_numpy(batch))
    assert ref_p.keys() == got_p.keys()
    for k in ref_p:
        np.testing.assert_array_equal(got_p[k].numpy(), np.asarray(ref_p[k]))


@pytest.mark.parametrize("shape,seed", [((32, 32, 32), 1000),
                                        ((48, 40, 16), 7)])
def test_create_volume_matches_jax(shape, seed):
    ref = create_volume(shape, np.random.RandomState(seed))
    got = t_syn.create_volume(shape, np.random.RandomState(seed))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(t_syn.normalize_volume(got[0]),
                                  normalize_volume(ref[0]))


def test_make_volumes_matches_bench():
    ref_v, ref_b = bench.make_volumes(2, 32)
    got_v, got_b = t_syn.make_volumes(2, 32)
    np.testing.assert_array_equal(got_v, ref_v)
    for r, g in zip(ref_b, got_b):
        np.testing.assert_array_equal(g, r)


def test_detection_recall_matches_bench():
    rng = np.random.RandomState(0)
    gt = [rng.uniform(0, 20, (n, 6)).astype(np.float32) for n in (4, 0, 3)]
    for g in gt:
        g[:, 3:] = g[:, :3] + rng.uniform(4, 12, (len(g), 3))
    det = np.zeros((3, 6, 8), np.float32)
    for b, g in enumerate(gt):       # near-copies of the GT plus clutter
        k = min(len(g), 6)
        det[b, :k, :6] = (g[:k] + rng.uniform(-1, 1, (k, 6))) / 32.0
        det[b, k:, :6] = rng.uniform(0, 1, (6 - k, 6))
        det[b, :, 7] = rng.uniform(0, 1, 6)
    valid = rng.uniform(size=(3, 6)) < 0.8
    ref = bench.detection_recall({"detections": det,
                                  "detections_valid": valid}, gt, 32)
    got = t_metrics.detection_recall(det, valid, gt, 32)
    assert got == ref and ref[1] > 0


def _sample_tree(rng):
    return {
        "params": {
            "conv": {"kernel": rng.randn(3, 3, 2, 4, 5).astype(np.float16),
                     "bias": rng.randn(5).astype(np.float32)},
            "dense": {"kernel": rng.randn(7, 3).astype(np.float32)},
            "ints": np.arange(6, dtype=np.int64).reshape(2, 3),
            "long_list": list(range(20)),
            "many": {f"k{i}": i * 1000 - 70000 for i in range(20)},
        },
        "meta": {"name": "x" * 40, "longer": "y" * 300, "epoch": 2 ** 40,
                 "neg": -5, "neg_big": -(2 ** 33), "lr": 1.5e-3,
                 "flag": True, "none": None, "scalar": np.float32(2.5),
                 "list": [1, 2.0, "three"], "c": complex(1.0, -2.0)},
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_msgpack_reader_matches_flax():
    tree = _sample_tree(np.random.RandomState(0))
    blob = serialization.msgpack_serialize(tree)
    _assert_tree_equal(serialization.msgpack_restore(blob),
                       t_ckpt.msgpack_restore(blob))


def test_msgpack_reader_unchunks_and_reads_bin():
    import msgpack

    arr = np.arange(10, dtype=np.float32)
    chunked = {"w": {"__msgpack_chunked_array__": True,
                     "shape": {"0": 2, "1": 5},
                     "chunks": {"0": arr[:6], "1": arr[6:]}}}
    blob = serialization.msgpack_serialize(chunked)
    got = t_ckpt.msgpack_restore(blob)
    np.testing.assert_array_equal(got["w"], arr.reshape(2, 5))
    _assert_tree_equal(serialization.msgpack_restore(blob), got)
    raw = msgpack.packb({"b": b"\x00\x01" * 200, "f": 0.25,
                         "small": b"ab"}, use_bin_type=True,
                        use_single_float=True)
    assert t_ckpt.msgpack_restore(raw) == msgpack.unpackb(raw)
    with pytest.raises(ValueError):
        t_ckpt.msgpack_restore(blob[:-3])
    with pytest.raises(ValueError):
        t_ckpt.msgpack_restore(blob + b"\x00")


def test_params_from_jax_layouts():
    rng = np.random.RandomState(1)
    conv = rng.randn(2, 3, 4, 5, 6).astype(np.float16)
    deconv = rng.randn(2, 2, 2, 5, 7).astype(np.float32)
    dense = rng.randn(8, 3).astype(np.float32)
    tree = {"params": {"a": {"c1": {"kernel": conv, "bias": np.ones(6)},
                             "bn": {"scale": np.full(6, 2.0),
                                    "bias": np.zeros(6)}},
                       "mrcnn_mask_deconv": {"kernel": deconv},
                       "fc": {"kernel": dense}},
            "batch_stats": {"a": {"bn": {"mean": np.arange(6.0),
                                         "var": np.ones(6)}}}}
    sd = t_ckpt.params_from_jax(tree)
    assert set(sd) == {"a.c1.weight", "a.c1.bias", "a.bn.weight", "a.bn.bias",
                       "mrcnn_mask_deconv.weight", "fc.weight",
                       "a.bn.running_mean", "a.bn.running_var"}
    assert all(v.dtype == torch.float32 for v in sd.values())
    np.testing.assert_array_equal(
        sd["a.c1.weight"].numpy(),
        conv.astype(np.float32).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        sd["mrcnn_mask_deconv.weight"].numpy(),
        deconv.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1])
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(sd["a.bn.running_mean"].numpy(),
                                  np.arange(6.0))


def test_restore_by_name_counts():
    mod = torch.nn.Sequential()
    mod.add_module("a", torch.nn.Linear(3, 2))
    mod.add_module("c", torch.nn.Linear(4, 3))
    # a.bias: larger in its one axis, sliced down (a class-count change);
    # b: no module; c.weight: smaller than its target, skipped; c.bias: not
    # in the checkpoint.
    state = {"a.weight": torch.ones(2, 3), "a.bias": torch.arange(5.0),
             "b.weight": torch.ones(1), "c.weight": torch.ones(2, 4)}
    stats = t_ckpt.restore_by_name(mod, state)
    assert stats == {"loaded": 1, "sliced": 1, "skipped": 2, "missing": 1}
    assert (mod.a.weight == 1).all()
    assert mod.a.bias.tolist() == [0.0, 1.0]
    assert not (mod.c.weight == 1).all()


def test_port_imports_without_jax_flax_msgpack_pandas(tmp_path):
    """m3d_torch and chip_smoke import in a Python where jax, flax, msgpack,
    pandas, PIL, h5py and m3d cannot be imported, and there write and read
    back one synthetic dataset volume (the native TIFF decoder), read the
    reference's Keras keras231_tiny.h5 and an MRC volume."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack',"
        " 'pandas', 'm3d', 'PIL', 'h5py'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import m3d_torch.models.inference, m3d_torch.checkpoints\n"
        "import m3d_torch.data.synthetic, m3d_torch.utils.metrics\n"
        "import m3d_torch.ops.roialign_compact, chip_smoke\n"
        "import m3d_torch.ops.roialign_slab, m3d_torch.ops.roialign_fc\n"
        "import m3d_torch.ops.roialign3d, m3d_torch.ops.cuda_build\n"
        "import m3d_torch.models.mask_rcnn, m3d_torch.__main__\n"
        "import m3d_torch.train.mrcnn, m3d_torch.train.rpn\n"
        "import m3d_torch.data.datasets, m3d_torch.data.generators\n"
        "import m3d_torch.utils.unmold, m3d_torch.utils.tiffio\n"
        "import m3d_torch.models.losses, m3d_torch.models.detection_targets\n"
        "import m3d_torch.utils.minimask, m3d_torch.data.rpn_targets\n"
        "import m3d_torch.data.augment, m3d_torch.train.optim\n"
        "import m3d_torch.train.telemetry, m3d_torch.train.profiling\n"
        "import m3d_torch.train.head, m3d_torch.train.autotune\n"
        "import m3d_torch.native, m3d_torch.utils.h5read\n"
        "import m3d_torch.utils.h5_import, m3d_torch.utils.mrcio\n"
        "import m3d_torch.serve, m3d_torch.parallel.mesh\n"
        "import m3d_torch.parallel.spatial, m3d_torch.parallel.dryrun\n"
        "from m3d_torch.data.synthetic import generate_experiment\n"
        "from m3d_torch.data.datasets import ToyDataset\n"
        "from m3d_torch.utils.tiffio import imread_volume\n"
        "d = sys.argv[1]\n"
        "generate_experiment(1, 64, d, seed=2, image_depth=8)\n"
        "vol = imread_volume(d + '/images/000001.tiff')\n"
        "assert vol.shape == (8, 64, 64) and vol.dtype.name == 'uint8'\n"
        "ds = ToyDataset()\n"
        "ds.add_image('dataset', 0, d + '/images/000001.tiff')\n"
        "assert ds.load_image(0).shape == (64, 64, 8, 1)\n"
        "from m3d_torch.checkpoints import load_params\n"
        "tree, meta = load_params('tests/fixtures/keras231_tiny.h5')\n"
        "assert meta == {'format': 'keras_h5'}\n"
        "assert tree['params']['conv1']['kernel'].shape == (7, 7, 7, 1, 64)\n"
        "from m3d_torch.utils.mrcio import read_mrc, write_mrc\n"
        "write_mrc(d + '/v.mrc', vol)\n"
        "assert (read_mrc(d + '/v.mrc') == vol).all()\n"
        "assert 'PIL' not in sys.modules and 'h5py' not in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    from m3d.utils.tiffio import imread_volume

    np.testing.assert_array_equal(
        imread_volume(str(tmp_path / "images" / "000001.tiff")),
        t_syn.create_volume((64, 64, 8), np.random.RandomState(2))[0]
        .transpose(2, 0, 1))
