"""The port's Keras-H5 path against h5py and m3d's: the HDF5 reader
(m3d_torch/utils/h5read.py) against h5py on the committed fixtures and on
files h5py writes here (300+ groups, attribute continuation blocks, empty,
scalar, null and big-endian values, compact storage), its named error on
what it does not parse; ``load_keras_h5``, ``infer_head_params_from_h5``,
``import_reference_h5``, ``restore_tree_by_name`` and ``export_reference_h5``
against JAX's; the fixture's tiny model restored from keras231_tiny.h5 in
both packages (RPN outputs at the models' tolerance); msgpack restores
unchanged; and both evaluation tasks through ``python -m m3d_torch`` with
``.h5`` weights.
"""

import contextlib
import copy
import io
import json
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from m3d.anchors import normalized_pyramid_anchors as j_anchors
from m3d.config import Config
from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
from m3d.train import checkpoints as J_ckpt
from m3d.utils import h5_import as J_h5
from m3d_torch import __main__ as cli
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.config import Config as TConfig
from m3d_torch.models.mask_rcnn import MaskRCNN, init_params
from m3d_torch.utils import h5_import as T_h5
from m3d_torch.utils import h5read
from test_torch_models import CLOSE, TINY

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
FIXTURES = {"keras231_tiny": 92, "keras231_tiny_head": 50}


def _fixture(name):
    return os.path.join(FIXDIR, f"{name}.h5")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# The reader against h5py ------------------------------------------------

def _many_groups(path):
    """350 layer groups (the root's B-tree needs internal nodes), each with
    a weight_names attribute and a nested dataset; 60 attributes on one
    group (continuation blocks)."""
    rng = np.random.RandomState(3)
    with h5py.File(path, "w") as f:
        names = [f"layer_{i:04d}" for i in range(350)]
        f.attrs["layer_names"] = [np.bytes_(n) for n in names]
        for i, name in enumerate(names):
            g = f.create_group(name)
            g.attrs["weight_names"] = [np.bytes_(f"{name}/kernel:0")]
            g.create_dataset(f"{name}/kernel:0",
                             data=rng.randn(2, i % 5).astype(np.float32))
        g = f.create_group("many_attrs")
        for i in range(60):
            g.attrs[f"a{i:02d}"] = np.arange(i, dtype=np.int64)


def _edge_cases(path):
    """Empty, scalar, null and big-endian attributes and datasets, fixed-
    length strings, every integer and float width, compact storage."""
    with h5py.File(path, "w") as f:
        f.attrs["weight_names"] = np.asarray([])         # float64, (0,)
        f.attrs["scalar_f32"] = np.float32(1.5)
        f.attrs["scalar_bytes"] = np.bytes_(b"tensorflow")
        f.attrs["null"] = h5py.Empty("f4")
        f.attrs["be_f64"] = np.arange(3, dtype=">f8")
        f.attrs["strings"] = [np.bytes_(b"ab"), np.bytes_(b"cde")]
        for dt in ("i1", "u1", "<i2", ">u2", "<i4", "<u4", ">i8", "<f2",
                   "<f4", ">f4", "<f8"):
            f.create_dataset(f"x/{dt}", data=np.arange(7).astype(dt))
        f.create_dataset("scalar", data=np.float64(3.0))
        f.create_dataset("empty", data=np.zeros((0, 3), np.float32))
        f.create_dataset("null", data=h5py.Empty("i4"))
        f.create_dataset("strings", data=np.array([b"ab", b"cde"]))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32LE,
                             h5py.h5s.create_simple((4,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype=np.int32))


def _assert_attrs_equal(got, want, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, h5py.Empty):
            assert isinstance(g, h5read.Empty) and g.dtype == w.dtype
            continue
        assert type(g) is type(w), (where, k)
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


@pytest.mark.parametrize("case", ["keras231_tiny", "keras231_tiny_head",
                                  "many_groups", "edge_cases"])
def test_reader_matches_h5py(case, tmp_path):
    """Every group's keys in order, every attribute and every dataset
    bit-equal in dtype and shape to what h5py reads."""
    if case in FIXTURES:
        path = _fixture(case)
    else:
        path = str(tmp_path / f"{case}.h5")
        {"many_groups": _many_groups, "edge_cases": _edge_cases}[case](path)
    n = 0
    with h5py.File(path, "r") as hf, h5read.File(path) as f:
        _assert_attrs_equal(f.attrs, hf.attrs, "/")
        names, got = [], []
        hf.visititems(lambda name, obj: names.append(name))
        f.visititems(lambda name, obj: got.append(name))
        assert got == names
        assert f.keys() == list(hf.keys())
        for name in names:
            ho, mo = hf[name], f[name]
            _assert_attrs_equal(mo.attrs, ho.attrs, name)
            if isinstance(ho, h5py.Group):
                assert mo.keys() == list(ho.keys())
                continue
            n += 1
            want = ho[()]
            if isinstance(want, h5py.Empty):
                assert mo.read() == h5read.Empty(want.dtype) and \
                    mo.shape is None
                continue
            g = np.asarray(mo)
            assert mo.shape == ho.shape and mo.dtype == ho.dtype, name
            assert g.dtype == want.dtype and g.shape == want.shape, name
            np.testing.assert_array_equal(g, want, err_msg=name)
    assert n == {"many_groups": 350, "edge_cases": 16}.get(case,
                                                           FIXTURES.get(case))


def _gzip(f):
    f.create_dataset("w", data=np.ones((8, 8), np.float32), compression="gzip")


def _chunked(f):
    f.create_dataset("w", data=np.ones((8, 8), np.float32), chunks=(4, 4))


def _vlen_attr(f):
    f.attrs["backend"] = "tensorflow"     # a str: variable-length UTF-8


REFUSED = {"gzip": (_gzip, "filter pipeline", "w"),
           "chunked": (_chunked, "chunked data layout", "w"),
           "vlen_string": (_vlen_attr, "variable-length string", None),
           "superblock_v3": (_chunked, "superblock version 3", None),
           "not_hdf5": (None, "not an HDF5 file", None)}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_reader_refuses_with_named_error(case, tmp_path):
    """What the reader does not parse raises UnsupportedHdf5 naming it: a
    compressed or chunked dataset when it is read, a variable-length
    string attribute when it is read, a newer superblock or a file that is
    not HDF5 when the file is opened."""
    make, what, dataset = REFUSED[case]
    path = str(tmp_path / "x.h5")
    if make is None:
        with open(path, "wb") as f:
            f.write(b"\x89HDF" + bytes(200))
    else:
        libver = "latest" if case == "superblock_v3" else None
        with h5py.File(path, "w", libver=libver) as f:
            make(f)
    with pytest.raises(h5read.UnsupportedHdf5, match=what):
        with h5read.File(path) as f:
            if dataset:
                np.asarray(f[dataset])
            else:
                f.attrs["backend"]
    assert issubclass(h5read.UnsupportedHdf5, ValueError)


# h5_import against JAX's -------------------------------------------------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_load_keras_h5_and_head_params_match_jax(name):
    path = _fixture(name)
    (jp, js), (tp, ts) = J_h5.load_keras_h5(path), T_h5.load_keras_h5(path)
    _assert_trees_equal(tp, jp)
    _assert_trees_equal(ts, js)
    n = sum(1 for _ in _leaves(tp)) + sum(1 for _ in _leaves(ts))
    assert n == FIXTURES[name]
    assert T_h5.infer_head_params_from_h5(path) == \
        J_h5.infer_head_params_from_h5(path) == \
        T_ckpt.infer_head_params(path)
    tree, meta = T_ckpt.load_params(path)
    jtree, jmeta = J_ckpt.load_params(path)
    assert meta == jmeta == {"format": "keras_h5"}
    _assert_trees_equal(tree, jtree)


@pytest.fixture(scope="module")
def tiny_tree():
    """The port's TINY model (the fixture's widths) and its seeded weights
    as a flax-shaped tree."""
    model = MaskRCNN.from_config(TConfig(**TINY), mode="inference",
                                 device="cpu").eval()
    init_params(model, 3)
    return model, T_ckpt.params_to_jax(model.state_dict())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_import_reference_h5_matches_jax(name, tiny_tree):
    """Both packages merge the fixture into the same tree: bit-equal
    leaves, equal stats, every fixture weight landed."""
    _, tree = tiny_tree
    path = _fixture(name)
    got, tstats = T_h5.import_reference_h5(tree, path)
    want, jstats = J_h5.import_reference_h5(tree, path)
    assert tstats == jstats
    _assert_trees_equal(got, want)
    landed = tstats["params"]["loaded"] + tstats["batch_stats"]["loaded"]
    assert landed == FIXTURES[name]
    assert tstats["params"]["skipped"] == tstats["params"]["sliced"] == 0


@pytest.fixture(scope="module")
def tree3():
    """A 3-class TINY model's seeded weights as a flax-shaped tree."""
    model = MaskRCNN.from_config(TConfig(**dict(TINY, NUM_CLASSES=3)),
                                 mode="inference", device="cpu")
    init_params(model, 4)
    return T_ckpt.params_to_jax(model.state_dict())


def _restore_cases(tree3, tree2, keras):
    head = J_ckpt.extract_subtree(tree3)
    bad = {"params": {"rpn": {"rpn_class_raw": {"kernel": np.ones(
        (1, 1, 1, 32, 5), np.float32)}}}}
    return {"class_slice_3_to_2": (tree2, tree3),
            "keras_layer_names": (tree2, keras),
            "head_subtree_f16": (tree2, {"params": {
                k: {n: np.asarray(v, np.float16) for n, v in m.items()}
                for k, m in head["params"]["classifier"].items()}}),
            "shape_mismatch_skipped": (tree2, bad)}


@pytest.mark.parametrize("case", ["class_slice_3_to_2", "keras_layer_names",
                                  "head_subtree_f16",
                                  "shape_mismatch_skipped"])
def test_restore_tree_by_name_matches_jax(case, tiny_tree, tree3):
    """The port's restore_tree_by_name is JAX's restore_by_name: a 3-class
    tree into 2 classes (the class axes sliced), a Keras tree keyed by
    layer name (suffix match), a float16 head subtree under another root
    (suffix match and the cast), and a leaf of the wrong shape (skipped)."""
    _, tree2 = tiny_tree
    params, stats = T_h5.load_keras_h5(_fixture("keras231_tiny"))
    target, source = _restore_cases(tree3, tree2, {
        "params": params, "batch_stats": stats})[case]
    got, tstats = T_ckpt.restore_tree_by_name(target, source)
    want, jstats = J_ckpt.restore_by_name(target, source)
    assert tstats == jstats
    _assert_trees_equal(got, jax.device_get(want))
    key = {"class_slice_3_to_2": "sliced", "keras_layer_names": "loaded",
           "head_subtree_f16": "loaded",
           "shape_mismatch_skipped": "skipped"}[case]
    assert tstats[key] > 0


def _astype(tree, dtype):
    return {k: _astype(v, dtype) if isinstance(v, dict) else
            np.asarray(v, dtype) for k, v in tree.items()}


def test_restore_weights_msgpack_unchanged(tiny_tree, tmp_path):
    """For flax msgpack files the merge gives the state dict the exact-name
    restore gave before it, bit for bit: a whole float16 tree and a
    head-only export."""
    model, _ = tiny_tree
    rng = np.random.RandomState(5)
    whole = _astype(T_ckpt.params_to_jax({
        k: v + torch.as_tensor(rng.randn(*v.shape), dtype=v.dtype)
        for k, v in model.state_dict().items()}), np.float16)
    for name, saved in (("whole", whole),
                        ("head", T_ckpt.extract_subtree(whole))):
        path = str(tmp_path / f"{name}.msgpack")
        T_ckpt.save_params(path, saved)
        a, b = copy.deepcopy(model), copy.deepcopy(model)
        T_ckpt.restore_by_name(a, T_ckpt.params_from_jax(
            T_ckpt.load_params(path)[0]))
        T_ckpt.restore_weights(b, path)
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)


def test_export_reference_h5_round_trip_and_without_h5py(tiny_tree, tmp_path,
                                                        monkeypatch):
    """The port's export writes what JAX's export writes (both read back
    by JAX's h5py reader and the port's reader alike), and names h5py in
    its ImportError where h5py does not import."""
    _, tree = tiny_tree
    paths = {p: str(tmp_path / f"{p}.h5") for p in ("port", "jax")}
    T_h5.export_reference_h5(tree, paths["port"])
    J_h5.export_reference_h5(tree, paths["jax"])
    for reader in (J_h5.load_keras_h5, T_h5.load_keras_h5):
        got, want = reader(paths["port"]), reader(paths["jax"])
        _assert_trees_equal(got[0], want[0])
        _assert_trees_equal(got[1], want[1])
    merged, stats = T_h5.import_reference_h5(tree, paths["port"])
    assert stats["params"]["missing"] == stats["params"]["skipped"] == 0
    _assert_trees_equal(merged["params"], tree["params"])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        T_h5.export_reference_h5(tree, str(tmp_path / "none.h5"))


# The tiny model from keras231_tiny.h5 in both packages -----------------------

def test_tiny_model_from_h5_matches_jax():
    """The fixture's tiny model restored from keras231_tiny.h5: the port's
    restore_weights gives JAX's load_params + restore_by_name tree bit for
    bit, and forward_rpn's logits, deltas and proposals agree at the
    models' float32 tolerance."""
    path = _fixture("keras231_tiny")
    model = MaskRCNN.from_config(TConfig(**TINY), mode="inference",
                                 device="cpu").eval()
    init_params(model, 1)
    start = T_ckpt.params_to_jax(model.state_dict())
    stats = T_ckpt.restore_weights(model, path)
    want, jstats = J_ckpt.restore_by_name(start, J_ckpt.load_params(path)[0])
    assert stats == jstats and stats["loaded"] == FIXTURES["keras231_tiny"]
    assert stats["skipped"] == stats["sliced"] == 0
    _assert_trees_equal(T_ckpt.params_to_jax(model.state_dict()),
                        jax.device_get(want))

    cfg = Config(**TINY)
    jm = JMaskRCNN.from_config(cfg, mode="inference")
    anchors = j_anchors(cfg)
    image = np.random.RandomState(2).uniform(
        -1, 1, (1, 64, 64, 8, 1)).astype(np.float32)
    jout = jax.jit(lambda v, x: jm.apply(
        v, x, anchors, method=JMaskRCNN.forward_rpn))(want, image)
    with torch.no_grad():
        model.bn_mode(False)
        tout = model.forward_rpn(torch.from_numpy(image),
                                 torch.from_numpy(anchors))
    for k in ("rpn_class_logits", "rpn_bbox", "proposals"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **CLOSE)


# Both evaluation tasks through the CLI with .h5 weights --------------------

@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    """Two 64 x 64 x 8 volumes from the port's generator, one per split."""
    from m3d_torch.data import synthetic as T_syn

    d = str(tmp_path_factory.mktemp("h5_eval_data"))
    T_syn.generate_experiment(2, 64, d, seed=11, image_depth=8)
    T_syn.split_dataset(d, test_ratio=0.5)
    return d


@pytest.mark.parametrize("task", ["MRCNN_EVALUATION", "RPN_EVALUATION"])
def test_cli_evaluation_with_h5_weights(task, eval_data, tmp_path):
    """RPN_EVALUATION and MRCNN_EVALUATION run to their end with
    keras231_tiny.h5 as their weights, every weight of the file restored
    (loaded == its 92 leaves, none skipped)."""
    out = str(tmp_path / "out")
    path = _fixture("keras231_tiny")
    cfg_path = str(tmp_path / "tiny.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(TINY, DATA_DIR=eval_data, OUTPUT_DIR=out,
                       CLASS_NAMES=["object"], RPN_WEIGHTS=path,
                       HEAD_WEIGHTS=path, MIN_ROI_SIZE=8,
                       EVALUATION_STEPS=1), f)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = cli.main(["--task", task, "--config_path", cfg_path,
                        "--device", "cpu"])
    lines = [ln for ln in printed.getvalue().splitlines()
             if "] restored " in ln]
    assert len(lines) == (2 if task == "MRCNN_EVALUATION" else 1), lines
    for ln in lines:
        stats = json.loads(ln.split(": ", 1)[1].replace("'", '"'))
        assert stats["loaded"] == FIXTURES["keras231_tiny"], ln
        assert stats["skipped"] == stats["sliced"] == 0, ln
    if task == "MRCNN_EVALUATION":
        assert len(res["per_image"]) == 1
        assert sorted(f for f in os.listdir(out) if f != "overlays") == [
            "000000.csv", "000000.tiff", "evaluation_summary.json"]
    else:
        assert "det@0.5_top500" in res
