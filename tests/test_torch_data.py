"""m3d_torch's data layer against m3d's: TIFF volume IO both ways, the
synthetic dataset tree, the manifest dataset loader, and the padded
inference inputs. Exact equality throughout.
"""

import filecmp
import os

import numpy as np
import pytest

from m3d.anchors import AnchorCache
from m3d.config import Config
from m3d.data import datasets as J_ds
from m3d.data import generators as J_gen
from m3d.data import synthetic as J_syn
from m3d.utils import tiffio as J_tiff
from m3d_torch.config import Config as TConfig
from m3d_torch.data import datasets as T_ds
from m3d_torch.data import generators as T_gen
from m3d_torch.data import synthetic as T_syn
from m3d_torch.utils import tiffio as T_tiff

DTYPES = [np.uint8, np.uint16]  # images and seg are uint8, labels uint16


def _volume(dtype, shape=(5, 17, 23), seed=0):
    info = np.iinfo(dtype)
    return np.random.RandomState(seed).randint(
        info.min, int(info.max) + 1, shape).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiff_jax_writes_port_reads(tmp_path, dtype):
    vol = _volume(dtype)
    path = str(tmp_path / "v.tiff")
    J_tiff.imwrite_volume(path, vol)
    got = T_tiff.imread_volume(path)
    assert got.dtype == vol.dtype
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(T_tiff._read_numpy(path), vol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiff_port_writes_jax_reads(tmp_path, dtype):
    vol = _volume(dtype, seed=1)
    path = str(tmp_path / "v.tiff")
    T_tiff.imwrite_volume(path, vol)
    got = J_tiff.imread_volume(path)           # the native reader
    assert got.dtype == vol.dtype
    np.testing.assert_array_equal(got, vol)
    pil = T_tiff._read_pil(path)               # and PIL
    assert pil.dtype == vol.dtype
    np.testing.assert_array_equal(pil, vol)


def test_tiff_unsupported_names_the_tag(tmp_path, monkeypatch):
    """A compressed TIFF goes to PIL; without PIL the error names the tag."""
    from PIL import Image

    path = str(tmp_path / "lzw.tiff")
    page = _volume(np.uint8, (1, 9, 11))[0]
    Image.fromarray(page).save(path, compression="tiff_lzw")
    np.testing.assert_array_equal(T_tiff.imread_volume(path)[0], page)
    np.testing.assert_array_equal(J_tiff.imread_volume(path)[0], page)
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("blocked: PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(T_tiff.UnsupportedTiff, match=r"259 \(Compression\)"):
        T_tiff.imread_volume(path)


def _tree(root):
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, f), root) for f in files]
    return sorted(out)


def test_generate_experiment_tree_matches_jax(tmp_path):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    J_syn.generate_experiment(2, 64, dj, seed=11, image_depth=8)
    J_syn.split_dataset(dj, test_ratio=0.5)
    T_syn.generate_experiment(2, 64, dt, seed=11, image_depth=8)
    T_syn.split_dataset(dt, test_ratio=0.5)
    files = _tree(dj)
    assert files == _tree(dt)
    assert len(files) == 5 * 2 + 2
    for rel in files:
        pj, pt = os.path.join(dj, rel), os.path.join(dt, rel)
        if rel.endswith(".tiff"):
            a, b = J_tiff.imread_volume(pj), T_tiff.imread_volume(pt)
            assert a.dtype == b.dtype == np.uint8 and a.shape == (8, 64, 64)
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(J_tiff.imread_volume(pt), a)
        elif rel.startswith("datasets"):        # manifests hold the root
            with open(pj) as fj, open(pt) as ft:
                assert ft.read().replace(dt, "<root>") == \
                    fj.read().replace(dj, "<root>")
        else:                                   # pickles, .dat, csvs
            assert filecmp.cmp(pj, pt, shallow=False), rel


def test_synthetic_cli_writes_the_tree(tmp_path):
    d = str(tmp_path / "cli")
    T_syn.main(["--train_dir", d, "--train_image_nb", "1", "--image_size",
                "64", "--image_depth", "8", "--seed", "3", "--split"])
    J_syn.generate_experiment(1, 64, str(tmp_path / "ref"), seed=3,
                              image_depth=8)
    assert [f for f in _tree(d) if not f.startswith("datasets")] == \
        _tree(str(tmp_path / "ref"))
    assert sorted(os.listdir(os.path.join(d, "datasets"))) == \
        ["test.csv", "train.csv"]


def _write_case(root, sep):
    """Two volumes from the generator, a manifest with separator ``sep``:
    image 0 as generated plus an invalid box and class ids 2 and 3 (folded
    into class 1 at NUM_CLASSES 2), image 1 with an empty .dat."""
    T_syn.generate_experiment(2, 64, root, seed=5, image_depth=8)
    cab0 = os.path.join(root, "classes_and_boxes", "000001.dat")
    with open(cab0, "a") as f:
        f.write("2\t3\t10\t10\t3\t20\t20\n")    # z2 == z1: invalid
    with open(cab0) as f:
        lines = f.read().splitlines()
    lines[0] = "3" + lines[0][1:]
    with open(cab0, "w") as f:
        f.write("\n".join(lines) + "\n")
    open(os.path.join(root, "classes_and_boxes", "000002.dat"), "w").close()
    os.makedirs(os.path.join(root, "datasets"), exist_ok=True)
    with open(os.path.join(root, "datasets", "test.csv"), "w") as f:
        f.write(sep.join(["Name", "Image_path", "cab", "Masks"]) + "\n")
        for nm in ("000001", "000002"):
            f.write(sep.join([
                nm, os.path.join(root, "images", f"{nm}.tiff"),
                os.path.join(root, "classes_and_boxes", f"{nm}.dat"),
                os.path.join(root, "masks", f"{nm}.pickle")]) + "\n")


@pytest.mark.parametrize("sep", [",", "\t"])
def test_toy_dataset_matches_jax(tmp_path, sep):
    root = str(tmp_path / "ds")
    _write_case(root, sep)
    ref, got = J_ds.ToyDataset(), T_ds.ToyDataset()
    for ds in (ref, got):
        ds.load_dataset(root, is_train=False, class_names=("object",))
        ds.prepare()
    assert got.image_info == ref.image_info
    assert got.image_info[0]["seg_path"] is None      # no segs column
    assert got.class_info == ref.class_info
    for i in range(2):
        np.testing.assert_array_equal(got.load_image(i), ref.load_image(i))
        for masks_needed in (False, True):
            r = ref.load_data(i, masks_needed=masks_needed)
            g = got.load_data(i, masks_needed=masks_needed)
            for a, b in zip(g, r):
                if b is None:
                    assert a is None
                else:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    boxes, cls, _ = got.load_data(0, masks_needed=False)
    assert set(cls.tolist()) == {1}                   # 3 folded into 1
    assert boxes.shape[0] == len(open(
        os.path.join(root, "classes_and_boxes", "000001.dat")).readlines()) - 1
    assert got.load_data(1)[2].shape == (64, 64, 8, 0)
    assert [x["id"] for x in got.filter_positive().image_info] == \
        [x["id"] for x in ref.filter_positive().image_info] == [0]


def test_get_input_prediction_pads_to_bucket(tmp_path):
    """A 60 x 60 x 6 volume pads to the 64 x 64 x 8 bucket."""
    root = str(tmp_path / "odd")
    os.makedirs(os.path.join(root, "images"))
    vol = _volume(np.uint8, (6, 60, 60), seed=9)      # (Z, Y, X) pages
    J_tiff.imwrite_volume(os.path.join(root, "images", "a.tiff"), vol)
    kw = dict(IMAGE_SIZE=64, IMAGE_DEPTH=8, NUM_CLASSES=2,
              RPN_ANCHOR_SCALES=(8, 16, 24, 32, 48))
    jds, tds = J_ds.ToyDataset(), T_ds.ToyDataset()
    for ds in (jds, tds):
        ds.add_image("dataset", 0, os.path.join(root, "images", "a.tiff"))
        ds.prepare()
    ref = J_gen.MrcnnGenerator(jds, Config(**kw), mode="inference",
                               shuffle=False).get_input_prediction(0)
    got = T_gen.MrcnnGenerator(tds, TConfig(**kw)).get_input_prediction(0)
    assert got.keys() == ref.keys()
    assert got["image"].shape == (1, 64, 64, 8, 1)
    for k in got:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), k)
    np.testing.assert_array_equal(
        got["anchors"], AnchorCache(Config(**kw), 1.0).get((64, 64, 8)))
    assert got["image_meta"][0, 1:4].tolist() == [60, 60, 6]
    assert got["image_meta"][0, 5:8].tolist() == [64, 64, 8]


@pytest.mark.parametrize("n,axis", [(5, 0), (2, 0), (4, 1), (3, 1)])
def test_pad_to_matches_jax(n, axis):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4) + 1
    got = T_gen.pad_to(arr, n, axis)
    np.testing.assert_array_equal(got, J_gen.pad_to(arr, n, axis))
    assert got.shape[axis] == n
