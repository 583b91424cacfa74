"""The port's native host library (m3d_torch/native.py,
m3d_torch/csrc/m3d_native.cpp) against m3d's (m3d/native) and the numpy
plain versions, the build's failure path, and the port's MRC IO
(m3d_torch/utils/mrcio.py) against m3d's.
"""

import ctypes
import fcntl
import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np
import pytest

from m3d.utils import mrcio as J_mrc
from m3d_torch import native
from m3d_torch.ops.cuda_build import CudaLibrary, gxx
from m3d_torch.ops.nms3d import nms_3d_numpy
from m3d_torch.utils import mrcio as T_mrc
from m3d_torch.utils import tiffio as T_tiff
from m3d_torch.utils.metrics import overlaps_3d_numpy


def _build_jax_native(jn) -> None:
    """Build m3d/native's library with JAX's own command (m3d/native/
    __init__.py ``_build``: the same flags, so its IoU stays bit-equal)
    into a file of this process, then move it onto the library's path in
    one ``os.replace``."""
    tmp = f"{jn._LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, jn._SRC, "-lpthread"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, jn._LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def jax_native():
    """m3d.native with its library loaded, race-free across test processes.

    JAX builds the library at first use through one shared ``.tmp`` path,
    so processes that build it at once can move a half-written file into
    place ("file too short") and leave JAX on its numpy fallbacks. Here,
    under an exclusive lock, a missing, stale or unloadable library is
    built by this process into a file of its own and moved into place
    before JAX loads it; JAX then finds it fresh and builds nothing."""
    from m3d import native as jn

    if jn._lib:
        return jn
    lock = os.path.join(tempfile.gettempdir(), "m3d_native_build.lock")
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for _ in range(3):
                fresh = (os.path.exists(jn._LIB_PATH)
                         and os.path.getmtime(jn._LIB_PATH)
                         >= os.path.getmtime(jn._SRC))
                if not (fresh and _loads(jn._LIB_PATH)):
                    _build_jax_native(jn)
                jn._lib = None
                if jn.available():
                    break
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    assert jn.available(), "m3d.native does not build here"
    return jn


def _boxes(rng, n, span=60.0):
    """[n, 6] boxes, corners in either order on some rows."""
    lo = rng.uniform(0, span, (n, 3))
    b = np.concatenate([lo, lo + rng.uniform(0.5, 20, (n, 3))], 1)
    flip = rng.rand(n) < 0.1
    b[flip] = b[flip][:, [3, 4, 5, 0, 1, 2]]
    return b.astype(np.float32)


@pytest.mark.parametrize("shape", [(20000, 9), (7, 300), (0, 4), (5, 0)])
def test_iou_matrix_bit_equal_to_jax_library(shape):
    """The port's IoU equals JAX's library bit for bit (the same source and
    flags), threaded (20000 anchors) or not; against numpy within one
    float32 rounding, with the same best anchor per GT and GT per anchor
    on these boxes."""
    jn = jax_native()
    rng = np.random.RandomState(sum(shape))
    a, b = _boxes(rng, shape[0]), _boxes(rng, shape[1])
    got = native.iou_matrix_3d(a, b)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, jn.iou_matrix_3d(a, b))
    ref = overlaps_3d_numpy(a, b)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if got.size:
        assert (got.argmax(0) == ref.argmax(0)).all()
        assert (got.argmax(1) == ref.argmax(1)).all()


@pytest.mark.parametrize("case", ["random", "ties", "zero_boxes",
                                  "max_output_0"])
def test_nms_matches_jax_and_numpy(case):
    """Kept indices equal to JAX's library's and to nms_3d_numpy's: random
    boxes, many equal scores (stable order), no boxes, no room."""
    jn = jax_native()
    rng = np.random.RandomState(7)
    n = 0 if case == "zero_boxes" else 2000
    boxes = _boxes(rng, n, span=40.0)
    boxes[:, 3:] = np.maximum(boxes[:, 3:], boxes[:, :3] + 0.5)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4) / 4
    k = 0 if case == "max_output_0" else 400
    for thr in (0.3, 0.7):
        got = native.nms_3d_host(boxes, scores, thr, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jn.nms_3d_host(boxes, scores,
                                                          thr, k))
        np.testing.assert_array_equal(got, nms_3d_numpy(boxes, scores, thr,
                                                        k))


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "compressed"])
def test_read_tiff_volume(dtype, tmp_path):
    """8- and 16-bit volumes read equal to the port's numpy reader and
    JAX's library; a compressed file is None (the caller's reader takes
    over, and imread_volume still reads it)."""
    rng = np.random.RandomState(4)
    path = str(tmp_path / "v.tiff")
    if dtype == "compressed":
        from PIL import Image

        vol = rng.randint(0, 4, (3, 16, 12)).astype(np.uint8)
        pages = [Image.fromarray(p) for p in vol]
        pages[0].save(path, save_all=True, append_images=pages[1:],
                      compression="tiff_deflate")
        assert native.read_tiff_volume(path) is None
        np.testing.assert_array_equal(T_tiff.imread_volume(path), vol)
        return
    vol = rng.randint(0, np.iinfo(dtype).max, (5, 17, 9)).astype(dtype)
    T_tiff.imwrite_volume(path, vol)
    got = native.read_tiff_volume(path)
    want = T_tiff._read_numpy(path)
    assert got.dtype == want.dtype == vol.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native().read_tiff_volume(path))
    np.testing.assert_array_equal(T_tiff.imread_volume(path), vol)


def test_broken_source_raises_with_compiler_output(tmp_path):
    """A source g++ refuses raises RuntimeError with g++'s own message and
    leaves no library behind; the library's own build is cached."""
    assert native.available()
    assert os.path.exists(native.LIB.path())
    broken = str(tmp_path / "m3d_native.cpp")
    shutil.copy(native.LIB.source, broken)
    with open(broken, "a") as f:
        f.write("\nint broken( { return 0; }\n")
    lib = CudaLibrary("m3d_native", native.LIB.functions, compiler=gxx,
                      flags=native.LIB.flags, ext=".cpp")
    lib.source = broken
    with pytest.raises(RuntimeError, match=r"g\+\+ .*failed") as err:
        lib.load()
    assert "error" in str(err.value) and "broken" in str(err.value)
    assert not os.path.exists(lib.path())


# MRC IO ---------------------------------------------------------------

MRC_MODES = {0: np.int8, 1: np.int16, 2: np.float32, 6: np.uint16,
             12: np.float16}


@pytest.mark.parametrize("mode", sorted(MRC_MODES))
def test_write_mrc_bytes_equal_jax(mode, tmp_path):
    """write_mrc's bytes equal JAX's for every mode; read_mrc gives the
    volume back, as JAX's does."""
    rng = np.random.RandomState(mode)
    vol = (rng.randn(5, 6, 7) * 50).astype(MRC_MODES[mode])
    paths = [str(tmp_path / f"{p}.mrc") for p in ("port", "jax")]
    T_mrc.write_mrc(paths[0], vol)
    J_mrc.write_mrc(paths[1], vol)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got = T_mrc.read_mrc(paths[0])
    assert got.dtype == vol.dtype
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, J_mrc.read_mrc(paths[0]))


@pytest.mark.parametrize("case", ["big_endian", "extended_header",
                                  "float64_as_mode_2"])
def test_read_mrc_matches_jax(case, tmp_path):
    """A big-endian file and one with a 96-byte extended header read equal
    in both packages; a float64 volume is written as mode 2."""
    rng = np.random.RandomState(1)
    vol = rng.randn(4, 3, 5).astype(np.float32)
    path = str(tmp_path / "x.mrc")
    if case == "float64_as_mode_2":
        T_mrc.write_mrc(path, vol.astype(np.float64))
    else:
        T_mrc.write_mrc(path, vol)
        with open(path, "rb") as f:
            header, data = bytearray(f.read(1024)), f.read()
        if case == "big_endian":
            words = np.frombuffer(bytes(header[:224]), "<i4").astype(">i4")
            header[:224] = words.tobytes()
            data = np.frombuffer(data, "<f4").astype(">f4").tobytes()
        else:
            header[92:96] = struct.pack("<i", 96)
            data = bytes(range(96)) + data
        with open(path, "wb") as f:
            f.write(bytes(header) + data)
    got, want = T_mrc.read_mrc(path), J_mrc.read_mrc(path)
    assert got.dtype == want.dtype and got.shape == want.shape == (4, 3, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol)
