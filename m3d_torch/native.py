"""The port's native host library (counterpart of m3d/native/__init__.py):
``csrc/m3d_native.cpp`` built with g++ at first use into
``m3d_torch/_build/m3d_native_<hash>.so`` (the JAX package's flags, so the
IoU matrices of the two libraries are equal bit for bit) and called with
ctypes. It runs three host hot loops:

- ``iou_matrix_3d``: the anchor x GT IoU of every RPN target assignment
  (``data/rpn_targets.py``), threaded over anchors;
- ``nms_3d_host``: the evaluation's final greedy NMS (``utils/unmold.py``);
- ``read_tiff_volume``: the dataset's TIFF decode (``utils/tiffio.py``).

There is no silent fallback: a failed build or load raises with g++'s
output. The numpy functions (``overlaps_3d_numpy``, ``nms_3d_numpy``, the
numpy TIFF reader) stay as the plain versions the library is held against.
``read_tiff_volume`` returns None for a file it does not parse (compressed,
big-endian, not 8- or 16-bit): a format rule, after which the caller's own
reader takes over.
"""

from __future__ import annotations

import ctypes

import numpy as np

from m3d_torch.ops.cuda_build import CudaLibrary, gxx

_F = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.POINTER(ctypes.c_int64)
LIB = CudaLibrary(
    "m3d_native",
    {"iou_matrix_3d": [_F, ctypes.c_int64, _F, ctypes.c_int64, _F,
                       ctypes.c_int],
     "nms_3d_host": [_F, _F, ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_int32)],
     "tiff_read_dims": [ctypes.c_char_p, _I64, _I64, _I64, _I64],
     "tiff_read_data": [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                        ctypes.c_int64]},
    link=("-lpthread",),
    restypes={"iou_matrix_3d": None, "nms_3d_host": ctypes.c_int64},
    compiler=gxx, flags=("-O3", "-std=c++17", "-shared", "-fPIC"),
    ext=".cpp")


def available() -> bool:
    """Whether the library builds and loads here (the call sites do not ask:
    they raise on a failed build)."""
    try:
        LIB.load()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(arr):
    return arr.ctypes.data_as(_F)


def iou_matrix_3d(boxes_a: np.ndarray, boxes_b: np.ndarray,
                  n_threads: int = 0) -> np.ndarray:
    """Pairwise IoU [A,6] x [G,6] -> [A,G] float32 (corners normalised as
    ``overlaps_3d_numpy`` does); ``n_threads`` 0 takes every core."""
    a = np.ascontiguousarray(boxes_a, np.float32)
    b = np.ascontiguousarray(boxes_b, np.float32)
    lib = LIB.load()
    out = np.empty((a.shape[0], b.shape[0]), np.float32)
    lib.iou_matrix_3d(_fptr(a), a.shape[0], _fptr(b), b.shape[0],
                      _fptr(out), n_threads)
    return out


def nms_3d_host(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
                max_output: int) -> np.ndarray:
    """Greedy NMS (stable descending score order, keep while IoU <=
    threshold) -> kept indices int32, at most ``max_output``."""
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    lib = LIB.load()
    keep = np.empty(max(int(max_output), 0), np.int32)
    n = lib.nms_3d_host(_fptr(b), _fptr(s), b.shape[0],
                        ctypes.c_float(iou_threshold), int(max_output),
                        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return keep[:n]


def read_tiff_volume(path: str):
    """Multi-page TIFF -> array [pages, H, W] (uint8 or uint16); None for a
    file the library does not parse."""
    lib = LIB.load()
    pages, h, w, bits = (ctypes.c_int64() for _ in range(4))
    rc = lib.tiff_read_dims(path.encode(), ctypes.byref(pages),
                            ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(bits))
    if rc != 0:
        return None
    dtype = np.uint8 if bits.value == 8 else np.uint16
    out = np.empty((pages.value, h.value, w.value), dtype)
    rc = lib.tiff_read_data(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes)
    return out if rc == 0 else None
