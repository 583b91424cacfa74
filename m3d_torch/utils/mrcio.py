"""Minimal MRC2014 volume reader/writer in numpy (the port's copy of
m3d/utils/mrcio.py).

The reference's HeLa pipeline reads .mrc microscopy stacks with the
``mrcfile`` package inside prepocess.ipynb; the format is simple enough
not to want that dependency: a fixed 1024-byte
header (56 int32/float32 words + text labels) followed by the voxel data,
plus an optional extended header.

Supports the modes the microscopy world actually uses:
  0 int8, 1 int16, 2 float32, 6 uint16, 12 float16.
Axis order on disk is (z, y, x) fastest-x — returned as-is, shape (nz, ny, nx),
matching how the reference's notebook consumes mrcfile data.
"""

from __future__ import annotations

import numpy as np

_MODE_DTYPES = {
    0: np.int8,
    1: np.int16,
    2: np.float32,
    6: np.uint16,
    12: np.float16,
}

_HEADER_BYTES = 1024
_MAP_OFFSET = 208  # 'MAP ' id, word 53
_EXT_OFFSET = 92   # NSYMBT: extended header bytes, word 24


def read_mrc(path: str) -> np.ndarray:
    """Read an MRC volume; returns shape (nz, ny, nx)."""
    with open(path, "rb") as f:
        header = f.read(_HEADER_BYTES)
        if len(header) < _HEADER_BYTES:
            raise ValueError(f"{path}: truncated MRC header")
        # Byte order: the MACHST stamp (word 54) or a sanity check on mode.
        for order in ("<", ">"):
            words = np.frombuffer(header, dtype=order + "i4", count=56)
            nx, ny, nz, mode = (int(w) for w in words[:4])
            if 0 <= mode <= 16 and 0 < nx < 1 << 20 and 0 < ny < 1 << 20:
                break
        else:
            raise ValueError(f"{path}: unrecognizable MRC header")
        if mode not in _MODE_DTYPES:
            raise ValueError(f"{path}: unsupported MRC mode {mode}")
        ext = int(np.frombuffer(header, dtype=order + "i4",
                                count=1, offset=_EXT_OFFSET)[0])
        f.seek(_HEADER_BYTES + max(0, ext))
        dtype = np.dtype(_MODE_DTYPES[mode]).newbyteorder(order)
        data = np.fromfile(f, dtype=dtype, count=nx * ny * nz)
    if data.size != nx * ny * nz:
        raise ValueError(f"{path}: truncated MRC data "
                         f"({data.size} of {nx * ny * nz} voxels)")
    return data.reshape(nz, ny, nx)


def write_mrc(path: str, volume: np.ndarray) -> None:
    """Write a (nz, ny, nx) volume as little-endian MRC2014."""
    volume = np.asarray(volume)
    assert volume.ndim == 3, f"expected 3-D volume, got {volume.shape}"
    mode = {np.dtype(v): k for k, v in _MODE_DTYPES.items()}.get(
        volume.dtype.newbyteorder("="))
    if mode is None:
        volume = volume.astype(np.float32)
        mode = 2
    nz, ny, nx = volume.shape
    header = np.zeros(256, dtype="<i4")
    header[0:3] = (nx, ny, nz)
    header[3] = mode
    header[7:10] = (nx, ny, nz)          # mx, my, mz
    fheader = header.view("<f4")
    fheader[10:13] = (nx, ny, nz)        # cell dims (1 A voxels)
    fheader[13:16] = 90.0                # cell angles
    header[16:19] = (1, 2, 3)            # axis mapping
    fheader[19] = float(volume.min())
    fheader[20] = float(volume.max())
    fheader[21] = float(volume.mean())
    header[_MAP_OFFSET // 4] = int.from_bytes(b"MAP ", "little")
    header[(_MAP_OFFSET + 4) // 4] = int.from_bytes(
        bytes((0x44, 0x44, 0, 0)), "little")  # little-endian MACHST
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(volume, dtype="<" + {
            0: "i1", 1: "i2", 2: "f4", 6: "u2", 12: "f2"}[mode]).tobytes())
