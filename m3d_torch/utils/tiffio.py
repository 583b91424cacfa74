"""Multi-page TIFF volume IO (port of m3d/utils/tiffio.py).

Volumes are stored as multi-page TIFFs with axis 0 as the page axis. The
reader tries the native library's decoder first (``m3d_torch.native.
read_tiff_volume``, as the JAX package does; a failed build raises), which
parses uncompressed, little-endian, 8- or 16-bit unsigned grayscale pages
in strips. A file it does not parse goes to the numpy reader here (the
native decoder's plain version), then to PIL; without PIL it raises
``UnsupportedTiff`` naming the tag it cannot handle. The writer needs no
PIL: one strip per page, uncompressed, the layout the JAX package's PIL
writer gives with ``compression=None``.
"""

from __future__ import annotations

import struct

import numpy as np

from m3d_torch import native

_DTYPE_BITS = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}
_TAG_NAMES = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample",
              259: "Compression", 273: "StripOffsets",
              277: "SamplesPerPixel", 278: "RowsPerStrip",
              279: "StripByteCounts", 339: "SampleFormat"}
_SHORT, _LONG = 3, 4


class UnsupportedTiff(ValueError):
    """A TIFF the numpy reader does not parse."""


def imwrite_volume(path: str, volume: np.ndarray) -> None:
    """Write a 3-D uint8 or uint16 array as a multi-page TIFF (axis 0 =
    pages), uncompressed."""
    volume = np.asarray(volume)
    if volume.ndim != 3:
        raise ValueError(f"expected 3-D volume, got {volume.shape}")
    bits = _DTYPE_BITS.get(volume.dtype)
    if bits is None:
        raise ValueError(f"unsupported dtype {volume.dtype}: uint8 or uint16")
    pages, height, width = volume.shape
    page_bytes = height * width * bits // 8
    tags = [(256, _LONG, width), (257, _LONG, height), (258, _SHORT, bits),
            (259, _SHORT, 1), (262, _SHORT, 1), (273, _LONG, 0),
            (277, _SHORT, 1), (278, _LONG, height),
            (279, _LONG, page_bytes), (284, _SHORT, 1)]
    ifd_bytes = 2 + 12 * len(tags) + 4
    if 8 + pages * (ifd_bytes + page_bytes) >= 2**32:
        raise ValueError("volume too large for a 32-bit TIFF")
    out = bytearray(b"II*\x00" + struct.pack("<I", 8))
    data = np.ascontiguousarray(volume, dtype=volume.dtype.newbyteorder("<"))
    for i in range(pages):
        ifd = len(out)
        strip = ifd + ifd_bytes
        nxt = strip + page_bytes if i + 1 < pages else 0
        out += struct.pack("<H", len(tags))
        for tag, typ, val in tags:
            val = strip if tag == 273 else val
            fmt = "<HHIHH" if typ == _SHORT else "<HHII"
            out += struct.pack(fmt, tag, typ, 1, val,
                               *((0,) if typ == _SHORT else ()))
        out += struct.pack("<I", nxt)
        out += data[i].tobytes()
    with open(path, "wb") as f:
        f.write(out)


def _read_numpy(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or buf[:4] != b"II*\x00":
        raise UnsupportedTiff(f"{path}: not a little-endian classic TIFF "
                              f"(byte order / version header)")
    u16 = lambda o: struct.unpack_from("<H", buf, o)[0]  # noqa: E731
    u32 = lambda o: struct.unpack_from("<I", buf, o)[0]  # noqa: E731
    pages = []
    ifd = u32(4)
    while ifd:
        if ifd + 2 > len(buf):
            raise UnsupportedTiff(f"{path}: IFD offset {ifd} past the end")
        tags = {}
        for e in range(u16(ifd)):
            ent = ifd + 2 + 12 * e
            tag, typ, count = u16(ent), u16(ent + 2), u32(ent + 4)
            if typ not in (_SHORT, _LONG):
                tags[tag] = None  # a type the reader never needs
                continue
            size = 2 if typ == _SHORT else 4
            src = ent + 8 if count * size <= 4 else u32(ent + 8)
            fmt = "<H" if typ == _SHORT else "<I"
            tags[tag] = [struct.unpack_from(fmt, buf, src + size * i)[0]
                         for i in range(count)]
        ifd = u32(ifd + 2 + 12 * u16(ifd))

        def need(tag, allowed=None, default=None):
            val = tags.get(tag, None if default is None else [default])
            if val is None or (allowed is not None and val[0] not in allowed):
                raise UnsupportedTiff(
                    f"{path}: TIFF tag {tag} ({_TAG_NAMES[tag]}) = "
                    f"{None if val is None else val[:4]} is not supported"
                    + (f" (supported: {allowed})" if allowed else ""))
            return val

        need(259, (1,), default=1)
        need(277, (1,), default=1)
        need(339, (1,), default=1)
        bits = need(258, (8, 16), default=1)[0]
        width, height = need(256)[0], need(257)[0]
        offsets, counts = need(273), need(279)
        page = b"".join(buf[o:o + n] for o, n in zip(offsets, counts))
        if len(page) != width * height * bits // 8:
            raise UnsupportedTiff(
                f"{path}: TIFF tag 279 (StripByteCounts) sums to {len(page)}"
                f" bytes, not {width} x {height} x {bits // 8}")
        dtype = np.uint8 if bits == 8 else np.dtype("<u2")
        pages.append(np.frombuffer(page, dtype).reshape(height, width))
    if not pages:
        raise UnsupportedTiff(f"{path}: no image file directory")
    if len({p.shape for p in pages}) != 1:
        raise UnsupportedTiff(f"{path}: pages differ in TIFF tags 256/257 "
                              f"(ImageWidth/ImageLength)")
    return np.stack(pages).astype(pages[0].dtype.newbyteorder("="))


def _read_pil(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    frames = []
    try:
        i = 0
        while True:
            img.seek(i)
            frames.append(np.asarray(img))
            i += 1
    except EOFError:
        pass
    arr = np.stack(frames, axis=0)
    return arr[0] if arr.shape[0] == 1 and arr.ndim == 4 else arr


def imread_volume(path: str) -> np.ndarray:
    """Read a multi-page TIFF as a 3-D array (pages on axis 0): the native
    decoder first, then the numpy reader and PIL for formats it does not
    cover."""
    arr = native.read_tiff_volume(path)
    if arr is not None:
        return arr
    try:
        return _read_numpy(path)
    except UnsupportedTiff as err:
        try:
            import PIL  # noqa: F401
        except ImportError:
            raise err from None
    return _read_pil(path)
