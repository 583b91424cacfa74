"""Read-only HDF5 reader in numpy, for Keras weight files.

The card's machine has no h5py, so the port reads the reference's Keras
``.h5`` checkpoints itself, as ``checkpoints.py`` reads flax msgpack. Only
the subset that h5py writes for such files under its default (earliest)
format bounds is parsed:

- superblock version 0 or 1 (after an optional user block);
- version-1 object headers, with continuation blocks;
- old-style groups: a symbol-table message, a version-1 B-tree of any depth
  over symbol-table nodes, and the local heap holding the names;
- dataspaces: scalar, simple, null;
- datatypes: fixed-point, IEEE float in either byte order, fixed-length
  strings (read as numpy ``S`` arrays, as h5py reads them);
- data layout version 3, contiguous or compact; an unallocated empty
  dataset reads as an empty array;
- attribute messages versions 1-3 (version 1 pads name, datatype and
  dataspace to 8 bytes).

Anything else (a filter pipeline, a chunked layout, a variable-length
string, a version-2 object header, superblock version 2 or later, new-style
groups, dense attribute storage, shared messages) raises
``UnsupportedHdf5`` naming the feature.

    with File(path) as f:
        names = f.attrs["layer_names"]      # numpy array of bytes
        kernel = np.asarray(f["conv1/conv1/kernel:0"])

Values are copies: nothing refers to the file once it is closed.
"""

from __future__ import annotations

import mmap
import os

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Object header message types.
_DATASPACE, _LINK_INFO, _DATATYPE, _LAYOUT = 0x01, 0x02, 0x03, 0x08
_LINK, _EXTERNAL, _GROUP_INFO, _FILTERS = 0x06, 0x07, 0x0A, 0x0B
_ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0x0C, 0x10, 0x11, 0x15
_REFUSED = {_LINK_INFO: "new-style group (link info message)",
            _LINK: "new-style group (link message)",
            _GROUP_INFO: "new-style group (group info message)",
            _EXTERNAL: "external data storage",
            _FILTERS: "filter pipeline (compressed or filtered dataset)",
            _ATTR_INFO: "dense attribute storage"}
_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
            7: "reference", 8: "enum", 10: "array"}


class UnsupportedHdf5(ValueError):
    """An HDF5 file, or a part of one, that this reader does not parse."""


class Empty:
    """The value of a null dataspace (h5py's ``h5py.Empty``)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class Attrs(dict):
    """An object's attributes. One this reader does not parse (a
    variable-length string, say) raises ``UnsupportedHdf5`` when it is
    read, not when the object is opened."""

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        if isinstance(value, UnsupportedHdf5):
            raise value
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default


class File:
    """An open HDF5 file; the root group's interface (``keys``, ``attrs``,
    ``[path]``, ``in``, ``visititems``) is the file's."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            size = os.fstat(self._fh.fileno()).st_size
            if size < 64:
                raise UnsupportedHdf5(f"{path}: not an HDF5 file "
                                      f"({size} bytes)")
            self._buf = mmap.mmap(self._fh.fileno(), 0,
                                  access=mmap.ACCESS_READ)
            self.root = self._superblock(size)
        except BaseException:
            self.close()
            raise

    # -- low-level reads -------------------------------------------------
    def _int(self, pos: int, n: int) -> int:
        return int.from_bytes(self._buf[pos:pos + n], "little")

    def _addr(self, pos: int):
        """An address field (``offset_size`` bytes) at ``pos``: the file
        position it names, or None for the undefined address."""
        v = self._int(pos, self.so)
        return None if v == (1 << (8 * self.so)) - 1 else self.base + v

    def _array(self, pos: int, dtype: np.dtype, shape) -> np.ndarray:
        count = int(np.prod(shape, dtype=np.int64))
        if count == 0:
            return np.zeros(shape, dtype)
        if pos + count * dtype.itemsize > len(self._buf):
            raise UnsupportedHdf5(f"{self.path}: data past the end of the "
                                  f"file (truncated?)")
        return np.frombuffer(self._buf, dtype, count, pos).copy().reshape(
            shape)

    # -- structure ---------------------------------------------------------
    def _superblock(self, size: int):
        base = 0
        while self._buf[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2  # user block sizes
            if base + 64 > size:
                raise UnsupportedHdf5(f"{self.path}: not an HDF5 file (no "
                                      f"superblock signature)")
        version = self._buf[base + 8]
        if version > 1:
            raise UnsupportedHdf5(f"{self.path}: superblock version "
                                  f"{version} (only 0 and 1 are read)")
        self.so, self.sl = self._buf[base + 13], self._buf[base + 14]
        pos = base + 24 + (4 if version == 1 else 0)
        self.base = 0
        self.base = self._addr(pos)     # base address of every address
        pos += 4 * self.so              # base, free-space, EOF, VFD info
        return self._object(self._addr(pos + self.so), "/")

    def _messages(self, pos: int):
        """(type, data position, size) of every message of the version-1
        object header at ``pos``, continuation blocks followed."""
        if self._buf[pos:pos + 4] == b"OHDR":
            raise UnsupportedHdf5(f"{self.path}: version-2 object header")
        if self._buf[pos] != 1:
            raise UnsupportedHdf5(f"{self.path}: object header version "
                                  f"{self._buf[pos]}")
        blocks = [(pos + 16, self._int(pos + 8, 4))]
        out = []
        while blocks:
            p, length = blocks.pop(0)
            end = p + length
            while p + 8 <= end:
                mtype, msize = self._int(p, 2), self._int(p + 2, 2)
                flags, data = self._buf[p + 4], p + 8
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(data),
                                   self._int(data + self.so, self.sl)))
                elif flags & 0x02:
                    raise UnsupportedHdf5(f"{self.path}: shared object "
                                          f"header message (type {mtype})")
                elif mtype in _REFUSED:
                    raise UnsupportedHdf5(f"{self.path}: {_REFUSED[mtype]}")
                else:
                    out.append((mtype, data, msize))
                p = data + msize
        return out

    def _dtype(self, p: int) -> np.dtype:
        cls, bits = self._buf[p] & 0x0F, self._int(p + 1, 3)
        size = self._int(p + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            return np.dtype(f"{order}f{size}")
        if cls == 3:
            return np.dtype(f"S{size}")
        if cls == 9:
            what = "string" if bits & 0x0F == 1 else "sequence"
            raise UnsupportedHdf5(f"{self.path}: variable-length {what}")
        name = {0: "fixed-point", 1: "floating-point"}.get(
            cls, _CLASSES.get(cls, str(cls)))
        raise UnsupportedHdf5(f"{self.path}: {name} datatype of {size} "
                              f"bytes (bit field 0x{bits:06x})")

    def _shape(self, p: int):
        """A dataspace: its shape, () for scalar, None for null."""
        version, ndims = self._buf[p], self._buf[p + 1]
        if version == 1:
            kind, p = (1 if ndims else 0), p + 8
        elif version == 2:
            kind, p = self._buf[p + 3], p + 4
        else:
            raise UnsupportedHdf5(f"{self.path}: dataspace version "
                                  f"{version}")
        if kind == 2:
            return None
        return tuple(self._int(p + i * self.sl, self.sl)
                     for i in range(ndims if kind else 0))

    def _attribute(self, d: int):
        version = self._buf[d]
        if version not in (1, 2, 3):
            raise UnsupportedHdf5(f"{self.path}: attribute message version "
                                  f"{version}")
        name_n, type_n, space_n = (self._int(d + 2 + 2 * i, 2)
                                   for i in range(3))
        pad = _pad8 if version == 1 else (lambda n: n)
        p = d + (9 if version == 3 else 8)
        name = bytes(self._buf[p:p + name_n]).split(b"\0")[0].decode()
        p += pad(name_n)
        try:
            dtype = self._dtype(p)
            p += pad(type_n)
            shape = self._shape(p)
            p += pad(space_n)
        except UnsupportedHdf5 as err:
            return name, err            # raised when the attribute is read
        if shape is None:
            return name, Empty(dtype)
        value = self._array(p, dtype, shape)
        return name, (value[()] if shape == () else value)

    def _object(self, pos: int, name: str):
        msgs = self._messages(pos)
        attrs = Attrs(self._attribute(d) for t, d, _ in msgs
                      if t == _ATTRIBUTE)
        by_type = {t: d for t, d, _ in msgs}
        if _SYMBOL_TABLE in by_type:
            d = by_type[_SYMBOL_TABLE]
            return Group(self, name, attrs, self._addr(d),
                         self._addr(d + self.so))
        if _LAYOUT in by_type:
            return Dataset(self, name, attrs, self._dtype(by_type[_DATATYPE]),
                           self._shape(by_type[_DATASPACE]),
                           by_type[_LAYOUT])
        raise UnsupportedHdf5(f"{self.path}: object {name} is neither an "
                              f"old-style group nor a dataset")

    def _children(self, btree: int, heap: int) -> dict:
        """{name: object header position} of a symbol-table group, in the
        B-tree's (name) order."""
        if self._buf[heap:heap + 4] != b"HEAP":
            raise UnsupportedHdf5(f"{self.path}: bad local heap signature")
        names = self._addr(heap + 8 + 2 * self.sl)
        entry = 2 * self.so + 24        # one symbol-table entry's bytes
        out: dict = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop(0)
            if self._buf[node:node + 4] != b"TREE" or self._buf[node + 4]:
                raise UnsupportedHdf5(f"{self.path}: bad group B-tree node")
            level, used = self._buf[node + 5], self._int(node + 6, 2)
            p = node + 8 + 2 * self.so + self.sl   # siblings, first key
            kids = []
            for _ in range(used):
                kids.append(self._addr(p))
                p += self.so + self.sl
            if level:
                nodes[:0] = kids                   # depth first, in order
                continue
            for snod in kids:
                if self._buf[snod:snod + 4] != b"SNOD":
                    raise UnsupportedHdf5(f"{self.path}: bad symbol-table "
                                          f"node")
                for i in range(self._int(snod + 6, 2)):
                    e = snod + 8 + i * entry
                    off = names + self._int(e, self.so)
                    end = self._buf.find(b"\0", off)
                    out[bytes(self._buf[off:end]).decode()] = self._addr(
                        e + self.so)
        return out

    # -- the root group's interface -----------------------------------------
    @property
    def attrs(self) -> dict:
        return self.root.attrs

    def keys(self):
        return self.root.keys()

    def __contains__(self, path) -> bool:
        return path in self.root

    def __getitem__(self, path: str):
        return self.root[path]

    def visititems(self, fn):
        return self.root.visititems(fn)

    def close(self) -> None:
        buf = getattr(self, "_buf", None)
        if buf is not None:
            buf.close()
            self._buf = None
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Group:
    """A symbol-table group: ``keys()`` in name order, ``attrs``, ``[path]``
    (``"a/b"`` walks subgroups), ``in``, ``visititems``."""

    def __init__(self, file: File, name: str, attrs: dict, btree, heap):
        self.file, self.name, self.attrs = file, name, attrs
        self._btree, self._heap = btree, heap
        self._kids = None

    def _children(self) -> dict:
        if self._kids is None:
            self._kids = ({} if self._btree is None else
                          self.file._children(self._btree, self._heap))
        return self._kids

    def keys(self):
        return list(self._children())

    def _get(self, path: str):
        obj = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(obj, Group) or part not in obj._children():
                return None
            obj = self.file._object(obj._children()[part],
                                    f"{obj.name.rstrip('/')}/{part}")
        return obj

    def __contains__(self, path) -> bool:
        return isinstance(path, str) and self._get(path) is not None

    def __getitem__(self, path: str):
        obj = self._get(path)
        if obj is None:
            raise KeyError(f"{path} not in {self.name}")
        return obj

    def visititems(self, fn, _prefix: str = ""):
        """Call ``fn(relative name, object)`` on every object below this
        group, depth first in name order, as h5py does; stops at the first
        call that returns something other than None and returns it."""
        for key in self.keys():
            name = _prefix + key
            obj = self[key]
            out = fn(name, obj)
            if out is not None:
                return out
            if isinstance(obj, Group):
                out = obj.visititems(fn, name + "/")
                if out is not None:
                    return out
        return None


class Dataset:
    """A dataset: ``shape`` (None for a null dataspace), ``dtype``,
    ``attrs``, ``read()`` (also ``np.asarray(ds)``)."""

    def __init__(self, file: File, name: str, attrs: dict, dtype, shape,
                 layout: int):
        self.file, self.name, self.attrs = file, name, attrs
        self.dtype, self.shape = dtype, shape
        self._layout = layout

    def read(self):
        f, d = self.file, self._layout
        if self.shape is None:
            return Empty(self.dtype)
        version, cls = f._buf[d], f._buf[d + 1]
        if version != 3:
            raise UnsupportedHdf5(f"{f.path}: {self.name}: data layout "
                                  f"version {version}")
        if cls == 0:
            return f._array(d + 4, self.dtype, self.shape)
        if cls == 1:
            pos = f._addr(d + 2)
            if pos is None:
                if np.prod(self.shape, dtype=np.int64):
                    raise UnsupportedHdf5(f"{f.path}: {self.name}: storage "
                                          f"never allocated (fill value)")
                return np.zeros(self.shape, self.dtype)
            return f._array(pos, self.dtype, self.shape)
        what = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
        raise UnsupportedHdf5(f"{f.path}: {self.name}: {what} data layout")

    def __array__(self, dtype=None, copy=None):
        arr = self.read()
        return arr if dtype is None else arr.astype(dtype)
