"""Flax msgpack checkpoints -> torch state dicts (port of the loading half of
m3d/train/checkpoints.py: ``load_params`` and ``restore_by_name``).

The JAX package saves its parameter trees with
``flax.serialization.msgpack_serialize``. This module reads those files with
its own small msgpack decoder, so the port needs neither ``msgpack`` nor
``flax``. Only the subset flax writes is decoded: maps, arrays, str, bin,
nil/bool, ints, floats, and the ext types flax registers (1 = ndarray as
``(shape, dtype name, raw bytes)``, 2 = complex, 3 = numpy scalar), plus
flax's chunked-array dicts for leaves over 1 GiB.

``params_from_jax`` turns the nested flax tree into the port's state dict:
the module path keeps flax's names (``resnet/Bottleneck_0/res2a_branch2a``
becomes ``resnet.Bottleneck_0.res2a_branch2a``), kernels change layout, and
f16 storage is cast back to float32. The conversion happens in memory at load
time; nothing converted is written to disk.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# Modules stored as flax ConvTranspose(transpose_kernel=False). Flax computes
# out[s*i + j] = x[i] * W[k-1-j] for stride s == kernel k; torch's
# ConvTranspose3d computes x[i] * W[j], so the kernel is flipped on every
# spatial axis (pinned by tests/test_torch_models.py).
TRANSPOSED_CONVS = ("mrcnn_mask_deconv",)

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


class _Reader:
    """Decoder for the msgpack subset flax writes."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H",
                                                0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code in (1, 3):      # ndarray / numpy scalar
            shape, dtype, raw = _Reader(payload).value()
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
            return arr[()] if code == 3 else arr
        if code == 2:           # native complex
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    """Reassemble flax's chunked-array dicts (leaves over 1 GiB)."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode flax ``msgpack_serialize`` bytes into a nested dict of numpy
    arrays (the same tree ``flax.serialization.msgpack_restore`` returns)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(tree)


def load_params(path: str):
    """Read a flax msgpack checkpoint. Returns (tree, sidecar metadata)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return tree, meta


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Flax variables ``{"params": ..., "batch_stats": ...}`` -> state dict.

    Layout changes: conv kernels [ky,kx,kz,Cin,Cout] -> [Cout,Cin,ky,kx,kz];
    transposed-conv kernels -> [Cin,Cout,ky,kx,kz] flipped on every spatial
    axis; dense kernels [in,out] -> [out,in]. Every tensor becomes float32.
    """
    out = {}
    for path, leaf in _flatten(tree):
        if path[0] not in ("params", "batch_stats") or len(path) < 2:
            continue
        *mod, name = path[1:]
        if name not in _LEAF_NAMES:
            continue
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        if name == "kernel" and arr.ndim == 5:
            if mod and mod[-1] in TRANSPOSED_CONVS:
                arr = np.flip(arr.transpose(3, 4, 0, 1, 2), axis=(2, 3, 4))
            else:
                arr = arr.transpose(4, 3, 0, 1, 2)
        elif name == "kernel" and arr.ndim == 2:
            arr = arr.T
        key = ".".join(mod + [_LEAF_NAMES[name]])
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def restore_by_name(model: torch.nn.Module, state: dict[str, torch.Tensor]):
    """Copy ``state`` into ``model`` by exact name with shape checks.

    Returns stats {"loaded", "skipped", "missing"}: checkpoint tensors
    copied, checkpoint tensors with no same-shaped counterpart, and model
    tensors the checkpoint does not hold.
    """
    own = model.state_dict()
    stats = {"loaded": 0, "skipped": 0, "missing": 0}
    with torch.no_grad():
        for key, val in state.items():
            tgt = own.get(key)
            if tgt is None or tuple(tgt.shape) != tuple(val.shape):
                stats["skipped"] += 1
                continue
            tgt.copy_(val)
            stats["loaded"] += 1
    stats["missing"] = sum(1 for k in own if k not in state)
    return stats
