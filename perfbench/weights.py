"""Weights that the benchmark hands to the reference: read from a flax
msgpack checkpoint with the benchmark's own decoder (a frozen copy of the
port's msgpack subset reader and layout conversion), or made from the seed
on the device.

``checkpoint_state(path)`` gives a state dict under the flax tree's names
in torch layouts (conv [Cout, Cin, k...], transposed conv [Cin, Cout, k...]
flipped on every spatial axis, dense [out, in]), float32. ``seeded_state``
draws a state dict for a module's own parameter shapes from a seed, on the
device, in one call per tensor kind.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}
TRANSPOSED_CONVS = ("mrcnn_mask_deconv",)


class _Reader:
    def __init__(self, data):
        self.buf, self.pos = memoryview(data), 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
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
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(
                {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                         0xC9: ">I"}[b]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(
                {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])), "utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        payload = self.take(n)
        if code in (1, 3):
            shape, dtype, raw = _Reader(payload).value()
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
            return arr[()] if code == 3 else arr
        raise ValueError(f"unsupported msgpack ext type {code}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def checkpoint_state(path: str) -> dict[str, torch.Tensor]:
    """State dict (CPU, float32) of a flax msgpack checkpoint's
    ``params`` and ``batch_stats``."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    out = {}
    for path_, leaf in _flatten(tree):
        if path_[0] not in ("params", "batch_stats") or len(path_) < 2:
            continue
        *mod, name = path_[1:]
        if name not in LEAF_NAMES:
            continue
        arr = np.array(leaf, dtype=np.float32)
        if name == "kernel" and arr.ndim == 5:
            if mod and mod[-1] in TRANSPOSED_CONVS:
                arr = np.flip(arr.transpose(3, 4, 0, 1, 2), axis=(2, 3, 4))
            else:
                arr = arr.transpose(4, 3, 0, 1, 2)
        elif name == "kernel" and arr.ndim == 2:
            arr = arr.T
        out[".".join(mod + [LEAF_NAMES[name]])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def seeded_state(shapes: dict[str, tuple], seed: int, device) -> dict:
    """A state dict for ``shapes`` (name -> shape) drawn from ``seed`` on
    ``device``: kernels normal with standard deviation sqrt(1 / fan in)
    (fan in = every axis but the output one; a transposed conv's output
    axis is 1), biases normal at 0.01, BatchNorm scales and variances
    uniform in [0.5, 1.5], means normal at 0.01: activations stay near unit scale through
    the residual stages, so scores and masks are not saturated. One draw of each kind
    covers every tensor of that kind, so a state costs a few calls."""
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    names = sorted(shapes)
    kinds = {"normal": [], "uniform": []}
    for n in names:
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "running_var" or (leaf == "weight" and len(shapes[n]) == 1):
            kinds["uniform"].append(n)
        else:
            kinds["normal"].append(n)
    out = {}
    for kind, group in kinds.items():
        sizes = [int(np.prod(shapes[n])) for n in group]
        total = sum(sizes)
        if kind == "normal":
            flat = torch.randn(total, generator=gen, device=device)
        else:
            flat = torch.rand(total, generator=gen, device=device) + 0.5
        for n, part in zip(group, torch.split(flat, sizes)):
            shape = tuple(shapes[n])
            t = part.reshape(shape)
            if kind == "normal":
                if n.endswith("weight") and len(shape) >= 2:
                    out_axis = 1 if n.rsplit(".", 2)[-2] in TRANSPOSED_CONVS \
                        else 0
                    t = t * (shape[out_axis] / int(np.prod(shape))) ** 0.5
                else:
                    t = t * 0.01
            out[n] = t.contiguous()
    return out
