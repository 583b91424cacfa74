"""Flax msgpack checkpoints both ways, and the reference's Keras ``.h5``
files read (port of m3d/train/checkpoints.py: ``load_params``,
``save_params``, ``extract_subtree``, ``BestAndLatest``, ``restore_by_name``
with its suffix match and class-dim slicing, ``infer_head_params`` and
``autoconfigure_heads``).

The JAX package saves its parameter trees with
``flax.serialization.msgpack_serialize``. This module reads those files with
its own small msgpack decoder, and writes them with its own encoder
(``msgpack_serialize``: the bytes flax writes for a tree of dicts and
arrays), so the port needs neither ``msgpack`` nor ``flax``. Only the subset flax writes is decoded: maps, arrays, str, bin,
nil/bool, ints, floats, and the ext types flax registers (1 = ndarray as
``(shape, dtype name, raw bytes)``, 2 = complex, 3 = numpy scalar), plus
flax's chunked-array dicts for leaves over 1 GiB.

``params_from_jax`` turns the nested flax tree into the port's state dict:
the module path keeps flax's names (``resnet/Bottleneck_0/res2a_branch2a``
becomes ``resnet.Bottleneck_0.res2a_branch2a``), kernels change layout, and
f16 storage is cast back to float32. ``params_to_jax`` is its exact
inverse, so the port's checkpoints are flax trees that JAX's ``load_params``
and ``restore_by_name`` read.

Weights reach a model as they reach JAX's variables (``restore_weights``):
the file's tree is merged into the model's own flax tree by
``restore_tree_by_name`` (exact path, else the longest unique path suffix,
so a Keras file's layer-group names land; then the class-dim slice and the
cast to the model's dtype), and the merged tree is copied in by exact name.
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
# flax writes leaves over this many bytes in chunks; no model leaf is close.
MAX_CHUNK_SIZE = 2 ** 30


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


def _pack_int(n: int) -> bytes:
    """A non-negative int (array shapes are the only ints flax trees hold)."""
    if 0 <= n < 0x80:
        return bytes([n])
    for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer out of range: {n}")


def _pack_len(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a str / bin / array / map of n items (msgpack-python's
    choice of the smallest form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length too large: {n}")


def _pack(x, out: list) -> None:
    if isinstance(x, dict):
        # flax's jax.tree_util copy of the tree sorts every dict's keys.
        out.append(_pack_len(len(x), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I"))))
        for k in sorted(x):
            _pack(k, out)
            _pack(x[k], out)
    elif isinstance(x, (list, tuple)):
        out.append(_pack_len(len(x), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I"))))
        for v in x:
            _pack(v, out)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_pack_len(len(raw), 0xA0, 31,
                             ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))))
        out.append(raw)
    elif isinstance(x, bytes):
        out.append(_pack_len(len(x), None, 0,
                             ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))))
        out.append(x)
    elif isinstance(x, int):
        out.append(_pack_int(x))
    elif isinstance(x, np.ndarray):
        if x.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"array of {x.nbytes} bytes: flax would chunk "
                             f"it, which this writer does not do")
        payload = []
        _pack([list(x.shape), x.dtype.name, x.tobytes("C")], payload)
        payload = b"".join(payload)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(bytes([fixext[n]]))
        else:
            out.append(_pack_len(n, None, 0, ((0xC7, ">B"), (0xC8, ">H"),
                                              (0xC9, ">I"))))
        out.append(struct.pack(">b", 1))   # flax's ext type for ndarray
        out.append(payload)
    else:
        raise TypeError(f"cannot msgpack-encode {type(x).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts with str keys and numpy array leaves as
    ``flax.serialization.msgpack_serialize`` does, byte for byte."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def save_params(path: str, tree, metadata: dict | None = None) -> str:
    """Atomic write of a flax variables tree ({"params": ...,
    "batch_stats": ...} of numpy arrays, as ``params_to_jax`` gives) plus
    an optional JSON sidecar ``path + ".json"``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(tree))
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f)
    return path


def load_params(path: str):
    """Read a checkpoint: flax msgpack, or a reference Keras ``.h5`` /
    ``.hdf5`` translated to a flax-shaped tree keyed by layer name (as
    JAX's ``load_params`` does). Returns (tree, sidecar metadata)."""
    if path.endswith((".h5", ".hdf5")):
        from m3d_torch.utils.h5_import import load_keras_h5

        src_params, src_stats = load_keras_h5(path)
        tree = {"params": src_params}
        if src_stats:
            tree["batch_stats"] = src_stats
        return tree, {"format": "keras_h5"}
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


def params_to_jax(state: dict) -> dict:
    """State dict -> flax variables {"params": ..., "batch_stats": ...} of
    float32 numpy arrays: the exact inverse of ``params_from_jax``. A 1-D
    ``weight`` is a BatchNorm scale; 5-D weights are conv kernels (the
    transposed convs of TRANSPOSED_CONVS flipped back), 2-D dense."""
    tree: dict = {}
    names = {v: k for k, v in _LEAF_NAMES.items() if k != "scale"}
    for key, val in state.items():
        *mod, leaf = key.split(".")
        arr = val.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and arr.ndim == 1:
            name = "scale"
        else:
            name = names[leaf]
        if name == "kernel" and arr.ndim == 5:
            if mod and mod[-1] in TRANSPOSED_CONVS:
                arr = np.flip(arr, axis=(2, 3, 4)).transpose(2, 3, 4, 0, 1)
            else:
                arr = arr.transpose(2, 3, 4, 1, 0)
        elif name == "kernel" and arr.ndim == 2:
            arr = arr.T
        root = "batch_stats" if name in ("mean", "var") else "params"
        node = tree.setdefault(root, {})
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def extract_subtree(tree, prefixes=("mrcnn_",)):
    """Keep the leaves whose path has a component starting with one of
    ``prefixes`` (the head-only export)."""
    out: dict = {}
    for path, leaf in _flatten(tree):
        if any(part.startswith(p) for part in path for p in prefixes):
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = leaf
    return out


class BestAndLatest:
    """Per-epoch ``latest.msgpack`` and metric-gated ``best.msgpack``, each
    with a head-only ``_head`` export and JSON sidecars (RPN maximises its
    detection score, the heads minimise the validation loss)."""

    def __init__(self, save_dir: str, mode: str = "min"):
        self.save_dir = save_dir
        self.mode = mode
        self.best_metric = np.inf if mode == "min" else -np.inf
        os.makedirs(save_dir, exist_ok=True)

    def update(self, epoch: int, tree, metric: float,
               metadata: dict | None = None) -> bool:
        md = dict(metadata or {})
        md.update({"epoch": int(epoch), "metric": float(metric)})
        head = extract_subtree(tree)
        names = ["latest"]
        improved = (metric < self.best_metric if self.mode == "min"
                    else metric > self.best_metric)
        if improved:
            self.best_metric = metric
            names.append("best")
        for name in names:
            save_params(os.path.join(self.save_dir, f"{name}.msgpack"), tree,
                        md)
            save_params(os.path.join(self.save_dir, f"{name}_head.msgpack"),
                        head, md)
        return improved


def _try_class_slice(src, dst):
    """Slice src (a tensor or an array) down to dst when they differ in
    exactly one axis and src is larger there (class-count change,
    core/models.py:5064-5141)."""
    if src.ndim != dst.ndim:
        return None
    diff = [i for i in range(src.ndim) if src.shape[i] != dst.shape[i]]
    if len(diff) != 1:
        return None
    ax = diff[0]
    if src.shape[ax] < dst.shape[ax]:
        return None
    sl = [slice(None)] * src.ndim
    sl[ax] = slice(0, dst.shape[ax])
    return src[tuple(sl)]


def restore_tree_by_name(target, source, skip_mismatch: bool = True,
                         class_slice: bool = True, verbose: bool = False):
    """Merge the flax-shaped tree ``source`` into ``target`` by path name
    (JAX's ``restore_by_name``, on nested dicts of numpy arrays):

    - exact path and shape: the source's value;
    - otherwise the longest path suffix that names one source leaf (or one
      leaf ending in the whole target path): how a Keras file's layer
      groups, or a tree saved under another root, land;
    - a source larger in one axis is sliced down (class-count change);
    - every value is cast to its target leaf's dtype.

    Returns (merged tree, stats {"loaded", "sliced", "skipped",
    "missing"}), counted over the target's leaves.
    """
    sflat = {"/".join(k): np.asarray(v) for k, v in _flatten(source)}
    by_suffix: dict[str, list[tuple[str, np.ndarray]]] = {}
    for k, v in sflat.items():
        parts = k.split("/")
        for i in range(len(parts)):
            by_suffix.setdefault("/".join(parts[i:]), []).append((k, v))

    stats = {"loaded": 0, "sliced": 0, "skipped": 0, "missing": 0}
    out: dict = {}
    for path, tval in _flatten(target):
        key = "/".join(path)
        tval = np.asarray(tval)
        cand = sflat.get(key)
        if cand is None:
            for i in range(len(path)):
                matches = by_suffix.get("/".join(path[i:]), [])
                if len(matches) == 1:
                    cand = matches[0][1]
                    break
                exact = [m for m in matches if m[0].endswith(key)]
                if len(exact) == 1:
                    cand = exact[0][1]
                    break
        value = tval
        if cand is None:
            stats["missing"] += 1
        elif cand.shape == tval.shape:
            value = cand.astype(tval.dtype, copy=False)
            stats["loaded"] += 1
        elif class_slice and (part := _try_class_slice(cand, tval)) \
                is not None:
            value = part.astype(tval.dtype, copy=False)
            stats["sliced"] += 1
        elif skip_mismatch:
            if verbose:
                print(f"[restore_by_name] shape mismatch {key}: "
                      f"{cand.shape} vs {tval.shape}")
            stats["skipped"] += 1
        else:
            raise ValueError(
                f"shape mismatch for {key}: {cand.shape} vs {tval.shape}")
        node = out
        for part_name in path[:-1]:
            node = node.setdefault(part_name, {})
        node[path[-1]] = value
    return out, stats


def restore_by_name(model: torch.nn.Module, state: dict[str, torch.Tensor]):
    """Copy ``state`` into ``model`` by exact name with shape checks; a
    tensor larger than its target in one axis only is sliced down to it
    (class-count change), as the JAX package's ``restore_by_name`` does.

    Returns stats {"loaded", "sliced", "skipped", "missing"}: checkpoint
    tensors copied whole, checkpoint tensors copied sliced, checkpoint
    tensors with no counterpart of a usable shape, and model tensors the
    checkpoint does not hold.
    """
    own = model.state_dict()
    stats = {"loaded": 0, "sliced": 0, "skipped": 0, "missing": 0}
    with torch.no_grad():
        for key, val in state.items():
            tgt = own.get(key)
            if tgt is None:
                stats["skipped"] += 1
            elif tuple(tgt.shape) == tuple(val.shape):
                tgt.copy_(val)
                stats["loaded"] += 1
            elif (part := _try_class_slice(val, tgt)) is not None:
                tgt.copy_(part)
                stats["sliced"] += 1
            else:
                stats["skipped"] += 1
    stats["missing"] = sum(1 for k in own if k not in state)
    return stats


def restore_weights(model: torch.nn.Module, path: str) -> dict:
    """Restore a checkpoint file (flax msgpack or Keras ``.h5``) into
    ``model`` as JAX restores it into its variables: ``restore_tree_by_name``
    of the file's tree into the model's own flax tree, then the merged tree
    copied in by exact name. Returns the merge's stats (over the model's
    leaves, as JAX's)."""
    tree, _ = load_params(path)
    merged, stats = restore_tree_by_name(params_to_jax(model.state_dict()),
                                         tree)
    del tree
    restore_by_name(model, params_from_jax(merged))
    return stats


def infer_head_params(path: str) -> dict:
    """Recover head hyperparameters (POOL_SIZE, FPN_CLASSIF_FC_LAYERS_SIZE,
    HEAD_CONV_CHANNEL, NUM_CLASSES, TOP_DOWN_PYRAMID_SIZE) from a msgpack
    checkpoint's kernel shapes, the reference's introspection that adapts a
    config to the head widths a checkpoint was trained with
    (core/models.py:5144-5203); reference .h5 files through
    ``infer_head_params_from_h5``."""
    if path.endswith((".h5", ".hdf5")):
        from m3d_torch.utils.h5_import import infer_head_params_from_h5

        return infer_head_params_from_h5(path)
    tree, _ = load_params(path)
    found: dict = {}
    for keys, val in _flatten(tree):
        key = "/".join(keys)
        val = np.asarray(val)
        if key.endswith("mrcnn_class_conv1/kernel") and val.ndim == 5:
            found["POOL_SIZE"] = int(val.shape[0])
            found["FPN_CLASSIF_FC_LAYERS_SIZE"] = int(val.shape[-1])
            found["TOP_DOWN_PYRAMID_SIZE"] = int(val.shape[-2])
        elif key.endswith("mrcnn_mask_conv1/kernel") and val.ndim == 5:
            found["HEAD_CONV_CHANNEL"] = int(val.shape[-1])
        elif key.endswith("mrcnn_class_logits/kernel") and val.ndim == 2:
            found["NUM_CLASSES"] = int(val.shape[-1])
    return found


def autoconfigure_heads(config, paths):
    """Override config head hyperparameters from the first checkpoint that
    declares them. Returns the set of overridden keys."""
    overridden = set()
    for path in paths:
        if not path or not os.path.exists(path):
            continue
        try:
            found = infer_head_params(path)
        except Exception as e:  # noqa: BLE001 — introspection is best-effort
            print(f"[autoconfigure_heads] {path}: {e}")
            continue
        for key, val in found.items():
            if key in overridden:
                continue
            cur = getattr(config, key, None)
            if cur is not None and int(cur) != val:
                print(f"[autoconfigure_heads] {key}: config {cur} -> "
                      f"checkpoint {val} ({os.path.basename(path)})")
                setattr(config, key, val)
            overridden.add(key)
    return overridden
