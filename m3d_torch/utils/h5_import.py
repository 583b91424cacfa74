"""Keras-H5 checkpoints of the reference implementation (port of
m3d/utils/h5_import.py).

The reference trains and ships its weights as Keras H5 files. Every layer
of the model keeps the reference's layer name (res2a_branch2a, fpn_p2,
rpn_conv_shared1, mrcnn_class_conv1, ...), so such a file merges into a
flax-shaped variables tree by name:

  variables, stats = import_reference_h5(variables, "rpn_best.h5")

Layout translation (Keras -> flax tree, which ``params_from_jax`` turns
into the port's state dict):
  - Conv3D kernel  (k,k,k,in,out)      -> conv kernel, unchanged.
  - Conv3DTranspose kernel (k,k,k,out,in) -> (k,k,k,in,out): last two axes
    swapped.
  - Dense kernel   (in,out)            -> dense kernel, unchanged.
  - BatchNorm gamma/beta               -> params .../scale, .../bias.
  - BatchNorm moving_mean/moving_variance -> batch_stats .../mean, .../var,
    the variance shifted by KERAS_BN_EPS - FLAX_BN_EPS.

Files are read with the port's own HDF5 reader (``utils/h5read.py``); h5py
is not needed, and is not used when it imports. Only
``export_reference_h5`` writes HDF5, through h5py.
"""

from __future__ import annotations

import numpy as np

from m3d_torch.checkpoints import _flatten, restore_tree_by_name
from m3d_torch.utils import h5read


def _weight_root(f):
    return f["model_weights"] if "model_weights" in f else f


def _iter_layer_weights(f):
    """Yields (layer_name, weight_name, np.ndarray) for a Keras weights H5:
    the layers of the root's ``layer_names`` (its keys when the attribute
    is absent), each layer's datasets named by its ``weight_names`` (every
    dataset below it when that is absent)."""
    root = _weight_root(f)
    layer_names = [
        n.decode() if isinstance(n, bytes) else str(n)
        for n in root.attrs.get("layer_names", list(root.keys()))
    ]
    for lname in layer_names:
        if lname not in root:
            continue
        g = root[lname]
        wnames = g.attrs.get("weight_names", None)
        if wnames is None:
            items = []

            def visit(name, obj, _items=items):
                if hasattr(obj, "shape"):
                    _items.append(name)

            g.visititems(visit)
            wnames = items
        for wn in wnames:
            wn = wn.decode() if isinstance(wn, bytes) else str(wn)
            if wn in g:
                yield lname, wn, np.asarray(g[wn])


_BN_PARAM = {"gamma": "scale", "beta": "bias"}
_BN_STATS = {"moving_mean": "mean", "moving_variance": "var"}

# The reference's BatchNorm keeps the Keras default epsilon 1e-3; the port
# (as flax in the JAX package) uses 1e-5. Importing folds the difference
# into the moving variance: (x-mean)/sqrt((var + 1e-3 - 1e-5) + 1e-5) is
# the Keras formula. Export applies the inverse shift.
KERAS_BN_EPS = 1e-3
FLAX_BN_EPS = 1e-5


def load_keras_h5(path: str):
    """Read a reference H5 into two nested trees keyed by layer name:
    ({layer: {param: arr}}, {layer: {stat: arr}}).

    The owner is the LAYER GROUP name, not the weight path's first
    component: Keras 2.3.1 writes TimeDistributed-wrapped head layers under
    the wrapper's name ("mrcnn_class_conv1") while the weight names inside
    carry the inner layer's generated name ("conv3d_12/kernel:0").
    Directly named layers have group == path owner, so this covers both.
    """
    params: dict[str, dict[str, np.ndarray]] = {}
    stats: dict[str, dict[str, np.ndarray]] = {}
    with h5read.File(path) as f:
        for layer, wname, arr in _iter_layer_weights(f):
            leaf = wname.split("/")[-1].split(":")[0]
            owner = layer
            if leaf in _BN_PARAM:
                params.setdefault(owner, {})[_BN_PARAM[leaf]] = arr
            elif leaf in _BN_STATS:
                if leaf == "moving_variance":
                    arr = arr.astype(np.float32) + np.float32(
                        KERAS_BN_EPS - FLAX_BN_EPS)
                stats.setdefault(owner, {})[_BN_STATS[leaf]] = arr
            else:
                if leaf == "kernel" and "deconv" in owner:
                    arr = np.swapaxes(arr, -1, -2)
                params.setdefault(owner, {})[leaf] = arr
    return params, stats


def import_reference_h5(variables, path: str, skip_mismatch: bool = True,
                        class_slice: bool = True, verbose: bool = False):
    """Merge a reference H5 checkpoint into a flax-shaped variables tree
    ({"params": ..., "batch_stats": ...} of numpy arrays) by name.

    Returns (variables, stats_dict): loaded / sliced / skipped / missing
    counts for params and batch_stats.
    """
    src_params, src_stats = load_keras_h5(path)
    out = dict(variables)
    merged_params, pstats = restore_tree_by_name(
        variables["params"], src_params,
        skip_mismatch=skip_mismatch, class_slice=class_slice, verbose=verbose,
    )
    out["params"] = merged_params
    sstats = {}
    if "batch_stats" in variables and src_stats:
        merged_stats, sstats = restore_tree_by_name(
            variables["batch_stats"], src_stats,
            skip_mismatch=skip_mismatch, class_slice=class_slice,
            verbose=verbose,
        )
        out["batch_stats"] = merged_stats
    return out, {"params": pstats, "batch_stats": sstats}


def infer_head_params_from_h5(path: str) -> dict:
    """Recover head hyperparameters from kernel shapes (the reference's
    _infer_head_params_from_h5, core/models.py:5144-5203).

    Returns any of: POOL_SIZE, FPN_CLASSIF_FC_LAYERS_SIZE,
    HEAD_CONV_CHANNEL, NUM_CLASSES, TOP_DOWN_PYRAMID_SIZE.
    """
    params, _ = load_keras_h5(path)
    found: dict = {}
    k = params.get("mrcnn_class_conv1", {}).get("kernel")
    if k is not None and k.ndim == 5:
        found["POOL_SIZE"] = int(k.shape[0])
        found["FPN_CLASSIF_FC_LAYERS_SIZE"] = int(k.shape[-1])
        found["TOP_DOWN_PYRAMID_SIZE"] = int(k.shape[-2])
    k = params.get("mrcnn_mask_conv1", {}).get("kernel")
    if k is not None and k.ndim == 5:
        found["HEAD_CONV_CHANNEL"] = int(k.shape[-1])
    k = params.get("mrcnn_class_logits", {}).get("kernel")
    if k is not None and k.ndim == 2:
        found["NUM_CLASSES"] = int(k.shape[-1])
    k = params.get("mrcnn_mask", {}).get("kernel")
    if k is not None and k.ndim == 5:
        found.setdefault("NUM_CLASSES", int(k.shape[-1]))
    return found


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError("export_reference_h5 writes HDF5 through h5py, "
                          "which does not import here (reading .h5 weights "
                          "needs no h5py)") from err
    return h5py


def export_reference_h5(variables, path: str):
    """Write a flax-shaped variables tree (``params_to_jax`` of a state
    dict) as a reference-compatible Keras weights H5: each layer becomes
    one layer group with Keras-style weight names."""
    h5py = _h5py()
    inv_param = {v: k for k, v in _BN_PARAM.items()}
    inv_stats = {v: k for k, v in _BN_STATS.items()}

    layers: dict[str, dict[str, np.ndarray]] = {}
    for parts, val in _flatten(variables["params"]):
        layer, leaf = parts[-2], parts[-1]
        val = np.asarray(val)
        if leaf in inv_param:
            leaf = inv_param[leaf]
        elif leaf == "kernel" and "deconv" in layer:
            val = np.swapaxes(val, -1, -2)
        layers.setdefault(layer, {})[leaf] = val
    for parts, val in _flatten(variables.get("batch_stats", {})):
        layer, leaf = parts[-2], parts[-1]
        if leaf in inv_stats:
            val = np.asarray(val)
            if leaf == "var":
                val = val.astype(np.float32) - np.float32(
                    KERAS_BN_EPS - FLAX_BN_EPS)
            layers.setdefault(layer, {})[inv_stats[leaf]] = val

    order = ("kernel", "bias", "gamma", "beta", "moving_mean",
             "moving_variance")
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [np.bytes_(name) for name in sorted(layers)]
        f.attrs["backend"] = np.bytes_("m3d")
        for name in sorted(layers):
            g = f.create_group(name)
            leaves = sorted(
                layers[name],
                key=lambda leaf: order.index(leaf) if leaf in order else 99,
            )
            wnames = []
            for leaf in leaves:
                wn = f"{name}/{leaf}:0"
                g.create_dataset(wn, data=layers[name][leaf])
                wnames.append(np.bytes_(wn))
            g.attrs["weight_names"] = wnames
    return path
