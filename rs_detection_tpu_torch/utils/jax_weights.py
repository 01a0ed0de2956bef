"""Load the JAX package's variables into the port's modules.

The inverse of ``rs_detection_tpu/utils/checkpoint_convert.py``: a flax
``{"params": ..., "batch_stats": ...}`` tree of numpy arrays becomes a
PyTorch ``state_dict`` by name. The port's modules carry the flax
names, so the mapping is mechanical:

* a ``BatchNorm_0`` path segment is dropped (``Norm`` wraps the flax
  BatchNorm one level deep); ``scale`` -> ``weight``, batch_stats
  ``mean``/``var`` -> ``running_mean``/``running_var``;
* ``kernel`` -> ``weight``: a conv HWIO ``(kh, kw, in/groups, out)``
  becomes OIHW (a depthwise ``(k, k, 1, C)`` becomes ``(C, 1, k, k)``),
  an ``nn.Dense`` ``(in, out)`` becomes ``nn.Linear`` ``(out, in)``;
* every other leaf (``bias``, ``layer_scale_*``) keeps its name;
* the detector's ``_backbone``, ``_neck``, ``_rpn`` and ``_bbox_head``
  (the names flax gives the submodules a config builds in ``setup``)
  are the port's ``backbone``, ``neck``, ``rpn`` and ``bbox_head``, the
  names of submodules given to it as modules.

Any name or shape that does not match, in either direction, raises:
nothing is silently left at its init.

``load_jax_checkpoint`` reads the pickle the JAX runner's ``save``
writes without importing jax: its arrays are jax arrays, which pickle
as a numpy array plus a call to rebuild the device array; that call is
replaced by one that keeps the numpy array. ``jax_adamw_state`` carries
that checkpoint's ``opt_state`` (an optax AdamW chain) over to the
port's AdamW: ``count`` -> ``step`` and ``iterations``, ``mu`` ->
``exp_avg``, ``nu`` -> ``exp_avg_sq``, each leaf in the torch layout of
its parameter.
"""

from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}
_BUILT = {"_backbone": "backbone", "_neck": "neck", "_rpn": "rpn",
          "_bbox_head": "bbox_head"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:
        return arr.T
    raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")


def jax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax variables -> {torch state_dict name: array in torch layout}."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            parts = [p for p in path[:-1] if p != "BatchNorm_0"]
            if parts:
                parts[0] = _BUILT.get(parts[0], parts[0])
            name = ".".join(parts + [_LEAF.get(path[-1], path[-1])])
            if name in out:
                raise ValueError(f"two flax leaves map to {name}")
            out[name] = _torch_layout(path[-1], np.asarray(leaf))
    return out


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax ``variables`` into ``module`` in place (keeping each
    tensor's dtype and device); returns ``module``."""
    arrays = jax_to_state_dict(variables)
    state = {k: v for k, v in module.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    missing = sorted(set(state) - set(arrays))
    unexpected = sorted(set(arrays) - set(state))
    if missing or unexpected:
        raise ValueError(f"JAX variables do not match the module: missing "
                         f"{missing}, unexpected {unexpected}")
    bad = [f"{k}: {tuple(arrays[k].shape)} vs {tuple(v.shape)}"
           for k, v in state.items() if tuple(arrays[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"JAX variables have the wrong shapes: {bad}")
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(torch.from_numpy(np.array(arrays[k], dtype=np.float32)))
    return module


def _numpy_of_jax_array(fun, args, arr_state, aval_state):
    """Stands in for ``jax._src.array._reconstruct_array``: the numpy
    value the jax array was pickled from."""
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _numpy_of_jax_array
        if module.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            raise pickle.UnpicklingError(
                f"the checkpoint holds {module}.{name}, which has no form "
                f"without jax")
        return super().find_class(module, name)


def load_jax_checkpoint(path: str):
    """The object pickled at ``path`` (a JAX runner checkpoint, or a bare
    flax variables tree), with every jax array as a numpy array."""
    with open(path, "rb") as f:
        return _JaxCheckpointUnpickler(f).load()


def _adam_states(tree):
    """The ``{"count", "mu", "nu"}`` nodes of a serialized optax state."""
    if not isinstance(tree, Mapping):
        return []
    if {"count", "mu", "nu"} <= set(tree):
        return [tree]
    return [s for v in tree.values() for s in _adam_states(v)]


def jax_adamw_state(opt_state: Mapping) -> Dict:
    """A JAX runner checkpoint's ``opt_state`` (``flax.serialization``
    state dict of the optax chain ``[clip_by_global_norm ->] adamw``) ->
    the port's optimizer state: {"iterations": count, "state": {parameter
    name: {"step", "exp_avg", "exp_avg_sq"}}}. Any other optimizer's
    state raises."""
    found = _adam_states(opt_state)
    if len(found) != 1:
        raise ValueError(f"the checkpoint's opt_state holds {len(found)} "
                         f"Adam states; only an AdamW chain carries over")
    adam = found[0]
    count = int(np.asarray(adam["count"]))
    mu = jax_to_state_dict({"params": adam["mu"]})
    nu = jax_to_state_dict({"params": adam["nu"]})
    return dict(iterations=count, state={
        k: dict(step=count, exp_avg=mu[k], exp_avg_sq=nu[k]) for k in mu})
