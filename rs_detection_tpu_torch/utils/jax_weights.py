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
* every other leaf (``bias``, ``layer_scale_*``) keeps its name.

Any name or shape that does not match, in either direction, raises:
nothing is silently left at its init.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


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
