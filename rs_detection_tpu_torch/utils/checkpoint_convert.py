"""Checkpoint conversion: torch / Jittor state dicts -> flax-form trees
(counterpart of ``rs_detection_tpu/utils/checkpoint_convert.py``, numpy
only, giving the same trees).

A reference (JDet) checkpoint is a flat ``{dotted.name: array}`` state
dict in torch layouts. ``torch_state_to_flax`` makes the flax-form
``(params, batch_stats)`` trees of it, which ``utils/jax_weights.py:
load_jax_variables`` loads into the port's modules by name, so the chain
is state dict -> flax-form tree -> ``jax_to_state_dict`` -> module:

  * conv weights OIHW -> HWIO;
  * linear weights [out, in] -> [in, out] (an FC over a flattened
    NCHW map named in ``fc_spatial`` also has its input permuted to the
    port's (P, P, C) order);
  * BN (weight, bias, running_mean, running_var) ->
    (scale, bias) params + (mean, var) batch_stats.

``compare_trees`` / ``check_diff`` compare two nested numpy trees (or
two pickles of them).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

import numpy as np


def _to_numpy(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def convert_tensor(name: str, value: np.ndarray) -> np.ndarray:
    """Reorient a single torch/jittor tensor to flax conventions."""
    value = _to_numpy(value)
    if value.ndim == 4:                      # conv OIHW -> HWIO
        return value.transpose(2, 3, 1, 0)
    if value.ndim == 2 and not name.endswith("running_var"):
        return value.T                       # linear [out,in] -> [in,out]
    return value


def torch_state_to_flax(state_dict: Dict[str, Any],
                        fc_spatial: Dict[str, tuple] = None
                        ) -> Tuple[Dict, Dict]:
    """Convert a flat torch-style state dict into nested
    (params, batch_stats) trees keyed by the dotted path segments.

    BN entries are recognized by their stat names and split into the
    flax BatchNorm layout.

    ``fc_spatial`` maps weight names of fully-connected layers that
    directly follow a spatial flatten to their (C, P, P) input shape:
    torch flattens NCHW as (C, P, P) but the port's heads (as the flax
    ones) flatten NHWC as (P, P, C), so such weights need an input-dim
    permute, not just a transpose (e.g. the reference OrientedHead's
    first shared fc over the 7x7 RoI features, fc dims 256*7*7).
    """
    params: Dict = {}
    batch_stats: Dict = {}
    fc_spatial = fc_spatial or {}

    def insert(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    for name, value in state_dict.items():
        parts = name.split(".")
        leafname = parts[-1]
        arr = _to_numpy(value)
        if leafname == "running_mean":
            insert(batch_stats, parts[:-1] + ["mean"], arr)
        elif leafname == "running_var":
            insert(batch_stats, parts[:-1] + ["var"], arr)
        elif leafname == "num_batches_tracked":
            continue
        elif leafname == "weight" and arr.ndim == 1:
            # BN scale
            insert(params, parts[:-1] + ["scale"], arr)
        elif leafname == "weight":
            key = name[:-len(".weight")]
            if key in fc_spatial and arr.ndim == 2:
                c, ph, pw = fc_spatial[key]
                assert arr.shape[1] == c * ph * pw, (name, arr.shape)
                # [out, C*P*P] -> [out, P*P*C] -> [in, out]
                arr = arr.reshape(arr.shape[0], c, ph, pw) \
                    .transpose(0, 2, 3, 1).reshape(arr.shape[0], -1)
                insert(params, parts[:-1] + ["kernel"], arr.T)
            else:
                insert(params, parts[:-1] + ["kernel"],
                       convert_tensor(name, arr))
        elif leafname == "bias":
            insert(params, parts[:-1] + ["bias"], arr)
        else:
            insert(params, parts, arr)
    return params, batch_stats


def load_reference_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """Load a reference-format pickle checkpoint ({meta, model, ...} or
    a raw state dict) and convert to flax trees."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    if isinstance(data, dict):
        for key in ("model", "state_dict"):
            if key in data and isinstance(data[key], dict):
                data = data[key]
                break
    return torch_state_to_flax(data)


# ---------------------------------------------------------------------------
# Diff tooling
# ---------------------------------------------------------------------------

def compare_trees(tree_a: Dict, tree_b: Dict, rtol=1e-4, atol=1e-5,
                  prefix="") -> Dict[str, str]:
    """Recursively compare two nested numpy trees; returns a report of
    mismatches (missing keys, shape or value differences)."""
    report = {}
    keys = set(tree_a) | set(tree_b)
    for k in sorted(keys):
        path = f"{prefix}/{k}" if prefix else str(k)
        if k not in tree_a:
            report[path] = "missing in A"
            continue
        if k not in tree_b:
            report[path] = "missing in B"
            continue
        a, b = tree_a[k], tree_b[k]
        if isinstance(a, dict) and isinstance(b, dict):
            report.update(compare_trees(a, b, rtol, atol, path))
            continue
        a = np.asarray(a)
        b = np.asarray(b)
        if a.shape != b.shape:
            report[path] = f"shape {a.shape} vs {b.shape}"
        elif not np.allclose(a, b, rtol=rtol, atol=atol):
            report[path] = (f"max abs diff "
                            f"{np.abs(a - b).max():.3e}")
    return report


def check_diff(path_a: str, path_b: str, **kw):
    """Compare two pickled trees (``compare_trees``' report)."""
    with open(path_a, "rb") as f:
        a = pickle.load(f)
    with open(path_b, "rb") as f:
        b = pickle.load(f)
    return compare_trees(a, b, **kw)
