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
  an ``nn.Dense`` ``(in, out)`` becomes ``nn.Linear`` ``(out, in)``, and
  ORConv2d's rank-3 ARF kernel ``(out, in / nOr, nOr * k * k)`` keeps its
  layout (the port's parameter has it);
* every other leaf (``bias``, ``layer_scale_*``, ConvNeXt's ``gamma``,
  SK2Res2Net's ``sk/alpha``, Swin's ``relative_position_bias_table``)
  keeps its name; the automatic flax names (``Conv_k``, ``Norm_k``,
  ``LayerNorm_0``, ``Dense_k``) are the port's module names too;
* a Swin ``relative_position_bias_table`` that flax made for a window
  smaller than the block's (a stage whose map is smaller than the window)
  goes to the rows of the port's whole-window table that window reads
  (``embed_bias_table``), the rows it never reads set to 0;
* the ``loss_state`` collection (the running statistics of the EFL and
  EQLv2 heads, NamedTuples in a live tree, dicts by field in a saved one)
  maps by the same rule: ``_bbox_head/efl/pos_grad`` is the head's buffer
  ``bbox_head.efl.pos_grad``;
* the detector's ``_backbone``, ``_neck``, ``_rpn``, ``_bbox_head``,
  R3Det's ``_frm`` and ``_refine_head`` and YOLO's ``_head`` (the names
  flax gives the submodules a config builds in ``setup``) are the port's
  ``backbone``, ``neck``, ``rpn``, ``bbox_head``, ``frm``,
  ``refine_head`` and ``bbox_head``, the names of submodules given to it
  as modules. A JAX runner checkpoint's ``ema`` (a ``params`` tree) maps
  by the same rule.

Any name or shape that does not match, in either direction, raises:
nothing is silently left at its init. The one exception is a tree with
no ``loss_state`` collection at all, which the JAX package's own trees
always are (its EFL and EQLv2 heads would make one in ``loss``, which
flax refuses to run): the port's loss states keep their initial values.

``load_jax_checkpoint`` reads the pickle the JAX runner's ``save``
writes without importing jax: its arrays are jax arrays, which pickle
as a numpy array plus a call to rebuild the device array; that call is
replaced by one that keeps the numpy array. ``module_to_jax_params``
goes the other way for the flax-named layers of ``TileScreen``, so a
screen checkpoint of the port loads in the JAX package.
``jax_optimizer_state`` carries that checkpoint's ``opt_state`` over to
the port's optimizer:
an optax AdamW or Adam chain through ``jax_adamw_state`` (``count`` -> ``step``
and ``iterations``, ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``), an
optax SGD chain through ``jax_sgd_state`` (``trace`` -> the momentum
buffers, the schedule's ``count`` -> ``iterations``), each leaf in the
torch layout of its parameter.
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
          "_bbox_head": "bbox_head", "_frm": "frm",
          "_refine_head": "refine_head", "_head": "bbox_head"}


def _node(v):
    """A subtree as a mapping (a NamedTuple by its fields), else None."""
    if isinstance(v, Mapping):
        return v
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return v._asdict()
    return None


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if _node(v) is not None:
            yield from _flatten(_node(v), prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return arr
    raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")


def jax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax variables -> {torch state_dict name: array in torch layout}."""
    out = {}
    for collection in ("params", "batch_stats", "loss_state"):
        for path, leaf in _flatten(variables.get(collection, {})):
            parts = [p for p in path[:-1] if p != "BatchNorm_0"]
            if parts:
                parts[0] = _BUILT.get(parts[0], parts[0])
            name = ".".join(parts + [_LEAF.get(path[-1], path[-1])])
            if name in out:
                raise ValueError(f"two flax leaves map to {name}")
            out[name] = _torch_layout(path[-1], np.asarray(leaf))
    return out


def embed_bias_table(small: np.ndarray, rows: int) -> np.ndarray:
    """A Swin bias table of a (2w - 1)^2-row window as the ``rows`` =
    (2W - 1)^2 rows of a W >= w window's table: offset (dy, dx) moves
    from row (dy + w - 1) * (2w - 1) + dx + w - 1 to (dy + W - 1) *
    (2W - 1) + dx + W - 1; the offsets beyond w are 0."""
    side, big = round(small.shape[0] ** 0.5), round(rows ** 0.5)
    if side * side != small.shape[0] or big * big != rows or side > big \
            or side % 2 == 0 or big % 2 == 0:
        raise ValueError(f"no bias table of {rows} rows holds one of "
                         f"{small.shape[0]}")
    out = np.zeros((big, big) + small.shape[1:], small.dtype)
    lo = (big - side) // 2
    out[lo:lo + side, lo:lo + side] = small.reshape(
        (side, side) + small.shape[1:])
    return out.reshape((rows,) + small.shape[1:])


def loss_state_names(module: nn.Module):
    """The state_dict names of ``module``'s buffers that hold a JAX
    ``loss_state`` variable (``LossState`` of the head variants)."""
    return {f"{n}.{b}" if n else b for n, m in module.named_modules()
            if getattr(m, "JAX_COLLECTION", None) == "loss_state"
            for b, _ in m.named_buffers(recurse=False)}


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax ``variables`` into ``module`` in place (keeping each
    tensor's dtype and device); returns ``module``. A tree without a
    ``loss_state`` collection leaves the module's loss states as they
    are."""
    arrays = jax_to_state_dict(variables)
    state = {k: v for k, v in module.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    if "loss_state" not in variables:
        state = {k: v for k, v in state.items()
                 if k not in loss_state_names(module)}
    for k, a in arrays.items():
        if k.endswith("relative_position_bias_table") and k in state \
                and a.shape != tuple(state[k].shape):
            arrays[k] = embed_bias_table(a, state[k].shape[0])
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


def module_to_jax_params(module: nn.Module) -> Dict:
    """The inverse of ``load_jax_variables`` for a module of flax-named
    ``Conv2d`` and ``GroupNorm`` layers (``TileScreen``): its parameters
    as a flax ``params`` tree of numpy f32 arrays (a conv's ``weight`` ->
    ``kernel`` in HWIO, a norm's -> ``scale``). Any other layer with
    parameters raises."""
    tree: Dict = {}
    for name, m in module.named_modules():
        params = dict(m.named_parameters(recurse=False))
        if not params:
            continue
        if not isinstance(m, (nn.Conv2d, nn.GroupNorm)):
            raise ValueError(f"{name}: no flax form for {type(m).__name__}")
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        for leaf, p in params.items():
            arr = p.detach().float().cpu().numpy()
            if leaf != "weight":
                node[leaf] = arr
            elif isinstance(m, nn.GroupNorm):
                node["scale"] = arr
            else:
                node["kernel"] = arr.transpose(2, 3, 1, 0)
    return tree


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


def _states(tree, keys):
    """The nodes of a serialized optax state that hold all of ``keys``."""
    if not isinstance(tree, Mapping):
        return []
    if set(keys) <= set(tree):
        return [tree]
    return [s for v in tree.values() for s in _states(v, keys)]


def _adam_states(tree):
    return _states(tree, ("count", "mu", "nu"))


def jax_optimizer_state(opt_state: Mapping) -> Dict:
    """A JAX runner checkpoint's ``opt_state`` -> the port's optimizer
    state: AdamW or Adam (``jax_adamw_state``) or SGD
    (``jax_sgd_state``)."""
    if _adam_states(opt_state):
        return jax_adamw_state(opt_state)
    if _states(opt_state, ("trace",)):
        return jax_sgd_state(opt_state)
    raise ValueError("the checkpoint's opt_state is neither an Adam(W) nor "
                     "an SGD chain; no other optimizer carries over")


def jax_sgd_state(opt_state: Mapping) -> Dict:
    """A JAX runner checkpoint's ``opt_state`` (``flax.serialization``
    state dict of the optax chain ``[clip_by_global_norm ->]
    add_decayed_weights -> sgd`` with a scheduled rate) -> the port's SGD
    state: {"iterations": the schedule's count, "state": {parameter name:
    {"momentum_buffer"}}}. The optax trace is the momentum buffer."""
    traces = _states(opt_state, ("trace",))
    counts = [s for s in _states(opt_state, ("count",)) if len(s) == 1]
    if len(traces) != 1 or len(counts) != 1:
        raise ValueError(f"the checkpoint's opt_state holds {len(traces)} "
                         f"traces and {len(counts)} schedule counts; only an "
                         f"SGD chain with a scheduled rate carries over")
    trace = jax_to_state_dict({"params": traces[0]["trace"]})
    return dict(iterations=int(np.asarray(counts[0]["count"])),
                state={k: dict(momentum_buffer=v) for k, v in trace.items()})


def jax_adamw_state(opt_state: Mapping) -> Dict:
    """A JAX runner checkpoint's ``opt_state`` (``flax.serialization``
    state dict of the optax chain ``[clip_by_global_norm ->] adamw`` or
    ``[clip_by_global_norm ->] [add_decayed_weights ->] adam``, whose
    decay link holds no state) -> the state of the port's ``AdamW`` or
    ``Adam``: {"iterations": count, "state": {parameter name: {"step",
    "exp_avg", "exp_avg_sq"}}}. Any other optimizer's state raises."""
    found = _adam_states(opt_state)
    if len(found) != 1:
        raise ValueError(f"the checkpoint's opt_state holds {len(found)} "
                         f"Adam states; only an Adam(W) chain carries over")
    adam = found[0]
    count = int(np.asarray(adam["count"]))
    mu = jax_to_state_dict({"params": adam["mu"]})
    nu = jax_to_state_dict({"params": adam["nu"]})
    return dict(iterations=count, state={
        k: dict(step=count, exp_avg=mu[k], exp_avg_sq=nu[k]) for k in mu})
