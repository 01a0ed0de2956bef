"""The port's checkpoint pickle, and reading it beside the JAX runner's.

A checkpoint is a pickle of the JAX runner's top-level keys, written
without jax: ``meta`` (epoch, iteration, ``swa_active``, the config, and
``format`` = ``FORMAT``), ``model`` ({state_dict name: f32 numpy array}
in torch layout, BatchNorm counters left out), ``opt_state``
({"iterations", "state": {parameter name: the optimizer's state of it,
``STATE_KEYS`` of its class: "step", "exp_avg", "exp_avg_sq" for AdamW,
"momentum_buffer" for SGD}}, or None) and ``ema`` (the per-step EMA of
the parameters, {parameter name: f32 numpy array}, apart from
``model``; None without one).
``read_checkpoint`` gives every pickle the runner loads the same form:
this one, the JAX runner's (flax trees of jax arrays; the state of its
optax AdamW or SGD through ``jax_weights.jax_optimizer_state``), and a
bare flax variables tree.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .jax_weights import (jax_optimizer_state, jax_to_state_dict,
                          load_jax_checkpoint)

FORMAT = "rs_detection_tpu_torch"


def model_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    """``module``'s parameters and buffers as f32 numpy arrays."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def load_model_arrays(module: nn.Module, arrays: Mapping,
                      optional=()) -> nn.Module:
    """Copy ``arrays`` (``model_arrays``' form) into ``module`` in place,
    keeping each tensor's dtype and device; a missing (unless in
    ``optional``), extra or misshapen name raises."""
    state = {k: v for k, v in module.state_dict().items()
             if not k.endswith("num_batches_tracked")
             and (k in arrays or k not in optional)}
    missing = sorted(set(state) - set(arrays))
    unexpected = sorted(set(arrays) - set(state))
    if missing or unexpected:
        raise ValueError(f"checkpoint does not match the model: missing "
                         f"{missing}, unexpected {unexpected}")
    bad = [f"{k}: {tuple(np.shape(arrays[k]))} vs {tuple(v.shape)}"
           for k, v in state.items()
           if tuple(np.shape(arrays[k])) != tuple(v.shape)]
    if bad:
        raise ValueError(f"checkpoint has the wrong shapes: {bad}")
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(torch.from_numpy(np.array(arrays[k], np.float32)))
    return module


def ema_arrays(ema) -> Dict[str, np.ndarray]:
    """A ``ParamEMA``'s averages by parameter name, as f32 numpy arrays."""
    return {n: s.detach().float().cpu().numpy()
            for n, s in zip(ema.names, ema.shadow)}


def load_ema_arrays(ema, arrays: Mapping) -> None:
    """Copy ``arrays`` (``ema_arrays``' form) into a ``ParamEMA`` in
    place; a missing, extra or misshapen name raises."""
    missing = sorted(set(ema.names) - set(arrays))
    unexpected = sorted(set(arrays) - set(ema.names))
    if missing or unexpected:
        raise ValueError(f"the checkpoint's EMA does not match the model: "
                         f"missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for n, s in zip(ema.names, ema.shadow):
            if tuple(np.shape(arrays[n])) != tuple(s.shape):
                raise ValueError(f"EMA of {n} has shape {np.shape(arrays[n])}"
                                 f", not {tuple(s.shape)}")
            s.copy_(torch.from_numpy(np.array(arrays[n], np.float32)))


def optimizer_arrays(optimizer: torch.optim.Optimizer,
                     module: nn.Module) -> Dict:
    """The optimizer's state of ``module``'s parameters by name (its
    ``STATE_KEYS``), as numpy arrays (``step`` as a float)."""
    state = {}
    for name, p in module.named_parameters():
        s = optimizer.state.get(p)
        if s:
            state[name] = {k: float(s[k]) if k == "step" else
                           s[k].detach().cpu().numpy()
                           for k in optimizer.STATE_KEYS}
    return dict(iterations=optimizer.iterations, state=state)


def load_optimizer_arrays(optimizer: torch.optim.Optimizer,
                          module: nn.Module, opt_state: Mapping) -> None:
    """Install ``opt_state`` (``optimizer_arrays``' form) into the
    optimizer of ``module``'s parameters, before its first step; unknown
    names, misshapen arrays and another optimizer's state raise."""
    params = dict(module.named_parameters())
    unknown = sorted(set(opt_state["state"]) - set(params))
    if unknown:
        raise ValueError(f"optimizer state for unknown parameters {unknown}")
    keys = set(optimizer.STATE_KEYS)
    for name, s in opt_state["state"].items():
        p = params[name]
        if set(s) != keys:
            raise ValueError(f"optimizer state of {name} holds {sorted(s)}; "
                             f"{type(optimizer).__name__} keeps "
                             f"{sorted(keys)}")
        loaded = {}
        for k, v in s.items():
            if k == "step":
                loaded[k] = torch.tensor(float(v), dtype=torch.float32)
                continue
            if tuple(np.shape(v)) != tuple(p.shape):
                raise ValueError(f"optimizer state {k} of {name} has shape "
                                 f"{np.shape(v)}, not {tuple(p.shape)}")
            loaded[k] = torch.tensor(np.asarray(v), device=p.device,
                                     dtype=p.dtype)
        optimizer.state[p] = loaded
    optimizer.iterations = int(opt_state["iterations"])


def read_checkpoint(path: str) -> Tuple[Dict, Dict[str, np.ndarray],
                                        Optional[Dict],
                                        Optional[Dict[str, np.ndarray]]]:
    """(meta, model arrays, optimizer state or None, EMA parameter
    arrays or None) of a checkpoint of the port or of the JAX runner, or
    of a bare flax variables pickle (empty meta)."""
    data = load_jax_checkpoint(path)
    if not (isinstance(data, Mapping) and "model" in data):
        return {}, jax_to_state_dict(data), None, None
    meta = dict(data.get("meta") or {})
    if meta.get("format") == FORMAT:
        return (meta, dict(data["model"]), data.get("opt_state"),
                data.get("ema"))
    opt = data.get("opt_state")
    ema = data.get("ema")
    return (meta, jax_to_state_dict(data["model"]),
            None if opt is None else jax_optimizer_state(opt),
            None if ema is None else jax_to_state_dict({"params": ema}))
