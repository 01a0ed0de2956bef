"""The port's checkpoint pickle, and reading it beside the JAX runner's.

A checkpoint is a pickle of the JAX runner's top-level keys, written
without jax: ``meta`` (epoch, iteration, ``swa_active``, the config, and
``format`` = ``FORMAT``), ``model`` ({state_dict name: f32 numpy array}
in torch layout, BatchNorm counters left out), ``opt_state``
({"iterations", "state": {parameter name: {"step", "exp_avg",
"exp_avg_sq"}}}, the port's AdamW, or None) and ``ema`` (None).
``read_checkpoint`` gives every pickle the runner loads the same form:
this one, the JAX runner's (flax trees of jax arrays; the moments of its
optax AdamW through ``jax_weights.jax_adamw_state``), and a bare flax
variables tree.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .jax_weights import jax_adamw_state, jax_to_state_dict, \
    load_jax_checkpoint

FORMAT = "rs_detection_tpu_torch"


def model_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    """``module``'s parameters and buffers as f32 numpy arrays."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def load_model_arrays(module: nn.Module, arrays: Mapping) -> nn.Module:
    """Copy ``arrays`` (``model_arrays``' form) into ``module`` in place,
    keeping each tensor's dtype and device; a missing, extra or
    misshapen name raises."""
    state = {k: v for k, v in module.state_dict().items()
             if not k.endswith("num_batches_tracked")}
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


def optimizer_arrays(optimizer: torch.optim.Optimizer,
                     module: nn.Module) -> Dict:
    """The AdamW state of ``module``'s parameters by name, as numpy."""
    state = {}
    for name, p in module.named_parameters():
        s = optimizer.state.get(p)
        if s:
            state[name] = dict(
                step=float(s["step"]),
                exp_avg=s["exp_avg"].detach().cpu().numpy(),
                exp_avg_sq=s["exp_avg_sq"].detach().cpu().numpy())
    return dict(iterations=optimizer.iterations, state=state)


def load_optimizer_arrays(optimizer: torch.optim.Optimizer,
                          module: nn.Module, opt_state: Mapping) -> None:
    """Install ``opt_state`` (``optimizer_arrays``' form) into the AdamW
    of ``module``'s parameters, before its first step; names it does not
    have raise."""
    params = dict(module.named_parameters())
    unknown = sorted(set(opt_state["state"]) - set(params))
    if unknown:
        raise ValueError(f"optimizer state for unknown parameters {unknown}")
    for name, s in opt_state["state"].items():
        p = params[name]
        if tuple(np.shape(s["exp_avg"])) != tuple(p.shape):
            raise ValueError(f"optimizer state of {name} has shape "
                             f"{np.shape(s['exp_avg'])}, not {tuple(p.shape)}")
        optimizer.state[p] = dict(
            step=torch.tensor(float(s["step"]), dtype=torch.float32),
            exp_avg=torch.tensor(np.asarray(s["exp_avg"]), device=p.device,
                                 dtype=p.dtype),
            exp_avg_sq=torch.tensor(np.asarray(s["exp_avg_sq"]),
                                    device=p.device, dtype=p.dtype))
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
        return meta, dict(data["model"]), data.get("opt_state"), None
    opt = data.get("opt_state")
    ema = data.get("ema")
    return (meta, jax_to_state_dict(data["model"]),
            None if opt is None else jax_adamw_state(opt),
            None if ema is None else jax_to_state_dict({"params": ema}))
