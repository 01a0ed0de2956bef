"""The port's optimizers and schedules against the JAX package's: the
registries name for name; ``ExpLR``, ``PolyLR``, ``InvLR``, ``WarmUpLR``
and ``WarmUpLRGroup`` with the "constant", "linear" and "exp" warmups
over a grid of (step, epoch); ``Adam`` (weight decay added to the
gradient before the moments, global-norm clipping) for five steps
against the optax chain of ``rs_detection_tpu/optims/optimizer.py:Adam``;
and a JAX runner pickle of an ``Adam`` chain's state, with and without
its ``add_decayed_weights`` link, resumed by the port's ``Adam``.

The schedules are pure functions (f64 in the port, f32 in JAX: 1e-6
relative). The optimizers run on a small parameter set in f32: 1e-6 of a
leaf's scale after five steps; a resumed step to f32 rounding (1e-5
relative, 1e-7 absolute on weights of ~1e-2)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import rs_detection_tpu.optims.lr_scheduler as jsched
import rs_detection_tpu.optims.optimizer as joptim
from rs_detection_tpu.utils.registry import OPTIMS as JOPTIMS
from rs_detection_tpu.utils.registry import SCHEDULERS as JSCHEDULERS
from rs_detection_tpu_torch.models.networks.tile_screen import TileScreen
from rs_detection_tpu_torch.optims import lr_scheduler as sched
from rs_detection_tpu_torch.optims import optimizer as optim
from rs_detection_tpu_torch.utils.checkpoint import (load_model_arrays,
                                                     load_optimizer_arrays,
                                                     read_checkpoint)
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      module_to_jax_params)
from rs_detection_tpu_torch.utils.registry import OPTIMS, SCHEDULERS

GRID = [(s, e) for s in (0, 1, 7, 24, 25, 60, 500) for e in (0, 0.5, 3, 11.2,
                                                              40)]
WARMUPS = [None, "constant", "linear", "exp"]
SCHEDULES = [
    ("ExpLR", dict(gamma=0.8)),
    ("PolyLR", dict(max_steps=12, power=0.9, min_lr=1e-5)),
    ("PolyLR", dict(max_steps=30, power=2.0)),
    ("InvLR", dict(gamma=0.01, power=0.75)),
    ("WarmUpLR", dict()),
    ("WarmUpLRGroup", dict()),
    ("StepLR", dict(milestones=[3, 11], gamma=0.5)),
    ("CosineAnnealingLR", dict(max_steps=12, min_lr_ratio=0.05)),
]


def test_registries_equal_jax():
    assert sorted(OPTIMS._modules) == sorted(JOPTIMS._modules)
    assert sorted(SCHEDULERS._modules) == sorted(JSCHEDULERS._modules)


@pytest.mark.parametrize("warmup", WARMUPS)
@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_matches_jax(name, kw, warmup):
    kw = dict(kw, warmup=warmup, warmup_iters=25, warmup_ratio=0.1)
    port = getattr(sched, name)(**kw)
    ref = getattr(jsched, name)(**kw)
    for step, epoch in GRID:
        got = port(0.02, step, epoch)
        want = float(ref(0.02, step, epoch))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (step, epoch,
                                                             got, want)


def test_unknown_warmup_raises_as_in_jax():
    with pytest.raises(ValueError):
        sched.ExpLR(warmup="cosine", warmup_iters=5)(0.1, 100, 0)
    with pytest.raises(ValueError):
        jsched.ExpLR(warmup="cosine", warmup_iters=5)(0.1, 100, 0)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}


def _grads(step, scale):
    rng = np.random.RandomState(100 + step)
    return {"a": (scale * rng.randn(4, 3)).astype(np.float32),
            "b": (scale * rng.randn(5)).astype(np.float32)}


@pytest.mark.parametrize("wd,clip,scale", [
    (0.0, None, 1.0), (0.01, None, 1.0), (0.0, 2.0, 5.0), (0.05, 2.0, 5.0)])
def test_adam_five_steps_match_optax(wd, clip, scale):
    """The clip (the gradients' global norm reaches 2 with ``scale`` 5)
    then the decay added to the gradient, then Adam."""
    clip_cfg = None if clip is None else dict(max_norm=clip)
    tx = joptim.Adam(lr=3e-3, betas=(0.9, 0.99), eps=1e-8,
                     weight_decay=wd, grad_clip=clip_cfg)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v))
          for k, v in _params().items()}
    opt = optim.Adam(list(tp.items()), lr=3e-3, betas=(0.9, 0.99), eps=1e-8,
                     weight_decay=wd, grad_clip=clip_cfg)
    for step in range(5):
        g = _grads(step, scale)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.iterations == 5
    for k, p in tp.items():
        want = np.asarray(jp[k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


def test_adam_decay_is_not_decoupled():
    """With zero gradients AdamW shrinks a weight by lr * wd; Adam's
    decayed gradient goes through the moments (a step of about lr)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.Adam([("p", p)], lr=0.1, weight_decay=0.5)
    p.grad = torch.zeros(3)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 0.9, rtol=1e-5)


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_jax_adam_checkpoint_resumes_in_the_port(tmp_path, wd):
    """A JAX runner pickle (``save``'s form: ``to_state_dict`` of the
    variables and of the optax state) of two Adam steps, with and without
    the ``add_decayed_weights`` link, loaded as ``Runner.load`` loads it:
    the port's third step equals the chain's."""
    port = TileScreen(channels=(4, 8), pool=2)
    tree = jax.tree_util.tree_map(jnp.asarray, module_to_jax_params(port))
    tx = joptim.Adam(lr=1e-2, weight_decay=wd, grad_clip=dict(max_norm=1.0))
    state = tx.init(tree)
    grads = [jax.tree_util.tree_map(lambda v, i=i: jnp.asarray(
        np.random.RandomState(i).randn(*v.shape).astype(np.float32)), tree)
        for i in range(3)]
    for g in grads[:2]:
        upd, state = tx.update(g, state, tree)
        tree = optax.apply_updates(tree, upd)
    path = tmp_path / "ckpt_2.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(
            meta=dict(epoch=2, iter=2),
            model=serialization.to_state_dict({"params": tree}),
            opt_state=serialization.to_state_dict(state)), f)

    meta, arrays, opt_state, _ = read_checkpoint(str(path))
    load_model_arrays(port, arrays)
    opt = optim.Adam(port.named_parameters(), lr=1e-2, weight_decay=wd,
                     grad_clip=dict(max_norm=1.0))
    load_optimizer_arrays(opt, port, opt_state)
    assert opt.iterations == 2 and meta["iter"] == 2
    upd, state = tx.update(grads[2], state, tree)
    tree = optax.apply_updates(tree, upd)
    g_port = port_layout({"params": grads[2]})
    for name, p in port.named_parameters():
        p.grad = torch.from_numpy(g_port[name].copy())
    opt.step()
    want = port_layout({"params": tree})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def port_layout(tree):
    """A flax tree as the port's state_dict (numpy, torch layouts)."""
    return jax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))
