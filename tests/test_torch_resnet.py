"""The port's ResNet backbone and SGD optimizer against the JAX package:
every registered ResNet form's stage outputs from the same weights (64^2
inputs, full widths), the train-mode forward with its running
statistics, ``frozen_stages`` / ``norm_eval`` over two SGD steps against
the optax chain (the frozen parameters still decayed, the frozen norms'
statistics unmoved), SGD step by step against optax (momentum, nesterov,
weight decay, the global-norm clip) across a StepLR warm-up, and the
detector's default backbone. CPU, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.models.networks.rcnn import OrientedRCNN as JOrientedRCNN
from rs_detection_tpu.optims.optimizer import SGD as JSGD
from rs_detection_tpu.runner.runner import _build_scheduler
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.models.backbones.resnet import ResNet
from rs_detection_tpu_torch.models.networks.rcnn import OrientedRCNN
from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
from rs_detection_tpu_torch.optims.optimizer import SGD
from rs_detection_tpu_torch.parallel.train_step import zero_missing_grads
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_variables)
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

FORMS = [dict(type=f"Resnet{d}") for d in (18, 26, 34, 38, 50, 101, 152)] \
    + [dict(type="Resnet50_v1d"), dict(type="Resnet101_v1d"),
       dict(type="ResNet", depth=50, return_stages=["layer2", "layer4"])]
# the training tests' input: BatchNorm's batch statistics over 2 x 4 x 4
# values a channel at stage 4
TRAIN_SHAPE = (2, 128, 128, 3)
FORM_IDS = [f["type"] + ("_" + "_".join(f["return_stages"])
                         if "return_stages" in f else "") for f in FORMS]


def _pair(cfg, seed=0, shape=(2, 64, 64, 3)):
    """The JAX module, its (perturbed) variables, the port's module with
    them loaded, and a seeded NHWC input."""
    jm = jreg.build_from_cfg(dict(cfg), jreg.BACKBONES)
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    v = perturb(jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x)),
                seed=seed + 1)
    pm = reg.build_from_cfg(dict(cfg), reg.BACKBONES)
    load_jax_variables(pm, v)
    return jm, v, pm, x


@pytest.mark.parametrize("cfg", FORMS, ids=FORM_IDS)
def test_resnet_form_matches_jax(cfg):
    """Each registered form in eval: the stage outputs within 1e-5 of
    their largest value (f32, convs summed in another order; measured
    ~3e-6). ``pretrained`` is dropped by the constructor, as in JAX."""
    extra = {} if cfg["type"] == "ResNet" else dict(pretrained=True)
    jm, v, pm, x = _pair(dict(cfg, **extra))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    got = pm.eval()(torch.from_numpy(x))
    assert len(got) == len(ref) == len(cfg.get("return_stages", range(4)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        err = np.abs(g.detach().numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), err


def test_resnet_train_forward_and_statistics_match_jax():
    """``norm_eval=False``: batch statistics in the forward, and the
    running statistics moved as flax moves them (1e-5 relative)."""
    cfg = dict(type="Resnet18", norm_eval=False)
    jm, v, pm, x = _pair(cfg, seed=2, shape=TRAIN_SHAPE)
    ref, mutated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    got = pm.train()(torch.from_numpy(x))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        err = np.abs(g.detach().numpy() - r).max()
        assert err <= 5e-5 * np.abs(r).max(), err
    want = jax_to_state_dict({"batch_stats": mutated["batch_stats"]})
    state = pm.state_dict()
    for k, r in want.items():
        np.testing.assert_allclose(state[k].numpy(), r, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _loss_jax(jm, proj):
    def loss(params, extra, x):
        outs, mutated = jm.apply({"params": params, **extra}, x, train=True,
                                 mutable=["batch_stats"])
        total = sum((o * p).sum() for o, p in zip(outs, proj))
        return total, mutated
    return loss


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("frozen_stages,norm_eval", [(1, True), (1, False),
                                                     (2, False), (0, False)])
def test_frozen_stages_take_two_sgd_steps_like_optax(frozen_stages,
                                                      norm_eval):
    """Two steps of a Resnet18 under SGD (momentum 0.9, weight decay
    1e-2, clip 35) on a fixed projection of its outputs, against
    ``jax.value_and_grad`` and the JAX optax chain: the frozen stem and
    stages are cut from the gradient but still decay and carry momentum
    (their zero gradients), the norms JAX runs with ``train=False`` keep
    their running statistics, the others move them.

    Both sides run in f64. In f32, flax's train-mode BatchNorm backward
    (through its variance E[x^2] - E[x]^2) loses 2-10% of the gradient of
    the layer ahead of a norm whose input mean dwarfs its spread (layer2
    here, measured), where the port's f32 gradient is within 5e-6 of the
    f64 one; the two steps then leave f32 runs 1e-3 apart. In f64 the
    parameters and statistics agree to 1e-9 of their largest value."""
    cfg = dict(type="Resnet18", frozen_stages=frozen_stages,
               norm_eval=norm_eval)
    jm, v, pm, x = _pair(cfg, seed=4, shape=TRAIN_SHAPE)
    rng = np.random.RandomState(5)
    shapes = [o.shape for o in pm.eval()(torch.from_numpy(x))]
    proj = [rng.randn(*s).astype(np.float32) for s in shapes]

    with jax.enable_x64(True):
        tx = JSGD(lr=0.05, momentum=0.9, weight_decay=1e-2,
                  grad_clip=dict(max_norm=35))
        params = _f64(v["params"])
        extra = {"batch_stats": _f64(v["batch_stats"])}
        opt_state = tx.init(params)
        step = jax.jit(jax.value_and_grad(
            _loss_jax(jm, [jnp.asarray(p, jnp.float64) for p in proj]),
            has_aux=True))
        for _ in range(2):
            (_, mutated), grads = step(params, extra,
                                       jnp.asarray(x, jnp.float64))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            extra = {"batch_stats": mutated["batch_stats"]}
        want = jax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": params, **extra}))

    pm.double()
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    opt = SGD(pm.parameters(), lr=0.05, momentum=0.9, weight_decay=1e-2,
              grad_clip=dict(max_norm=35))
    pm.train()
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        outs = pm(torch.from_numpy(x).double())
        sum((o * torch.from_numpy(p).double()).sum()
            for o, p in zip(outs, proj)).backward()
        frozen = [n for n, p in pm.named_parameters() if p.grad is None]
        zero_missing_grads(opt)
        opt.step()
    want_frozen = {n for n, _ in pm.named_parameters()
                   if n.split(".")[0] in ("Conv_0", "Norm_0")
                   or int(n[5]) <= frozen_stages and n.startswith("layer")}
    assert set(frozen) == want_frozen
    state = pm.state_dict()
    for k, r in want.items():
        got = state[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            assert np.abs(got - r).max() <= 1e-9 * np.abs(r).max(), k
            eval_norm = k.rsplit(".", 1)[0] in pm.eval_norms
            assert np.array_equal(got, before[k].numpy()) == eval_norm, k
            continue
        assert np.abs(got - r).max() <= 1e-9 * np.abs(r).max(), k
    for k in frozen:
        # weight decay and momentum moved the frozen parameters too
        assert not np.array_equal(state[k].numpy(), before[k].numpy()), k


@pytest.mark.parametrize("momentum,nesterov,weight_decay,max_norm", [
    (0.9, False, 1e-4, 35.0), (0.9, True, 5e-4, None), (0.0, False, 0.0, 1.0),
    (0.5, True, 1e-2, 0.5)])
def test_sgd_matches_optax_step_by_step(momentum, nesterov, weight_decay,
                                        max_norm):
    """Six steps on seeded parameters and gradients (large enough for the
    clip to act where one is set), the rate from a StepLR warm-up (3
    iterations from 1/3) and a milestone at epoch 2 of 2 steps: the port's
    SGD with the port's StepLR against the JAX package's optax chain and
    schedule, each step to 1e-6 relative; the momentum buffer is the
    optax trace."""
    rng = np.random.RandomState(9)
    shapes = {"w": (4, 3), "b": (3,), "k": (2, 2, 3, 5)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (10 * rng.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    sched_cfg = dict(type="StepLR", warmup="linear", warmup_iters=3,
                     warmup_ratio=1.0 / 3, milestones=[2])
    schedule = _build_scheduler(sched_cfg, steps_per_epoch=2)
    clip = None if max_norm is None else dict(max_norm=max_norm)
    tx = JSGD(lr=lambda c: 0.1 * schedule(c), momentum=momentum,
              nesterov=nesterov, weight_decay=weight_decay, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = SGD(tp.values(), lr=0.1, momentum=momentum, nesterov=nesterov,
              weight_decay=weight_decay, grad_clip=clip)
    sched = StepLR([2], warmup="linear", warmup_iters=3,
                   warmup_ratio=1.0 / 3)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        lr = sched(0.1, opt.iterations, opt.iterations / 2)
        opt.param_groups[0]["lr"] = lr
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert opt.iterations == 6
    if momentum:
        trace = jax.tree_util.tree_leaves(
            state, is_leaf=lambda n: hasattr(n, "trace"))
        trace = [n.trace for n in trace if hasattr(n, "trace")][0]
        for k, p in tp.items():
            np.testing.assert_allclose(
                opt.state[p]["momentum_buffer"].numpy(),
                np.asarray(trace[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_detector_without_a_backbone_is_resnet50():
    """``OrientedRCNN`` with no backbone section builds ResNet-50 (the
    JAX model's default): the same parameter names and shapes as the JAX
    default's backbone."""
    with torch.device("meta"):
        model = OrientedRCNN()
    assert isinstance(model.backbone, ResNet)
    assert model.backbone.layers == (3, 4, 6, 3)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jm = JOrientedRCNN()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, x))
    want = {k: tuple(v.shape) for k, v in jax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items() if k.startswith("backbone.")}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if k.startswith("backbone.")
           and not k.endswith("num_batches_tracked")}
    assert got == want
