"""``S2ANet`` of the port against the JAX network on the CPU, f32: the
tiny model of ``tests/test_s2anet.py:16-27`` (ResNet-18 on batch
statistics, a 32-wide FPN with ``on_input`` extra convs, the 32-wide
head), one config dict built by each framework's registry, the JAX init
(perturbed) carried across by ``load_jax_variables``: ``predict`` and the
training losses. Then four SGD steps of ``tests/test_golden_loss.py:116``
``build_s2anet`` against its live ``make_train_step`` from the same
weights. Also the import guard of the slice: a tiny S2ANet predicts and
trains with no jax module loaded."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb
from test_torch_s2anet_cuda import tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64


def _data():
    """Two 64^2 tiles and 3 boxes each (one slot padded)."""
    rng = np.random.RandomState(0)
    tiles = rng.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    rboxes = np.zeros((2, 4, 5), np.float32)
    rboxes[:, :3] = [[30, 30, 20, 10, 0.3], [45, 40, 12, 6, -0.2],
                     [16, 20, 24, 16, 0.0]]
    rboxes[1, :, :2] += 3.0
    mask = np.zeros((2, 4), bool)
    mask[:, :3] = True
    labels = np.tile(np.asarray([1, 3, 2, 0], np.int32), (2, 1))
    targets = dict(rboxes=rboxes, gt_mask=mask, labels=labels,
                   img_hw=np.full((2, 2), IMG, np.float32))
    return normalize(torch.from_numpy(tiles)).numpy(), targets


_PAIR = {}


def _pair():
    """The JAX tiny S2ANet with perturbed variables (its ODM classifier
    spread so that scores pass the threshold and do not tie), and the
    port's with them."""
    if not _PAIR:
        images, targets = _data()
        cfg = tiny_model(zoo_freezing=False)
        jm = jreg.build_from_cfg(cfg, jreg.MODELS)
        jt = {k: jnp.asarray(v) for k, v in targets.items()}
        v = jax.jit(lambda i, t: jm.init(
            {"params": jax.random.PRNGKey(0)}, i, t))(jnp.asarray(images), jt)
        v = perturb(v, seed=7)
        head = v["params"]["_bbox_head"]
        head["odm_cls_out"]["kernel"] *= 60.0
        head["odm_cls_out"]["bias"] = np.random.RandomState(8).randn(
            3).astype(np.float32)
        port = load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v)
        _PAIR.update(jm=jm, v=v, port=port)
    return _PAIR["jm"], _PAIR["v"], _PAIR["port"]


def test_tiny_s2anet_predicts_like_jax():
    """The same valid slots and labels, polys to 1e-3 px, scores to 1e-5
    (f32 through ResNet-18 with perturbed norms)."""
    images, _ = _data()
    jm, v, port = _pair()
    ref = jax.jit(lambda v, i: jm.apply(v, i, method=jm.predict))(
        v, jnp.asarray(images))
    got = port.eval().predict(torch.from_numpy(images))
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 8 and got["polys"].shape == (2, 16, 8)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["polys"].numpy(), np.asarray(ref["polys"]),
                               atol=1e-3)


def test_tiny_s2anet_loss_like_jax():
    """The four losses within 1e-4 relative (train-mode batch statistics
    in f32 on both sides), each above 0."""
    images, targets = _data()
    jm, v, port = _pair()
    jt = {k: jnp.asarray(x) for k, x in targets.items()}
    ref, _ = jax.jit(lambda v, i: jm.apply(
        v, i, jt, method=jm.loss, mutable=["batch_stats"]))(
        v, jnp.asarray(images))
    got = port.train().loss(
        torch.from_numpy(images),
        {k: torch.from_numpy(x) for k, x in targets.items()})
    assert set(got) == set(ref) == {"loss_fam_cls", "loss_fam_bbox",
                                    "loss_odm_cls", "loss_odm_bbox"}
    for k in ref:
        assert got[k].item() > 0
        assert abs(got[k].item() - float(ref[k])) <= 1e-4 * abs(
            float(ref[k])), (k, got[k].item(), float(ref[k]))


def test_four_sgd_steps_like_golden_make_train_step():
    """``build_s2anet``'s model, batch and SGD (0.01, momentum 0.9, decay
    1e-4, clip 35) stepped 4 times by the JAX ``make_train_step`` and by
    the port's ``train_step`` from the same initial variables: the total
    losses within 2e-3 relative (measured on the CPU: 0, 1.1e-6, 4.5e-5,
    3.2e-4). The model trains its norms on the batch statistics of one
    64^2 tile, where both frameworks' f32 backbone gradients are
    percent-level off their f64 values in some tensors
    (``tests/test_torch_resnet_runner.py``), so the steps drift apart
    slowly; the first loss agrees to 1e-5."""
    from test_golden_loss import build_s2anet

    from rs_detection_tpu_torch.models.backbones.resnet import ResNet
    from rs_detection_tpu_torch.models.necks.fpn import FPN
    from rs_detection_tpu_torch.models.networks.single_stage import S2ANet
    from rs_detection_tpu_torch.models.roi_heads.s2anet_head import \
        S2ANetHead
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step
    from rs_detection_tpu_torch.runner.runner import constant_lr

    step, state, images, targets = build_s2anet()
    port = S2ANet(
        backbone=ResNet(depth=18, norm_eval=False),
        neck=FPN(in_channels=(64, 128, 256, 512), out_channels=32,
                 num_outs=5, add_extra_convs="on_input"),
        bbox_head=S2ANetHead(num_classes=3, in_channels=32, feat_channels=32,
                             anchor_strides=(4, 8, 16, 32, 64), nms_pre=32,
                             max_per_img=16))
    load_jax_variables(port, {"params": jax.tree_util.tree_map(
        np.asarray, state.params), "batch_stats": jax.tree_util.tree_map(
        np.asarray, state.batch_stats["batch_stats"])})
    opt = SGD(port.parameters(), lr=0.01, momentum=0.9,
              grad_clip=dict(max_norm=35))
    x = torch.from_numpy(np.array(images))
    tt = {k: torch.from_numpy(np.array(a)) for k, a in targets.items()}
    rng = jax.random.PRNGKey(3)
    want, got = [], []
    for _ in range(4):
        state, metrics = step(state, images, targets, rng)
        want.append(float(metrics["total_loss"]))
        out = train_step(port, opt, constant_lr, x, tt, None, epoch=0.0)
        got.append(out["total_loss"].item())
    assert all(np.isfinite(got)) and got[0] > 0
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
    for g, w in zip(got, want):
        assert abs(g - w) <= 2e-3 * abs(w), (got, want)


def test_s2anet_imports_no_jax():
    """The single-stage network, its head and ops build, predict and
    train a step without loading jax, flax or the JAX package."""
    code = ("import sys, torch\n"
            "torch.set_num_threads(2)\n"
            "sys.path.insert(0, 'tests')\n"
            "from test_torch_s2anet_cuda import run_tiny, tiny_inputs\n"
            "tiles, targets = tiny_inputs()\n"
            "_, pred, losses = run_tiny('cpu', tiles, targets, steps=1)\n"
            "assert pred['valid'].any() and losses[0]['total_loss'] > 0\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in\n"
            "       ('jax', 'flax', 'optax', 'rs_detection_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
