"""One training step of the tiny Oriented R-CNN in the PyTorch port
against ``rs_detection_tpu/parallel/train_step.make_train_step``: the
same weights (JAX ``model.init``, perturbed, carried across by
``load_jax_variables``), the same seeded batch, AdamW with global-norm
clipping and the StepLR warmup on both sides, CPU, f32.

Sampling is made deterministic by construction, not by seed-matching:
both samplers take every candidate (``num`` at least the candidate
count, ``pos_fraction`` 1), so "top-k of random scores" keeps everything
in both frameworks. The JAX side is one jit compile at 64^2 images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rs_detection_tpu.models.backbones.van import VAN
from rs_detection_tpu.models.necks.fpn import FPN
from rs_detection_tpu.models.networks.rcnn import OrientedRCNN
from rs_detection_tpu.models.roi_heads.oriented_head import OrientedHead
from rs_detection_tpu.models.roi_heads.oriented_rpn_head import OrientedRPNHead
from rs_detection_tpu.optims.lr_scheduler import StepLR as JStepLR
from rs_detection_tpu.optims.optimizer import AdamW as JAdamW
from rs_detection_tpu.parallel.train_step import (create_train_state,
                                                  make_train_step)
from rs_detection_tpu_torch.flagship import build_flagship
from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
from rs_detection_tpu_torch.optims.optimizer import AdamW
from rs_detection_tpu_torch.parallel.train_step import train_step
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_variables)
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

IMG = 64
MAX_GT = 4
NMS_POST = 64
RPN_TAKE_ALL = 4096          # >= the 2387 anchors of a 64^2 image
HEAD_TAKE_ALL = NMS_POST + MAX_GT
BASE_LR = 1e-4
SCHED = dict(milestones=[7, 10], warmup="linear", warmup_iters=500,
             warmup_ratio=1.0 / 3)


def _jax_tiny():
    dims = (16, 32, 40, 64)
    return OrientedRCNN(
        backbone=VAN(embed_dims=dims, mlp_ratios=(8, 8, 4, 4),
                     depths=(1, 1, 2, 1)),
        neck=FPN(in_channels=dims, out_channels=32, num_outs=5),
        rpn=OrientedRPNHead(
            in_channels=32, feat_channels=32,
            anchor_generator=dict(
                scales=[8], ratios=[0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0],
                strides=[4, 8, 16, 32, 64]),
            nms_pre=256, nms_post=NMS_POST, pre_nms_cap=512,
            sampler=dict(num=RPN_TAKE_ALL, pos_fraction=1.0)),
        bbox_head=OrientedHead(
            num_classes=10, in_channels=32, fc_out_channels=64,
            sampler=dict(num=HEAD_TAKE_ALL, pos_fraction=1.0,
                         add_gt_as_proposals=True),
            bbox_roi_extractor=dict(
                roi_layer=dict(output_size=7, sampling_ratio=2),
                out_channels=32, extend_factor=(1.4, 1.2),
                featmap_strides=[4, 8, 16, 32])))


def _batch():
    """Two 64^2 images; ground truths near anchors of several shapes so
    both stages have positives, one padded slot in image 1."""
    rng = np.random.RandomState(21)
    images = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    rboxes = np.array([
        [[26, 26, 32, 32, 0.05], [42, 34, 44, 22, -0.08],
         [20, 46, 24, 12, 0.7], [48, 14, 10, 20, -1.2]],
        [[30, 30, 28, 20, 0.3], [14, 18, 16, 16, 0.0],
         [44, 46, 36, 18, -0.5], [0, 0, 0, 0, 0]]], np.float32)
    gt_mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool)
    labels = np.array([[1, 2, 5, 10], [3, 4, 7, 0]], np.int32)
    img_hw = np.full((2, 2), float(IMG), np.float32)
    return images, dict(rboxes=rboxes, gt_mask=gt_mask, labels=labels,
                        img_hw=img_hw)


def _before_bn(name):
    """A conv bias that feeds a BatchNorm: the batch mean removes it, so
    its gradient is zero up to rounding (~1e-9 here) on both sides."""
    return name.startswith("backbone.patch_embed") and name.endswith(
        "proj.bias")


def _adam_mu(opt_state):
    """The first-moment tree of the optax adam state."""
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(states) == 1
    return states[0].mu


@pytest.fixture(scope="module")
def one_step():
    model = _jax_tiny()
    images, targets = _batch()
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    variables = jax.jit(lambda i, t: model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        i, t))(jnp.asarray(images), jt)
    variables = perturb(variables, seed=5)
    sched = JStepLR(**SCHED)
    tx = JAdamW(lr=lambda step: sched(BASE_LR, step, 0), weight_decay=0.05,
                grad_clip=dict(max_norm=35))
    state = create_train_state(
        model, jax.tree_util.tree_map(jnp.asarray, variables), tx)
    step = make_train_step(model, tx, donate=False)
    new_state, metrics = step(state, jnp.asarray(images), jt,
                              jax.random.PRNGKey(2))
    ref = dict(
        losses={k: float(v) for k, v in metrics.items()},
        # one step from zero moments: mu = (1 - b1) * clipped gradient
        grads=jax_to_state_dict({"params": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / 0.1, _adam_mu(new_state.opt_state))}),
        params=jax_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, new_state.params)}),
        stats=jax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
            np.asarray, new_state.batch_stats["batch_stats"])}))

    port = build_flagship(tiny=True, device="cpu", train=True)
    load_jax_variables(port, variables)
    port.rpn.sampler = RandomSampler(num=RPN_TAKE_ALL, pos_fraction=1.0)
    port.bbox_head.sampler = RandomSampler(
        num=HEAD_TAKE_ALL, pos_fraction=1.0, add_gt_as_proposals=True)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    opt = AdamW(port.parameters(), lr=BASE_LR, weight_decay=0.05,
                grad_clip=dict(max_norm=35))
    losses = train_step(port, opt, StepLR(**SCHED),
                        torch.from_numpy(images),
                        {k: torch.from_numpy(v) for k, v in targets.items()},
                        torch.Generator().manual_seed(0), epoch=0)
    got = dict(losses={k: float(v) for k, v in losses.items()},
               grads={k: (torch.zeros_like(p) if p.grad is None
                          else p.grad).numpy()
                      for k, p in port.named_parameters()},
               params={k: p.detach().numpy()
                       for k, p in port.named_parameters()},
               stats={k: v.numpy() for k, v in port.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
               before={k: v.numpy() for k, v in before.items()},
               lr=opt.param_groups[0]["lr"])
    return ref, got


def test_losses_match(one_step):
    """The four losses and their sum to 2e-3 relative (f32 on both
    sides; the bound covers summation order through the whole net)."""
    ref, got = one_step
    assert set(got["losses"]) == set(ref["losses"])
    for k, v in ref["losses"].items():
        assert abs(got["losses"][k] - v) <= 2e-3 * max(abs(v), 0.1), (
            k, got["losses"][k], v)
    assert ref["losses"]["loss_rpn_bbox"] > 0
    assert ref["losses"]["orcnn_bbox_loss"] > 0


def test_gradients_match(one_step):
    """Every parameter's (clipped) gradient to 5e-3 of its leaf's
    largest magnitude (measured: 2.5e-6 at most); the biases ahead of a
    BatchNorm are zero to 1e-7 on both sides."""
    ref, got = one_step
    assert set(got["grads"]) == set(ref["grads"])
    nonzero = 0
    for k, gj in ref["grads"].items():
        gt = got["grads"][k]
        if _before_bn(k):
            assert max(np.abs(gj).max(), np.abs(gt).max()) < 1e-7, k
            continue
        scale = max(np.abs(gj).max(), np.abs(gt).max(), 1e-12)
        err = np.abs(gt - gj).max() / scale
        assert err < 5e-3, (k, err, scale)
        nonzero += scale > 1e-12
    assert nonzero >= 0.9 * len(ref["grads"])


def test_adamw_step_matches(one_step):
    """Parameters after one AdamW step. One Adam step moves a weight by
    about lr * sign(grad), so where a gradient is noise (under 1e-3 of
    its leaf's scale) the two sides may step opposite ways: there the
    bound is 2 lr; elsewhere the updates agree to 1e-6 (lr is 3.3e-5,
    the first warmup iteration's)."""
    ref, got = one_step
    lr = got["lr"]
    assert abs(lr - BASE_LR / 3) < 1e-12
    for k, pj in ref["params"].items():
        pt, p0, g = got["params"][k], got["before"][k], ref["grads"][k]
        diff = np.abs(pt - pj)
        assert diff.max() <= 2 * lr + 1e-6, (k, diff.max())
        sure = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-12)
        if sure.any() and not _before_bn(k):
            upd_t, upd_j = pt - p0, pj - p0
            assert np.abs(upd_t - upd_j)[sure].max() <= 1e-6, k


def test_bn_running_stats_match(one_step):
    """The flax update: momentum 0.9 toward the batch mean and the
    biased batch variance, once per step under checkpointing."""
    ref, got = one_step
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
