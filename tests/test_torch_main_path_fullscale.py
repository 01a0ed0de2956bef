"""The port's own main path at VAN-b3's published widths against the JAX
package on the CPU: ``build_flagship()``'s Oriented
R-CNN (VAN-b3 dims 64/128/320/512, depths 3/5/27/3, MLP ratios 8/8/4/4,
FPN-256, the 7-ratio Oriented RPN, the 2 x 1024 head) with the JAX
model's weights (``model.init``, perturbed, carried by
``utils/jax_weights.py:load_jax_variables``):

* ``predict`` on one 512^2 tile, f32;
* one ``train_step`` (AdamW, the StepLR warmup, clipping) on two 64^2
  images, the smallest size that keeps every pyramid level (stride 64:
  1 x 1), with samplers that take every candidate, so both frameworks
  sample the same sets.

Unlike ``tests/test_torch_parity_fullscale.py``, which holds twins
written inside the test, this runs ``rs_detection_tpu_torch`` itself.
Slow: three JAX compiles of the whole network (``init``, ``predict``,
the step; about 2.5 min on 8 cores).

Tolerances: f32 through 38 blocks on both sides. ``predict``: the
valid slots equal; every detection of one side has one of the other
side's within 1e-2 px and 1e-5 in every class score, in its own slot
for at least 99% of them (proposals whose scores tie within f32
rounding can trade slots: 4 of 2000 here). The step: ``tests/test_torch_port_train_step.py``'s
bounds (losses 2e-3 relative, gradients 5e-3 of a leaf's scale, the
AdamW update within 2 lr and 1e-6 where the gradient is not noise, BN
statistics 1e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
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
from rs_detection_tpu_torch.flagship import (build_flagship, flagship_cfg,
                                             normalize)
from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
from rs_detection_tpu_torch.optims.optimizer import AdamW
from rs_detection_tpu_torch.parallel.train_step import train_step
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_variables)
from test_torch_port_slice import perturb
from test_torch_port_train_step import SCHED, _adam_mu, _batch, _before_bn

pytestmark = pytest.mark.slow

CFG = flagship_cfg(tiny=False)
RPN_TAKE_ALL = 4096                      # >= the 2387 anchors of 64^2
HEAD_TAKE_ALL = CFG["rpn"]["nms_post"] + 4


def jax_flagship(rpn_sampler=None, head_sampler=None):
    """The JAX twin of ``build_flagship()`` at full width."""
    bb, rpn, head = CFG["backbone"], CFG["rpn"], CFG["bbox_head"]
    return OrientedRCNN(
        backbone=VAN(embed_dims=tuple(bb["embed_dims"]),
                     mlp_ratios=tuple(bb["mlp_ratios"]),
                     depths=tuple(bb["depths"])),
        neck=FPN(in_channels=tuple(bb["embed_dims"]),
                 out_channels=CFG["neck"]["out_channels"], num_outs=5),
        rpn=OrientedRPNHead(
            in_channels=rpn["in_channels"], feat_channels=rpn["feat_channels"],
            anchor_generator=dict(rpn["anchor_generator"]),
            nms_pre=rpn["nms_pre"], nms_post=rpn["nms_post"],
            pre_nms_cap=rpn["pre_nms_cap"],
            **({} if rpn_sampler is None else dict(sampler=rpn_sampler))),
        bbox_head=OrientedHead(
            num_classes=head["num_classes"], in_channels=head["in_channels"],
            fc_out_channels=head["fc_out_channels"],
            bbox_roi_extractor=dict(head["bbox_roi_extractor"]),
            **({} if head_sampler is None else dict(sampler=head_sampler))))


@pytest.fixture(scope="module")
def init_weights():
    """The JAX model's ``init`` (biases 0, BN statistics 0 / 1, layer
    scales 1e-2), as numpy."""
    images, targets = _batch()
    model = jax_flagship()
    v = jax.jit(lambda i, t: model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        i, t))(jnp.asarray(images[:1]),
               {k: jnp.asarray(x[:1]) for k, x in targets.items()})
    return jax.tree_util.tree_map(np.asarray, v)


def test_full_width_predict_matches_jax(init_weights):
    """On the init weights: the tiny tests' perturbation (biases + 0.1
    N(0, 1), norm scales up to x1.5) overflows stage 3's 27 blocks to
    NaN in eval, in both frameworks; the step below holds the perturbed
    weights in training, where BN reads the batch's statistics."""
    model = jax_flagship()
    port = build_flagship(device="cpu")
    load_jax_variables(port, init_weights)
    weights = init_weights
    tiles = np.random.RandomState(31).randint(0, 256, (1, 512, 512, 3))
    images = normalize(torch.from_numpy(tiles.astype(np.uint8)))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in port.predict(images).items()}
    ref = jax.jit(lambda v, i: model.apply(v, i, method=model.predict))(
        weights, jnp.asarray(images.numpy()))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert ref["valid"].sum() > 500
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["scores"].std() > 1e-3
    # slot by slot where the two agree; a proposal whose score ties
    # another's within f32 rounding may take the other's slot, so every
    # slot must find its detection (polygon and scores) among the other
    # side's, and all but 1% in its own slot
    v = ref["valid"][0]
    gp, gs = got["polys"][0][v], got["scores"][0][v]
    rp, rs = ref["polys"][0][v], ref["scores"][0][v]
    near = ((np.abs(gp[:, None] - rp[None]).max(-1) <= 1e-2)
            & (np.abs(gs[:, None] - rs[None]).max(-1) <= 1e-5))
    assert near.any(1).all() and near.any(0).all()
    assert np.diag(near).mean() >= 0.99, np.diag(near).mean()


def test_full_width_train_step_matches_jax(init_weights):
    weights = perturb(init_weights, seed=9)
    images, targets = _batch()
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    model = jax_flagship(
        rpn_sampler=dict(num=RPN_TAKE_ALL, pos_fraction=1.0),
        head_sampler=dict(num=HEAD_TAKE_ALL, pos_fraction=1.0,
                          add_gt_as_proposals=True))
    sched = JStepLR(**SCHED)
    tx = JAdamW(lr=lambda step: sched(1e-4, step, 0), weight_decay=0.05,
                grad_clip=dict(max_norm=35))
    state = create_train_state(
        model, jax.tree_util.tree_map(jnp.asarray, weights), tx)
    new_state, metrics = make_train_step(model, tx, donate=False)(
        state, jnp.asarray(images), jt, jax.random.PRNGKey(2))
    ref_grads = jax_to_state_dict({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _adam_mu(new_state.opt_state))})
    ref_params = jax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, new_state.params)})
    ref_stats = jax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, new_state.batch_stats["batch_stats"])})

    port = build_flagship(device="cpu", train=True)
    load_jax_variables(port, weights)
    port.rpn.sampler = RandomSampler(num=RPN_TAKE_ALL, pos_fraction=1.0)
    port.bbox_head.sampler = RandomSampler(
        num=HEAD_TAKE_ALL, pos_fraction=1.0, add_gt_as_proposals=True)
    opt = AdamW(port.parameters(), lr=1e-4, weight_decay=0.05,
                grad_clip=dict(max_norm=35))
    losses = train_step(port, opt, StepLR(**SCHED), torch.from_numpy(images),
                        {k: torch.from_numpy(v) for k, v in targets.items()},
                        torch.Generator().manual_seed(0), epoch=0)
    for k, v in metrics.items():
        assert abs(float(losses[k]) - float(v)) <= 2e-3 * max(
            abs(float(v)), 0.1), k
    assert float(metrics["orcnn_bbox_loss"]) > 0
    lr = opt.param_groups[0]["lr"]
    for k, p in port.named_parameters():
        g, gj = p.grad.numpy(), ref_grads[k]
        if not _before_bn(k):
            scale = max(np.abs(gj).max(), np.abs(g).max(), 1e-12)
            assert np.abs(g - gj).max() / scale < 5e-3, k
        diff = np.abs(p.detach().numpy() - ref_params[k])
        assert diff.max() <= 2 * lr + 1e-6, k
        sure = np.abs(gj) > 1e-3 * max(np.abs(gj).max(), 1e-12)
        if sure.any() and not _before_bn(k):
            assert diff[sure].max() <= 1e-6, k
    stats = {k: v.numpy() for k, v in port.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
