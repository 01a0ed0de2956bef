"""FCOS's pieces in the port against the JAX package, CPU, f32:
``convex_sort``, the polygon-IoU losses (values and gradients, on pairs
held away from every discrete decision by a stated margin),
``distance2obb``, ``mintheta_obb``, ``bbox2type``, the registered losses
the FCOS configs name, and the head's dense targets (labels bit for
bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.models.losses.poly_iou_loss import (
    poly_giou_loss as jpoly_giou_loss, poly_iou_loss as jpoly_iou_loss)
from rs_detection_tpu.models.roi_heads.fcos_head import \
    FCOSHead as JFCOSHead
from rs_detection_tpu.ops import box_ops as JB
from rs_detection_tpu.ops.convex_sort import convex_sort as jconvex_sort
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.models.losses import common
from rs_detection_tpu_torch.models.losses import poly_iou_loss as poly
from rs_detection_tpu_torch.models.roi_heads.fcos_head import FCOSHead
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.ops.convex_sort import convex_sort
from rs_detection_tpu_torch.utils import registry as reg
from test_torch_fcos_cuda import box_pairs, decision_margin, target_margin
from test_torch_fcos_networks import _one_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("circular", [True, False])
def test_convex_sort_indices_equal_jax(circular):
    """64 sets of 24 points (no two at one angle about their centroid),
    each with a random mask, one set empty and one full: the same
    indices as JAX, the ring-closing index right after the last valid
    one."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-10, 10, (64, 24, 2)).astype(np.float32)
    masks = rng.rand(64, 24) < 0.6
    masks[0] = False
    masks[1] = True
    got = convex_sort(_t(pts), _t(masks), circular=circular).numpy()
    want = np.asarray(jconvex_sort(jnp.asarray(pts), jnp.asarray(masks),
                                   circular=circular))
    np.testing.assert_array_equal(got, want)
    if circular:
        k = masks.sum(1)
        assert (got[np.arange(64), k][k > 0] == got[k > 0, 0]).all()
        assert got[0, 0] == -1


@pytest.mark.parametrize("which", ["iou", "giou"])
def test_poly_iou_losses_values_and_gradients_match_jax(which):
    """The pairs of 256 whose decision margin is above 1e-3
    (``decision_margin``; about 200): the weighted mean within 1e-5
    relative of JAX, its gradient with respect to the predictions within
    1e-5 of ``jax.grad`` (relative to the largest entry), and eight
    pairs' losses one by one."""
    pred, target = box_pairs(256, seed=3)
    keep = (decision_margin(pred, target) > 1e-3).numpy()
    assert keep.sum() > 150
    pred, target = pred[keep], target[keep]
    n = len(pred)
    w = np.random.RandomState(4).rand(n).astype(np.float32)
    fn, jfn = ((poly.poly_iou_loss, jpoly_iou_loss) if which == "iou"
               else (poly.poly_giou_loss, jpoly_giou_loss))

    def jloss(p):
        return jfn(p, jnp.asarray(target), weight=jnp.asarray(w),
                   avg_factor=jnp.asarray(w).sum())

    per_pair = np.asarray(jax.jit(lambda p, t: jfn(p, t, reduction="none"))(
        jnp.asarray(pred), jnp.asarray(target)))
    p = _t(pred).requires_grad_(True)
    got = fn(p, _t(target), weight=_t(w), avg_factor=_t(w).sum())
    got.backward()
    ref, ref_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(pred))
    assert abs(got.item() - float(ref)) <= 1e-5 * abs(float(ref))
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(p.grad.numpy(), ref_g,
                               atol=1e-5 * np.abs(ref_g).max())
    # per pair: one weight a pair picks its loss out of the mean
    one = torch.eye(n)[:8]
    for i in range(8):
        v = fn(_t(pred), _t(target), weight=one[i], avg_factor=1.0)
        assert abs(v.item() - per_pair[i]) <= 1e-5 * max(1.0, per_pair[i])
    assert (per_pair > 0).all()


def test_poly_iou_loss_on_identical_and_disjoint_boxes():
    """An identical pair gives IoU 1 (loss ~0), a disjoint pair the
    ``eps`` clip (-log 1e-6), in both packages."""
    a = np.array([[50, 50, 20, 10, 0.3], [0, 0, 10, 10, 0.0]], np.float32)
    b = np.array([[50, 50, 20, 10, 0.3], [100, 100, 10, 10, 0.2]],
                 np.float32)
    for k in range(2):
        w = np.zeros(2, np.float32)
        w[k] = 1
        got = poly.poly_iou_loss(_t(a), _t(b), weight=_t(w), avg_factor=1.0)
        want = jax.jit(jpoly_iou_loss)(jnp.asarray(a), jnp.asarray(b),
                                       weight=jnp.asarray(w), avg_factor=1.0)
        assert abs(got.item() - float(want)) <= 1e-4
    assert abs(got.item() + np.log(1e-6)) < 1e-3


def test_registered_poly_losses_match_jax():
    """``PolyIoULoss`` (linear and log) and ``PolyGIoULoss`` from their
    config sections, a [N, 5] weight averaged over its last axis; a
    reduction other than the mean raises in the port."""
    pred, target = box_pairs(64, seed=5)
    w = np.random.RandomState(6).rand(64, 5).astype(np.float32)
    for cfg in (dict(type="PolyIoULoss"), dict(type="PolyIoULoss",
                                               linear=True, loss_weight=2.0),
                dict(type="PolyGIoULoss", loss_weight=0.5)):
        got = reg.build_from_cfg(dict(cfg), reg.LOSSES)(
            _t(pred), _t(target), _t(w), avg_factor=10.0)
        want = jax.jit(jreg.build_from_cfg(dict(cfg), jreg.LOSSES))(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w),
            avg_factor=10.0)
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


def test_registered_common_losses_match_jax():
    """``CrossEntropyLoss`` (softmax with an ignored label, and
    ``use_bce`` as the FCOS configs' centerness loss), its RCNN alias,
    ``BinaryCrossEntropyLoss`` and ``L1Loss``, with weights and an
    ``avg_factor``, within 1e-6 relative of JAX."""
    rng = np.random.RandomState(7)
    logits = rng.randn(40, 5).astype(np.float32) * 3
    labels = rng.randint(-1, 5, 40)
    probs = rng.rand(40).astype(np.float32)
    w = rng.rand(40).astype(np.float32)
    cases = [
        (dict(type="CrossEntropyLoss"), logits, labels),
        (dict(type="CrossEntropyLossForRcnn", loss_weight=2.0), logits,
         labels),
        (dict(type="CrossEntropyLoss", use_bce=True), logits[:, 0], probs),
        (dict(type="BinaryCrossEntropyLoss"), logits[:, 0], probs),
        (dict(type="L1Loss", loss_weight=0.5), logits[:, 0], probs),
    ]
    for cfg, pred, target in cases:
        got = reg.build_from_cfg(dict(cfg), reg.LOSSES)(
            _t(pred), _t(target), _t(w), avg_factor=7.0)
        want = jreg.build_from_cfg(dict(cfg), jreg.LOSSES)(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w),
            avg_factor=7.0)
        assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want)), cfg
    assert abs(common.l1_loss(_t(probs), _t(probs) + 1).item() - 1) < 1e-6


def test_distance2obb_mintheta_and_bbox2type_match_jax():
    """``distance2obb`` on 4096 points and distances, ``mintheta_obb``
    and every ``bbox2type`` conversion on 4096 boxes away from the angle
    wraps, within 1e-4 px and rad of JAX."""
    rng = np.random.RandomState(8)
    n = 4096
    pts = rng.uniform(0, 512, (n, 2)).astype(np.float32)
    dist = np.concatenate([rng.uniform(1, 80, (n, 4)),
                           rng.uniform(-1.5, 1.5, (n, 1))], 1).astype(
        np.float32)
    np.testing.assert_allclose(
        B.distance2obb(_t(pts), _t(dist)).numpy(),
        np.asarray(JB.distance2obb(jnp.asarray(pts), jnp.asarray(dist))),
        atol=1e-4)
    obb = np.concatenate([rng.uniform(0, 512, (n, 2)),
                          rng.uniform(4, 90, (n, 2)),
                          rng.uniform(-3.0, 3.0, (n, 1))], 1).astype(
        np.float32)
    np.testing.assert_allclose(B.mintheta_obb(_t(obb)).numpy(),
                               np.asarray(JB.mintheta_obb(jnp.asarray(obb))),
                               atol=1e-4)
    hbb = B.obb2hbb(_t(obb)).numpy()
    poly_ = B.obb2poly(_t(obb)).numpy()
    for src in (obb, hbb, poly_):
        for to in ("hbb", "obb", "poly"):
            np.testing.assert_allclose(
                B.bbox2type(_t(src), to).numpy(),
                np.asarray(JB.bbox2type(jnp.asarray(src), to)), atol=1e-4,
                err_msg=f"{src.shape[-1]} -> {to}")


def test_fcos_targets_labels_bit_equal_to_jax():
    """The dense targets of two 256^2 images (1,364 points on strides
    8-128) against 24 boxes each (the last 4 slots of the second padded),
    1-based labels of 15 classes: the labels bit for bit, the distances
    and angles within 1e-4 of JAX's, on boxes whose comparisons all stand
    at least 1e-3 px from their thresholds (``target_margin``; f32 puts
    these points' distances ~3e-5 px apart across the packages). The
    seed is one with such a margin: a point on a box's edge may fall on
    either side in either package."""
    head = FCOSHead(num_classes=15)
    sizes = [(256 // s, 256 // s) for s in head.strides]
    points, strides, ranges = head.level_tensors(sizes, "cpu")
    rng = np.random.RandomState(18)
    gt = np.stack([rng.uniform(0, 256, (2, 24)), rng.uniform(0, 256, (2, 24)),
                   rng.uniform(6, 200, (2, 24)), rng.uniform(6, 200, (2, 24)),
                   rng.uniform(-np.pi / 2, np.pi / 2, (2, 24))], -1).astype(
        np.float32)
    mask = np.ones((2, 24), bool)
    mask[1, 20:] = False
    labels = rng.randint(1, 16, (2, 24)).astype(np.int32)
    assert target_margin(head, points, strides, _t(gt), _t(mask)) > 1e-3
    got_l, got_t = head.targets(points, strides, ranges, _t(gt), _t(mask),
                                _t(labels))
    jh = JFCOSHead(num_classes=15)
    want_l, want_t = jax.vmap(lambda o, m, lab: jh._target_single(
        jnp.asarray(points.numpy()), jnp.asarray(strides.numpy()), o, m, lab,
        jnp.asarray(ranges.numpy())))(jnp.asarray(gt), jnp.asarray(mask),
                                      jnp.asarray(labels))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-4)
    assert 40 < (got_l.numpy() < 15).sum() < got_l.numel()
