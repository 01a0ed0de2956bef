"""The training pieces of the PyTorch port against their JAX twins, on
the CPU in f32 with inputs from seeded numpy: rotated and hbb IoU, the
two encoders, anchor valid flags, max-IoU assignment, sampling, anchor
targets, the losses, the learning-rate schedule, the depthwise-conv
backward (whose weight gradient is K6 on CUDA) and the RoIAlign backward
(K3 on CUDA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.models.boxes import anchor_generator as jag
from rs_detection_tpu.models.boxes import coder as jcoder
from rs_detection_tpu.models.boxes.anchor_target import \
    anchor_target_single as janchor_target
from rs_detection_tpu.models.boxes.assigner import (MaxIoUAssigner as JAssigner,
                                                    assign_wrt_overlaps as
                                                    jassign)
from rs_detection_tpu.models.boxes.sampler import RandomSampler as JSampler
from rs_detection_tpu.models.losses import common as jloss
from rs_detection_tpu.ops.dw_conv import dw_conv as jdw_conv
from rs_detection_tpu.ops.nms import bbox_overlaps_hbb as jhbb_iou
from rs_detection_tpu.ops.pallas_dw_wgrad import dw_wgrad_pallas
from rs_detection_tpu.ops.pallas_roi_align import (_fwd_order,
                                                   _pyramid_pallas_bwd_impl)
from rs_detection_tpu.ops.roi_align import roi_align_rotated_pyramid as jroi
from rs_detection_tpu.ops.rotated_iou import box_iou_rotated as jiou
from rs_detection_tpu.optims.lr_scheduler import StepLR as JStepLR
from rs_detection_tpu_torch.models.boxes import anchor_generator as tag
from rs_detection_tpu_torch.models.boxes import coder as tcoder
from rs_detection_tpu_torch.models.boxes.anchor_target import \
    anchor_target_single
from rs_detection_tpu_torch.models.boxes.assigner import (MaxIoUAssigner,
                                                          assign_wrt_overlaps)
from rs_detection_tpu_torch.models.boxes.sampler import (RandomSampler,
                                                         random_choice_mask)
from rs_detection_tpu_torch.models.losses import common as tloss
from rs_detection_tpu_torch.ops.dw_conv import (dw_conv, dw_wgrad,
                                                dw_wgrad_cuda,
                                                dw_wgrad_reference)
from rs_detection_tpu_torch.ops.nms import bbox_overlaps_hbb
from rs_detection_tpu_torch.ops.roi_align import (
    roi_align_rotated_pyramid, roi_align_rotated_pyramid_bwd_cuda,
    roi_align_rotated_pyramid_bwd_reference)
from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated
from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
from torch_one_thread import _one_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)
t = torch.from_numpy


def _obbs(rng, n, img=200.0):
    return np.stack([rng.uniform(0, img, n), rng.uniform(0, img, n),
                     rng.uniform(2, 120, n), rng.uniform(2, 120, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


# ---------------------------------------------------------------- IoU

def _iou_cases():
    """Pairs (boxes1 row i against boxes2 row i is the case; the test
    takes the whole matrix)."""
    a = np.array([
        [50, 50, 40, 20, 0.3],        # identical to b[0]
        [50, 50, 40, 20, 0.0],        # b[1] nested inside
        [0, 0, 10, 10, 0.0],          # disjoint from b[2]
        [30, 30, 0, 15, 0.5],         # degenerate: zero width
        [60, 60, 80, 8, 0.25],        # near-parallel thin box
        [60, 60, 80, 8, 1.0e-4],      # axis-aligned vs near-axis-aligned
    ], np.float32)
    b = np.array([
        [50, 50, 40, 20, 0.3],
        [52, 49, 10, 6, 0.4],
        [100, 100, 10, 10, 0.7],
        [30, 30, 10, 15, 0.5],
        [61, 60.5, 78, 7, 0.25 + 1e-4],
        [60, 60, 80, 8, 0.0],
    ], np.float32)
    return a, b


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_box_iou_rotated_cases_match_jax(mode):
    """Identical, nested, disjoint, degenerate and near-parallel pairs:
    exact geometry in f32 on both sides, same candidate points and
    tolerances; 1e-5 absolute on IoU in [0, 1]."""
    a, b = _iou_cases()
    got = box_iou_rotated(t(a), t(b), mode=mode).numpy()
    ref = np.asarray(jiou(jnp.asarray(a), jnp.asarray(b), mode=mode))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    diag = np.diag(got)
    assert abs(diag[0] - 1.0) < 1e-5                 # identical
    assert abs(diag[1] - 60.0 / 800.0) < 1e-5        # nested: area ratio
    assert diag[2] == 0.0 and diag[3] == 0.0         # disjoint, degenerate


def test_box_iou_rotated_random_batched_matches_jax():
    """A batch of [N, M] matrices (the head assigns per image)."""
    rng = np.random.RandomState(1)
    a = _obbs(rng, 2 * 37).reshape(2, 37, 5)
    b = _obbs(rng, 2 * 9).reshape(2, 9, 5)
    got = box_iou_rotated(t(a), t(b)).numpy()
    for i in range(2):
        ref = np.asarray(jiou(jnp.asarray(a[i]), jnp.asarray(b[i])))
        np.testing.assert_allclose(got[i], ref, atol=1e-5)
    assert (got > 0.05).sum() > 10


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps_hbb_matches_jax(mode):
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 100, (50, 2))
    a = np.concatenate([xy, xy + rng.uniform(0, 40, (50, 2))], 1)
    b = np.concatenate([xy[:7] + 3, xy[:7] + rng.uniform(0, 40, (7, 2))], 1)
    a[3, 2:] = a[3, :2]                                 # zero area
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = bbox_overlaps_hbb(t(a), t(b), mode=mode).numpy()
    ref = np.asarray(jhbb_iou(jnp.asarray(a), jnp.asarray(b), mode=mode))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- coders

def test_midpoint_offset_encode_matches_jax():
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 200, (300, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 90, (300, 2))],
                             1).astype(np.float32)
    gts = _obbs(rng, 300)
    gts[:20, 4] = 0.0                                   # axis-aligned ties
    gts[20:40, 4] = np.pi / 2
    stds = (1.0, 1.0, 1.0, 1.0, 0.5, 0.5)
    got = tcoder.MidpointOffsetCoder(target_stds=stds).encode(t(anchors),
                                                              t(gts))
    ref = jcoder.MidpointOffsetCoder(target_stds=stds).encode(
        jnp.asarray(anchors), jnp.asarray(gts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_oriented_delta_encode_matches_jax():
    rng = np.random.RandomState(4)
    rois, gts = _obbs(rng, 300), _obbs(rng, 300)
    stds = (0.1, 0.1, 0.2, 0.2, 0.1)
    got = tcoder.OrientedDeltaXYWHTCoder(target_stds=stds).encode(t(rois),
                                                                  t(gts))
    ref = jcoder.OrientedDeltaXYWHTCoder(target_stds=stds).encode(
        jnp.asarray(rois), jnp.asarray(gts))
    # theta offsets wrap at +-pi/2: compare in f32 with a few ulps of pi
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("sizes,pad", [
    ([(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)], (64, 64)),
    ([(25, 19), (13, 10), (7, 5), (4, 3), (2, 2)], (90, 70))])
def test_valid_flags_match_jax(sizes, pad):
    cfg = dict(scales=[8], ratios=[0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0],
               strides=[4, 8, 16, 32, 64])
    ref = jag.AnchorGenerator(**cfg).valid_flags(sizes, pad)
    got = tag.AnchorGenerator(**cfg).valid_flags(sizes, pad)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- assign

@pytest.mark.parametrize("kw", [
    dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
         match_low_quality=True),
    dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
         match_low_quality=False),
    dict(pos_iou_thr=0.6, neg_iou_thr=(0.1, 0.4), min_pos_iou=0.2,
         match_low_quality=True, gt_max_assign_all=False)])
def test_assign_wrt_overlaps_matches_jax(kw):
    """The same f32 overlaps matrix on both sides (so ties cannot
    differ), values on a coarse grid so rescue ties occur, padded ground
    truths and excluded anchors."""
    rng = np.random.RandomState(5)
    ov = (rng.randint(0, 11, (300, 6)) / 10.0).astype(np.float32)
    gt_mask = np.array([1, 1, 0, 1, 1, 1], bool)
    anchor_mask = rng.rand(300) > 0.1
    got, got_max = assign_wrt_overlaps(t(ov), t(gt_mask), anchor_mask=t(
        anchor_mask), **kw)
    ref, ref_max = jassign(jnp.asarray(ov), jnp.asarray(gt_mask),
                           anchor_mask=jnp.asarray(anchor_mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(ref_max))
    assert {-1, 0}.issubset(set(got.tolist())) and got.max() > 0


def test_max_iou_assigner_rotated_matches_jax():
    """The head's assigner end to end (rotated IoU, no low-quality
    matching); the overlaps come from each framework's own IoU."""
    rng = np.random.RandomState(6)
    gts = _obbs(rng, 5)
    cand = np.concatenate([gts + rng.normal(0, 2, gts.shape).astype(
        np.float32) * [1, 1, 1, 1, 0.02], _obbs(rng, 60), gts], 0)
    cfg = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
               match_low_quality=False,
               iou_calculator=dict(type="BboxOverlaps2D_rotated_v1"))
    gt_mask = np.array([1, 1, 1, 1, 0], bool)
    got, _ = MaxIoUAssigner(**cfg).assign(t(cand), t(gts), t(gt_mask))
    ref, _ = JAssigner(**cfg).assign(jnp.asarray(cand), jnp.asarray(gts),
                                     jnp.asarray(gt_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got > 0).sum() >= 4


# ---------------------------------------------------------------- sample

def test_sampler_counts():
    """At most num * pos_fraction positives, negatives fill to num, only
    from their candidates; per image of a batch."""
    rng = np.random.RandomState(7)
    assigned = t(rng.choice([-1, 0, 0, 0, 1, 2], (3, 1000)))
    g = torch.Generator().manual_seed(0)
    pos, neg = RandomSampler(num=256, pos_fraction=0.25).sample(assigned, g)
    n_pos_cand = (assigned > 0).sum(1)
    assert torch.equal(pos.sum(1), n_pos_cand.clamp(max=64))
    assert torch.equal(neg.sum(1), 256 - pos.sum(1))
    assert not (pos & (assigned <= 0)).any()
    assert not (neg & (assigned != 0)).any()
    few = assigned.clone()
    few[0, 20:] = -1
    pos, neg = RandomSampler(num=256, pos_fraction=0.25).sample(few, g)
    assert pos[0].sum() == (few[0] > 0).sum()
    assert neg[0].sum() == (few[0] == 0).sum()      # fewer than asked: all
    m = random_choice_mask(assigned == 0, 10, g)
    assert torch.equal(m.sum(1), torch.full((3,), 10))


def test_sampler_take_all_matches_jax():
    """num >= candidates and pos_fraction 1 take everything in both
    frameworks, whatever the random numbers."""
    rng = np.random.RandomState(8)
    assigned = rng.choice([-1, 0, 0, 1, 3], 500).astype(np.int32)
    got = RandomSampler(num=512, pos_fraction=1.0).sample(
        t(assigned)[None].long(), torch.Generator().manual_seed(1))
    ref = JSampler(num=512, pos_fraction=1.0).sample(
        jnp.asarray(assigned), jax.random.PRNGKey(1))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    assert got[0].sum() == (assigned > 0).sum()


def test_anchor_target_take_all_matches_jax():
    """The RPN's use: hbb assignment on the gt hbbs, midpoint-offset
    targets of the gt obbs, two images, a padded gt and border-excluded
    anchors."""
    cfg = dict(scales=[8], ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16])
    sizes = [(16, 16), (8, 8), (4, 4)]
    anchors = np.concatenate(jag.AnchorGenerator(**cfg).grid_anchors(sizes))
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < 64) & (anchors[:, 3] < 64))
    gt_obb = np.array([[[26, 26, 32, 30, -0.05], [42, 34, 40, 22, 0.08],
                        [10, 50, 12, 30, 0.6]],
                       [[30, 30, 28, 20, -0.3], [14, 18, 16, 16, 0.0],
                        [0, 0, 0, 0, 0]]], np.float32)
    gt_mask = np.array([[1, 1, 1], [1, 1, 0]], bool)
    from rs_detection_tpu.ops import box_ops as jbox
    gt_hbb = np.array(jbox.obb2hbb(jnp.asarray(gt_obb)))
    asn = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
               match_low_quality=True)
    stds = (1.0, 1.0, 1.0, 1.0, 0.5, 0.5)
    got = anchor_target_single(
        t(anchors), t(inside), t(gt_hbb), t(gt_mask), None,
        MaxIoUAssigner(**asn), RandomSampler(num=4096, pos_fraction=1.0),
        tcoder.MidpointOffsetCoder(target_stds=stds).encode,
        torch.Generator().manual_seed(0), gt_bboxes_encode=t(gt_obb))
    jcod = jcoder.MidpointOffsetCoder(target_stds=stds)
    for i in range(2):
        ref = janchor_target(
            jnp.asarray(anchors), jnp.asarray(inside),
            jnp.asarray(gt_hbb[i]), jnp.asarray(gt_mask[i]), None,
            JAssigner(**asn), JSampler(num=4096, pos_fraction=1.0),
            jcod.encode, key=jax.random.PRNGKey(0),
            gt_bboxes_encode=jnp.asarray(gt_obb[i]))
        for name in ("labels", "label_weights", "bbox_weights",
                     "assigned_gt_inds"):
            np.testing.assert_array_equal(
                getattr(got, name)[i].numpy(), np.asarray(getattr(ref, name)),
                err_msg=name)
        np.testing.assert_allclose(got.bbox_targets[i].numpy(),
                                   np.asarray(ref.bbox_targets), atol=1e-5)
        assert int(got.num_pos[i]) == int(ref.num_pos) > 0
        assert int(got.num_neg[i]) == int(ref.num_neg) > 0


# ---------------------------------------------------------------- losses

def test_losses_match_jax():
    rng = np.random.RandomState(9)
    f = np.float32
    logits = (3 * rng.randn(400)).astype(f)
    labels = (rng.rand(400) > 0.7).astype(f)
    w = (rng.rand(400) > 0.3).astype(f)
    np.testing.assert_allclose(
        tloss.binary_cross_entropy(t(logits), t(labels), t(w),
                                   avg_factor=torch.tensor(123.0)).item(),
        float(jloss.binary_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), jnp.asarray(w),
                                         avg_factor=123.0)), rtol=1e-6)
    pred, tgt = rng.randn(300, 5).astype(f), rng.randn(300, 5).astype(f)
    bw = (rng.rand(300, 5) > 0.5).astype(f)
    for beta in (1.0 / 9.0, 1.0):
        np.testing.assert_allclose(
            tloss.smooth_l1_loss(t(pred), t(tgt), t(bw), beta=beta,
                                 avg_factor=300.0).item(),
            float(jloss.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                       jnp.asarray(bw), beta=beta,
                                       avg_factor=300.0)), rtol=1e-6)
    scores = rng.randn(200, 11).astype(f)
    lbl = rng.randint(0, 11, 200).astype(np.int64)
    lw = (rng.rand(200) > 0.2).astype(f)
    np.testing.assert_allclose(
        tloss.softmax_cross_entropy(t(scores), t(lbl), t(lw),
                                    avg_factor=0.5).item(),
        float(jloss.softmax_cross_entropy(jnp.asarray(scores),
                                          jnp.asarray(lbl.astype(np.int32)),
                                          jnp.asarray(lw), avg_factor=0.5)),
        rtol=1e-6)


def test_step_lr_matches_jax_over_600_iterations():
    """Linear warmup over 500 iterations at ratio 1/3, milestones 7 and
    10 (epochs): 600 iterations at epochs 0, 7 and 10."""
    cfg = dict(milestones=[7, 10], warmup="linear", warmup_iters=500,
               warmup_ratio=1.0 / 3)
    got_s, ref_s = StepLR(**cfg), JStepLR(**cfg)
    for epoch in (0, 7, 10):
        got = np.array([got_s(1e-4, i, epoch) for i in range(600)])
        ref = np.asarray(jax.vmap(lambda i: ref_s(1e-4, i, epoch))(
            jnp.arange(600)))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert abs(got_s(1e-4, 0, 0) - 1e-4 / 3) < 1e-12
    assert got_s(1e-4, 500, 0) == 1e-4


@pytest.mark.parametrize("build,jbuild,read", [
    (lambda: StepLR([7], warmup="exp", warmup_iters=500),
     lambda: JStepLR([7], warmup="exp", warmup_iters=500),
     lambda s: [float(s(1e-4, i, 0)) for i in (0, 250, 499, 500)]),
    (lambda: RandomSampler(num=256, pos_fraction=0.5, neg_pos_ub=3),
     lambda: JSampler(num=256, pos_fraction=0.5, neg_pos_ub=3),
     lambda s: s.neg_pos_ub),
    (lambda: MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4,
                            ignore_iof_thr=0.5),
     lambda: JAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, ignore_iof_thr=0.5),
     lambda s: s.ignore_iof_thr)],
    ids=["exp_warmup", "neg_pos_ub", "ignore_iof_thr"])
def test_unported_options_raise(build, jbuild, read):
    """Options no config of the repository sets, refused until they were
    ported: they now build and keep JAX's values (their behaviour against
    JAX: ``tests/test_torch_optims.py``,
    ``tests/test_torch_optims_train_options.py``)."""
    np.testing.assert_allclose(read(build()), read(jbuild()), rtol=1e-6)


# ---------------------------------------------------------------- K6

DW_CASES = [(3, 1), (5, 1), (7, 3)]


def _dw_inputs(seed, k, n=2, c=6, h=11, w=9):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(k, k, 1, c) / k).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    return x, wt, g


@pytest.mark.parametrize("k,d", DW_CASES)
@pytest.mark.parametrize("pallas", ["1", "0"])
def test_dw_conv_backward_matches_jax_vjp(monkeypatch, k, d, pallas):
    """dx and dw of the port's ``dw_conv`` against the JAX custom vjp,
    whose weight gradient is the Pallas K6 (interpret mode on the CPU)
    or the tap loop (RS_DW_WGRAD_PALLAS=0). NHWC numpy, NCHW torch."""
    monkeypatch.setenv("RS_DW_WGRAD_PALLAS", pallas)
    x, wt, g = _dw_inputs(10 + k, k)
    out, vjp = jax.vjp(lambda a, b: jdw_conv(a, b, d), jnp.asarray(x),
                       jnp.asarray(wt))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = t(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    wtt = t(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()
    y = dw_conv(xt, wtt, None, d)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(out), atol=1e-5)
    y.backward(t(g.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(wtt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(jdw), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("k,d", DW_CASES)
def test_dw_wgrad_plain_matches_pallas_interpret(k, d):
    """The plain tap loop (K6's plain version) against
    ``dw_wgrad_pallas`` as it runs on the CPU, both layouts."""
    x, _, g = _dw_inputs(20 + k, k, c=5)
    ref = np.asarray(dw_wgrad_pallas(jnp.asarray(x), jnp.asarray(g), k, d)
                     ).reshape(k * k, -1)
    xt, gt = t(x.transpose(0, 3, 1, 2).copy()), t(g.transpose(0, 3, 1, 2)
                                                    .copy())
    for fmt in (torch.contiguous_format, torch.channels_last):
        got = dw_wgrad(xt.contiguous(memory_format=fmt), gt, k, d)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError):
        dw_wgrad_cuda(xt, gt, k, d)                # CPU tensors: no kernel
    with pytest.raises(ValueError):
        dw_wgrad(xt.to("meta"), gt.to("meta"), k, d)


def test_dw_conv_bias_gradient():
    rng = np.random.RandomState(30)
    x = t(rng.randn(2, 4, 7, 8).astype(np.float32))
    w = t(rng.randn(4, 1, 3, 3).astype(np.float32))
    b = t(rng.randn(4).astype(np.float32)).requires_grad_()
    g = t(rng.randn(2, 4, 7, 8).astype(np.float32))
    dw_conv(x, w, b).backward(g)
    np.testing.assert_allclose(b.grad.numpy(), g.sum((0, 2, 3)).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        dw_wgrad_reference(x, g, 3).numpy(),
        torch.nn.grad.conv2d_weight(x, (4, 1, 3, 3), g, padding=1,
                                    groups=4).reshape(4, 9).t().numpy(),
        atol=1e-4)


# ---------------------------------------------------------------- K3

def _pyramid(rng, n=2, c=16, base=64):
    return [rng.randn(n, base // (s // 4), base // (s // 4), c)
            .astype(np.float32) for s in STRIDES]


def _rois(rng, r, n, img=256.0):
    scale = np.exp(rng.uniform(np.log(10), np.log(600), r))
    aspect = np.exp(rng.uniform(-1.5, 1.5, r))
    return np.stack([rng.randint(0, n, r), rng.uniform(-0.25, 1.25, r) * img,
                     rng.uniform(-0.25, 1.25, r) * img, scale * aspect,
                     scale / aspect, rng.uniform(-np.pi, np.pi, r)],
                    1).astype(np.float32)


def test_roi_align_plain_backward_matches_jax_vjp():
    """Autograd of the plain forward (the CPU training path and K3's
    plain version) against ``jax.vjp`` of the exact XLA gather path."""
    rng = np.random.RandomState(31)
    feats, rois = _pyramid(rng), _rois(rng, 300, 2)
    g = rng.randn(300, 7, 7, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jroi(f, jnp.asarray(rois), 7,
                                    strides=STRIDES),
                     [jnp.asarray(f) for f in feats])
    (ref,) = vjp(jnp.asarray(g))
    leaves = [t(f).requires_grad_() for f in feats]
    # on the CPU ``index_put_(accumulate=True)`` otherwise adds with atomics
    # from several threads, in an order that changes with the machine's
    # load: the two backward passes below then differ by a few ulps
    torch.use_deterministic_algorithms(True)
    try:
        roi_align_rotated_pyramid(leaves, t(rois)).backward(t(g))
        plain = roi_align_rotated_pyramid_bwd_reference(
            [t(f) for f in feats], t(rois), t(g))
    finally:
        torch.use_deterministic_algorithms(False)
    for lf, p, r in zip(leaves, plain, ref):
        np.testing.assert_allclose(lf.grad.numpy(), np.asarray(r), atol=1e-4)
        np.testing.assert_allclose(p.numpy(), lf.grad.numpy(), atol=1e-6)
        assert np.abs(np.asarray(r)).max() > 0
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid_bwd_cuda([t(f) for f in feats], t(rois),
                                           t(g))


def test_roi_align_plain_backward_matches_pallas_interpret():
    """Against the TPU backward (``_scatter_kernel`` in interpret mode
    plus its XLA fallback tail) with every oversize roi inside the
    tail's capacity, where the TPU path is exact too."""
    rng = np.random.RandomState(32)
    feats, rois = _pyramid(rng, c=32), _rois(rng, 48, 2)
    g = rng.randn(48, 7, 7, 32).astype(np.float32)
    _, _, tier, _, _, _ = _fwd_order(jnp.asarray(rois), STRIDES, 56.0, 4)
    n_over = int((np.asarray(tier) >= 1).sum())
    assert 0 < n_over <= 48                        # fallback_frac 1: cap 48
    ref, _ = _pyramid_pallas_bwd_impl(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(g),
        7, STRIDES, 2, 56.0, 1.0, 4, True)
    got = roi_align_rotated_pyramid_bwd_reference(
        [t(f) for f in feats], t(rois), t(g))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
